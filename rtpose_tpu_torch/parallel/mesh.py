"""Data parallelism: one process per card, joined by ``torch.distributed``.

Counterpart of ``rtpose_tpu/parallel/mesh.py``.  The JAX package puts the
global batch on a 1-D device mesh and lets ``jax.jit`` insert the gradient
all-reduce; the port runs one process per card (``torchrun``), each on
``cuda:LOCAL_RANK``, and makes the collectives itself:

* parameters and optimizer state are the same on every rank: rank 0
  broadcasts them at start and after a resume (``broadcast_state``, the
  JAX package's ``replicate``);
* the global batch is split over the ranks by the loaders (``num_shards =
  process_count()``, ``shard_id = process_index()``), so there is no
  counterpart of ``shard_batch``: each rank's loader already yields its own
  slice;
* a train step is the gradient of the *global* loss: the losses divide by
  the positive counts of the global batch (one all-reduce of a few floats
  before the forward), each rank's loss is its additive share of the global
  one, and the flat gradient is summed over the ranks with the loss and
  metric shares in the same buffer (``engine.steps.make_train_step``).
  ``DistributedDataParallel`` is not used: its gradient is the mean of the
  ranks' locally normalized gradients, which is another loss;
* eval detections of every rank are gathered and merged by key
  (``all_gather_objects``);
* ``RowShard``: a device cache split by rows over the ranks
  (``--cache_shard``), each batch built exactly by one collective.

Without a process group every function here is the one-process case
(``process_count() == 1``, no collective).  With a group, the collectives
run at any world size, also at 1, so a one-card run goes through them.
``collective_counts()`` counts the collectives issued through this module
and the bytes they reduced, as ``ops.launch_counts()`` counts kernel
launches: the replays of a captured CUDA graph pass no Python and are not
in them.
"""

from __future__ import annotations

import gc
import os
from typing import Any, Dict, List

import torch
import torch.distributed as dist

# collectives issued through this module since the last reset, and the
# bytes the all-reduces summed
_COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0, "broadcast": 0,
           "all_gather_object": 0, "barrier": 0}

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def collective_counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def is_distributed() -> bool:
    """A process group exists (whatever its size)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def torchrun_env() -> Dict[str, Any]:
    """Rank, world size and local rank from the environment ``torchrun``
    gives each process; raises where one is missing (``--multihost`` never
    falls back to a one-process run)."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--multihost joins a torchrun job, but {', '.join(missing)} is not set: "
            "launch with python -m torch.distributed.run --nproc_per_node N -m "
            "rtpose_tpu_torch.tools.train ... --multihost")
    return dict(rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                local_rank=int(os.environ["LOCAL_RANK"]))


def init_distributed(device: torch.device) -> None:
    """Join the job from torchrun's environment (the JAX package's
    ``jax.distributed.initialize()``): NCCL for a CUDA device, which must be
    the current one, gloo for the CPU.  A process that already joined keeps
    its group."""
    env = torchrun_env()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if is_distributed():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                               f"device {device} needs {backend}")
        return
    dist.init_process_group(backend, init_method="env://", rank=env["rank"],
                            world_size=env["world_size"],
                            device_id=device if device.type == "cuda" else None)


def shutdown() -> None:
    """Leave the job (at the end of a CLI run).  Free a CUDA graph that
    captured NCCL collectives (a fused epoch's) first: with one alive, four
    NCCL ranks did not get through their teardown within minutes.  Graphs
    that only reference cycles hold are collected here."""
    if is_distributed():
        gc.collect()
        dist.destroy_process_group()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it.  The identity with no
    group."""
    if is_distributed():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        _COUNTS["all_reduce"] += 1
        _COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def barrier() -> None:
    if is_distributed():
        dist.barrier()
        _COUNTS["barrier"] += 1


def broadcast_state(model: torch.nn.Module, optimizer) -> None:
    """Rank 0's parameters, buffers and optimizer state (moments and step
    count) on every rank, in place."""
    if not is_distributed():
        return
    for t in [*model.state_dict().values(), optimizer.mu, optimizer.nu, optimizer.step_count]:
        dist.broadcast(t, src=0)
        _COUNTS["broadcast"] += 1


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` with no
    group)."""
    if not is_distributed():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    _COUNTS["all_gather_object"] += 1
    return out


class RowShard:
    """Rank ``rank`` of ``world`` holds rows ``[lo, hi)`` of an ``n_rows``
    cache: contiguous blocks of ``ceil(n_rows / world)`` rows, the last one
    shorter (the JAX package's ``P('data')`` cache, padded there with
    repeats of the last row, which no index reaches).

    ``exchange`` builds this rank's rows of a global batch exactly: each
    rank gathers, in a byte view, the rows it holds for the whole global
    batch and zero-fills the others (``pack``); one all-reduce (sum) over
    the ranks, exact because every row is held by one rank only and the
    other terms are zero; then each rank keeps its own slice (``unpack``).
    Bytes keep bfloat16 and float8 caches exact whatever the backend
    reduces.  It moves ``world x`` a rank's batch bytes a step, and it is
    device work only, so a CUDA graph can capture it."""

    def __init__(self, n_rows: int, rank: int, world: int):
        per = -(-n_rows // world)
        self.rank, self.world = rank, world
        self.lo = min(rank * per, n_rows)
        self.hi = min(self.lo + per, n_rows)
        if self.hi <= self.lo:
            raise ValueError(f"RowShard: {n_rows} rows leave rank {rank} of {world} none")

    def pack(self, data: Dict[str, torch.Tensor], sel: torch.Tensor) -> torch.Tensor:
        """(len(sel), row bytes) uint8: the rows of the global batch ``sel``
        (global row indices) that this rank holds, from its (hi - lo, K)
        ``data``, zeros where another rank holds the row."""
        owned = (sel >= self.lo) & (sel < self.hi)
        local = torch.where(owned, sel - self.lo, 0)
        buf = torch.cat([v.view(torch.uint8).index_select(0, local) for v in data.values()],
                        dim=1)
        return buf.masked_fill_(~owned[:, None], 0)

    def unpack(self, buf: torch.Tensor, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's slice of the summed ``buf`` as (rows, K) tensors in the
        dtypes of ``data``."""
        bs = buf.shape[0] // self.world
        mine = buf.narrow(0, self.rank * bs, bs)
        out, off = {}, 0
        for k, v in data.items():
            width = v.shape[1] * v.element_size()
            out[k] = mine[:, off:off + width].contiguous().view(v.dtype)
            off += width
        return out

    def exchange(self, data: Dict[str, torch.Tensor], sel: torch.Tensor) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch ``sel`` (``world`` ranks'
        batches back to back)."""
        return self.unpack(all_reduce_sum_(self.pack(data, sel)), data)
