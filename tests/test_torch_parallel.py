"""Data parallelism of the port (``rtpose_tpu_torch.parallel``) in one
process, on the CPU:

* the global-share loss: one global batch split into two "ranks" by
  slicing, each rank's loss normalized by the global batch's positive
  counts (``make_loss_fn``'s ``count_reduce``); the sum of the two shares'
  losses, and of their gradients, equals rtpose_tpu's single-device train
  step on the whole batch (``graft._flagship(tiny=True,
  dtype_override="float32")`` at its (4, 8, 16) grid, weights through
  ``state_dict_from_jax``): the sparse step at one person a frame and the
  dense step at two, on batches whose halves hold different person counts
  (a frame with no person, two-person frames).  Tolerances as in
  ``tests/test_torch_train_step.py``: losses rtol 1e-4, each gradient leaf
  to 1e-3 of its largest value.  The control: the mean of the halves'
  losses, each normalized by its own counts (what a DDP average computes),
  misses JAX's loss by more than that tolerance on the same batches;
* ``process_count`` / ``process_index`` / ``all_gather_objects`` with no
  process group;
* the sharded cache's exchange (``RowShard``), simulated over N slices (the
  all-reduce is the sum of the slices' packed buffers): every rank's rows
  equal the replicated cache's rows bit for bit, 11 rows 4 ways, float32,
  bfloat16 and float8_e4m3fn caches, over the steps of ``DeviceCachedLoader``'s
  ``fused_epoch`` (every rank's batches back to back); and at one shard the
  batches of ``__iter__`` equal the replicated cache's, as in
  ``tests/test_parallel.py::test_loader_sharded_cache_iter_matches``.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from rtpose_tpu.engine import create_train_state as jax_create_state
from rtpose_tpu.engine import make_train_step as jax_make_train_step

from rtpose_tpu_torch import parallel
from rtpose_tpu_torch.api import assemble
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.data import DeviceCachedLoader
from rtpose_tpu_torch.engine import make_loss_fn, state_dict_from_jax, targets_from_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as graft  # noqa: E402

FLAGSHIP = os.path.join(REPO, "configs", "cruw_pose", "hr3d_one_hm_doppler.py")
CPU = torch.device("cpu")
# per case: the step, max_poses, and the person count of each frame; the
# first two frames are rank 0's, the last two rank 1's
CASES = {"sparse_one_person": (True, 1, [1, 0, 1, 1]),
         "dense_two_person": (False, 2, [2, 0, 1, 2])}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Six test workers share the cores: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad_keeper():
    """An optax transformation whose state after an update is the gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _batch(spec, persons, seed=0):
    """Frames with ``persons[i]`` people each, every person inside the grid."""
    rng = np.random.default_rng(seed)
    z, y, x = spec.grid_zyx
    B, P = len(persons), spec.max_poses
    extent = np.array([x, y, z]) * np.array(spec.voxel_size_xyz)
    lo = np.array(spec.pc_range_min_xyz)
    poses = lo + rng.uniform(0.15, 0.85, size=(B, P, 15, 3)) * extent
    return {"rdr_tensor": rng.normal(size=(B, z, y, x, 32)).astype(np.float32),
            "poses": poses.astype(np.float32),
            "num_poses": np.asarray(persons, np.int32)}


@pytest.fixture(scope="module")
def jax_flagship():
    asm = graft._flagship(tiny=True, dtype_override="float32")
    params = asm.model.init(jax.random.PRNGKey(3), jnp.zeros((1, *asm.input_shape_zyxc)))
    return asm, jax.tree.map(np.array, params)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, jax_flagship):
    """JAX's loss terms and gradients on the whole batch, and the port's
    two halves: each half's losses with the global counts and with its own,
    and each half's gradients with the global counts."""
    sparse, max_poses, persons = CASES[request.param]
    jasm, params = jax_flagship
    jspec = dataclasses.replace(jasm.target_spec, max_poses=max_poses)
    batch = _batch(jspec, persons)
    state = jax_create_state(jasm.model, _grad_keeper(), jnp.zeros((1, *jasm.input_shape_zyxc)))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          opt_state=jax.tree.map(jnp.zeros_like, params))
    step = jax.jit(jax_make_train_step(jasm.model, jasm.head, jspec, _grad_keeper(),
                                       sparse_reg=sparse))
    new_state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    want = dict(metrics=jax.device_get(jm), grads=state_dict_from_jax(
        jax.device_get(new_state.opt_state)))

    cfg = Config.fromfile(FLAGSHIP)
    cfg.model["backbone"]["dtype"] = "float32"
    cfg.model["pose_head"]["dtype"] = "float32"
    asm = assemble(cfg)
    spec = dataclasses.replace(asm.target_spec, grid_zyx=jspec.grid_zyx, max_poses=max_poses)
    model = asm.model
    model.load_state_dict(state_dict_from_jax(params))
    loss_fn = make_loss_fn(model, asm.head, spec, sparse_reg=sparse)
    halves = [{k: torch.from_numpy(v[h * 2:(h + 1) * 2]) for k, v in batch.items()}
              for h in range(2)]
    counts = [torch.stack([m.float().sum() for m in targets_from_batch(b, spec)["mask"]])
              for b in halves]
    total = counts[0] + counts[1]
    step0 = torch.zeros((), dtype=torch.int64)
    shares, grads, local = [], {}, []
    for b in halves:
        model.zero_grad(set_to_none=True)
        loss, losses = loss_fn(b, step0, lambda c: total)
        loss.backward()
        shares.append({"loss": loss.item(), "hm_loss": sum(x.item() for x in losses["hm_loss"]),
                       "loc_loss": sum(x.item() for x in losses["loc_loss"])})
        for k, p in model.named_parameters():
            grads[k] = grads.get(k, 0) + p.grad.detach().clone()
        with torch.no_grad():
            local.append(loss_fn(b, step0)[0].item())
    return dict(name=request.param, want=want, shares=shares, grads=grads, local=local,
                counts=[c.tolist() for c in counts])


def test_halves_hold_different_person_counts(case):
    assert case["counts"][0] != case["counts"][1]
    assert min(c[0] for c in case["counts"]) >= 1   # each half has a positive


def test_global_share_losses_sum_to_jax_loss(case):
    jm = case["want"]["metrics"]
    for k in ("loss", "hm_loss", "loc_loss"):
        got = sum(s[k] for s in case["shares"])
        np.testing.assert_allclose(got, float(jm[k]), rtol=1e-4, err_msg=k)


def test_global_share_gradients_sum_to_jax_gradients(case):
    want = case["want"]["grads"]
    assert sorted(want) == sorted(case["grads"])
    for k, g in case["grads"].items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def test_control_local_mean_misses_jax_loss(case):
    """A DDP-style mean of locally normalized losses is another loss."""
    want = float(case["want"]["metrics"]["loss"])
    mean_local = sum(case["local"]) / 2
    assert abs(mean_local - want) > 1e-4 * abs(want), (mean_local, want)


def test_no_group_is_one_process():
    assert not parallel.is_distributed()
    assert parallel.process_count() == 1 and parallel.process_index() == 0
    assert parallel.all_gather_objects({"a": 1}) == [{"a": 1}]
    t = torch.arange(3.0)
    assert parallel.all_reduce_sum_(t) is t and t.tolist() == [0.0, 1.0, 2.0]


class MemoryDS:
    """11 in-memory items, the cube (2 KB: a cache dtype compresses it) spread
    beyond float8's range."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        r = np.random.default_rng(100 + i)
        return {"rdr_tensor": (r.normal(size=(8, 8, 8)) * 300).astype(np.float32),
                "poses": r.normal(size=(1, 15, 3)).astype(np.float32),
                "num_poses": np.int32(1), "meta": {"i": i}}


def _simulated_exchange(loaders, sel):
    """Every rank's batch rows from the sharded loaders, the all-reduce
    simulated as the sum of the ranks' packed buffers (one term per row is
    non-zero, so uint8 sums are exact)."""
    packs = [ld.shard.pack(ld.data, sel) for ld in loaders]
    total = packs[0].clone()
    for p in packs[1:]:
        total += p
    return [ld.shard.unpack(total, ld.data) for ld in loaders]


@pytest.mark.parametrize("cache_dtype", [None, "bfloat16", "float8_e4m3fn"])
def test_sharded_cache_exchange_is_bit_exact(cache_dtype):
    """Each rank's exchanged rows are the replicated cache's rows of its
    batch, byte for byte, for every step of two epochs."""
    world, bs = 4, 2
    kw = dict(batch_size=bs, device=CPU, shuffle=True, seed=3, cache_dtype=cache_dtype,
              num_shards=world)
    repl = [DeviceCachedLoader(MemoryDS(), shard_id=r, **kw) for r in range(world)]
    shard = [DeviceCachedLoader(MemoryDS(), shard_id=r, shard_cache=True, **kw)
             for r in range(world)]
    assert [(ld.shard.lo, ld.shard.hi) for ld in shard] == [(0, 3), (3, 6), (6, 9), (9, 11)]
    assert sum(ld.nbytes for ld in shard) == repl[0].nbytes
    if cache_dtype is not None:
        assert shard[0].data["rdr_tensor"].dtype == getattr(torch, cache_dtype)
    for epoch in (0, 1):
        for ld in repl + shard:
            ld.set_epoch(epoch)
        idx = shard[0].fused_epoch()[0].reshape(-1, world * bs)
        for ld in shard[1:]:
            np.testing.assert_array_equal(ld.fused_epoch()[0].reshape(-1, world * bs), idx)
        for r, ld in enumerate(repl):   # rank r's batches are its own shard's indices
            np.testing.assert_array_equal(idx[:, r * bs:(r + 1) * bs].reshape(-1),
                                          ld.fused_epoch()[0])
        assert idx.shape[0] == len(shard[0]) == len(repl[0])
        for sel in torch.from_numpy(idx):
            rows = _simulated_exchange(shard, sel)
            for r in range(world):
                mine = sel[r * bs:(r + 1) * bs]
                for k, v in repl[r].data.items():
                    want = v.view(torch.uint8).index_select(0, mine)
                    assert rows[r][k].dtype == v.dtype, k
                    assert torch.equal(rows[r][k].view(torch.uint8), want), k


def test_sharded_cache_without_group_is_the_replicated_cache():
    """One process, ``shard_cache`` at one shard: the exchange needs no
    collective and the batches are the replicated cache's."""
    kw = dict(batch_size=3, device=CPU, shuffle=True, seed=1, cache_dtype="bfloat16")
    plain = DeviceCachedLoader(MemoryDS(), **kw)
    sharded = DeviceCachedLoader(MemoryDS(), shard_cache=True, **kw)
    assert (sharded.shard.lo, sharded.shard.hi) == (0, 11)
    for a, b in zip(plain, sharded):
        assert "meta" not in b and int(a["valid"]) == int(b["valid"])
        for k in ("rdr_tensor", "poses", "num_poses"):
            assert torch.equal(a[k], b[k]), k
