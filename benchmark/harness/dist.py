"""The harness's own coordination of ranks (a four-card cell).

The program joins its NCCL group itself (``--multihost``'s path); the
harness adds one gloo group on the host for its own decisions: where the
window opens and closes (every rank must stop at the same step, or the
step's collectives would wait forever) and gathering what rank 0 reports.
With one rank everything here is local.
"""

from __future__ import annotations

from typing import Any, List


class Ranks:
    def __init__(self, world: int = 1, rank: int = 0):
        self.world, self.rank = world, rank
        self.group = None
        if world > 1:
            import torch.distributed as dist
            self.group = dist.new_group(backend="gloo")

    def any(self, flag: bool) -> bool:
        """True on every rank when it is true on any."""
        if self.group is None:
            return flag
        import torch
        import torch.distributed as dist
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def barrier(self):
        if self.group is not None:
            import torch.distributed as dist
            dist.barrier(group=self.group)

    def gather(self, obj: Any) -> List[Any]:
        if self.group is None:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out
