"""One rank of the four-card cell's path at a tiny grid on the CPU (gloo):
``python -m torch.distributed.run --nproc_per_node 2 ranks_worker.py [dir]``.
Rank 0 prints the result line.  With ``dir``, rank 1 imports the module
``jax`` from it."""

import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness.dist import Ranks  # noqa: E402
from benchmark.tests.tiny import tiny  # noqa: E402


def main():
    from rtpose_tpu_torch import parallel
    from rtpose_tpu_torch.api import resolve_device
    torch.cuda.get_device_name = lambda d=None: "cpu"
    device = resolve_device("cpu", multihost=True)
    ranks = Ranks(parallel.process_count(), parallel.process_index())
    cell = tiny("hrradarpose_doppler.train_dp4", frames=16)
    cell.chips = ranks.world
    args = types.SimpleNamespace(seed=5, seconds=0.5, trace=0, t_start=None)
    if ranks.rank == 1 and len(sys.argv) > 1:     # a rank that loads a module named jax
        sys.path.insert(0, sys.argv[1])
        import jax  # noqa: F401
    try:
        line = run.rank_line(cell, args, device, ranks)
    finally:
        parallel.shutdown()
    if ranks.rank == 0:
        sys.exit(run.finish(line))


if __name__ == "__main__":
    main()
