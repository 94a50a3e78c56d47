"""Readings that the correctness limits are set from, many seeds in one
process (a one-card cell).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--extra control half_batch detail] [--seconds 2] [--dtype float32]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a short
window, the reference check) prints a JSON line: the program's numbers
and, for each ``--extra`` stand-in, the same numbers of that stand-in
against the reference: ``control`` (training: the reference in float8;
eval: the program's own int8 path), ``half_batch`` (training: the
reference leaving half of each batch out, the fault of that name),
``detail`` (training: the widest leaves by name).  ``--dtype float32``
runs the program in float32, a witness beside the reference.  The runs
of ``run.py`` never compute these.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--extra", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--dtype", default=None,
                   help="run the program in this compute dtype (a witness), e.g. float32")
    args = p.parse_args(argv)
    from benchmark.harness.cells import resolve
    from benchmark.harness.dist import Ranks
    from rtpose_tpu_torch.api import resolve_device
    cell = resolve(args.workload)
    if args.dtype:
        for part in ("backbone", "pose_head"):
            cell.cfg["model"][part]["dtype"] = args.dtype
    if cell.chips != 1:
        raise SystemExit("calibrate.py runs one-card cells")
    device = resolve_device("cuda")
    for seed in args.seeds:
        t = time.time()
        res = cell.loop.run(cell, seed, args.seconds, False, device, Ranks(),
                            extra=tuple(args.extra))
        row = {"workload": cell.name, "seed": seed, "program": res["numbers"],
               **res["extra"], "units": res["units"], "seconds": time.time() - t}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
