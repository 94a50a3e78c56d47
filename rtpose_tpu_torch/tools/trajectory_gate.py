"""The 480-frame trajectory gate of the port, as one command.

Counterpart of ``tools/trajectory_gate.py``.  The process rule it serves
(``BASELINE.md``): a change to the normalization lowering, to the cache
dtype or to any numerics of the train step re-runs a 480-frame skeleton
training and checks that the regression loss is on the known-good
trajectory, because basin selection is decided by reassociation-level
numerics that step-equality tests cannot certify.

It runs ``python -m rtpose_tpu_torch.tools.train
configs/cruw_pose/hr3d_one_hm_doppler_skel480.py`` with ``--stop_epoch``
(the lr schedule stays the full one-cycle: a shortened schedule would
change the trajectory), reads the run's ``*.log.json``, and passes iff the
mean loc loss over the last observed epoch is below ``--threshold``.

The landmarks behind the default threshold of 25 are the JAX package's, from
its runs on a TPU (``BASELINE.md``): the good basin reads loc ~17 at epoch
20 and ~14 by epoch 45, the bad one plateaus at ~47-58 (the predict-the-mean
level).  The port has no recorded run of this gate on a GPU yet; none of
these values is a measurement of the port.

Usage::

    python -m rtpose_tpu_torch.tools.trajectory_gate --device_cache
    python -m rtpose_tpu_torch.tools.trajectory_gate --device_cache \
        --cache_dtype float8_e4m3fn
    python -m rtpose_tpu_torch.tools.trajectory_gate --dry_run   # print the command only

Exit code 0 = pass, 1 = fail, 2 = could not run or parse.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CONFIG = os.path.join(REPO, "configs", "cruw_pose", "hr3d_one_hm_doppler_skel480.py")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="480-frame trajectory gate (PyTorch port)")
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--epochs", type=int, default=20, help="stop epoch")
    p.add_argument("--threshold", type=float, default=25.0,
                   help="pass iff the last epoch's mean loc loss is below this")
    p.add_argument("--work_dir", default=None, help="run dir (default: a fresh temp dir)")
    p.add_argument("--device_cache", action="store_true")
    p.add_argument("--cache_dtype", default=None,
                   help="e.g. bfloat16 / float8_e4m3fn: the dtype under test when "
                        "gating a cache-compression change")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--dry_run", action="store_true")
    return p.parse_args(argv)


def epoch_locs(work_dir: str) -> dict:
    """{epoch: mean loc_loss over its logged intervals} of the run's logs."""
    by_epoch = {}
    for path in sorted(glob.glob(os.path.join(work_dir, "*.log.json"))):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("mode") == "train" and "loc_loss" in rec:
                    by_epoch.setdefault(int(rec["epoch"]), []).append(float(rec["loc_loss"]))
    return {ep: sum(v) / len(v) for ep, v in sorted(by_epoch.items())}


def last_epoch_loc(work_dir: str):
    """(epoch, mean loc_loss over its logged intervals) of the last epoch."""
    locs = epoch_locs(work_dir)
    if not locs:
        return None, None
    ep = max(locs)
    return ep, locs[ep]


def main(argv=None) -> int:
    args = parse_args(argv)
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="trajectory_gate_")
    cmd = [sys.executable, "-m", "rtpose_tpu_torch.tools.train", args.config,
           "--work_dir", work_dir, "--stop_epoch", str(args.epochs),
           "--seed", str(args.seed), "--device", args.device]
    if args.device_cache:
        cmd.append("--device_cache")
    if args.cache_dtype:
        cmd += ["--cache_dtype", args.cache_dtype]
    print(f"# trajectory gate: {' '.join(cmd)}", file=sys.stderr)
    if args.dry_run:
        return 0
    r = subprocess.run(cmd, cwd=REPO)
    if r.returncode != 0:
        print(f"TRAJECTORY GATE: ERROR (train exited {r.returncode}, logs in {work_dir})")
        return 2
    for ep, loc in epoch_locs(work_dir).items():
        print(f"epoch {ep} mean loc {loc}")
    ep, loc = last_epoch_loc(work_dir)
    if loc is None:
        print(f"TRAJECTORY GATE: ERROR (no loc_loss records in {work_dir})")
        return 2
    verdict = "PASS" if loc < args.threshold else "FAIL"
    print(f"TRAJECTORY GATE: {verdict} — epoch {ep} mean loc {loc:.2f} "
          f"(threshold {args.threshold}) [{work_dir}]")
    return 0 if verdict == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
