"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of ``BENCHMARK.json`` named ``<cell>`` on the card(s) this
machine holds and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number the correctness check compared beside its limit
(also the last lines of standard error).

Everything is found by name (``harness/cells.py``): the configuration in
``configs/`` and the reference model it names in ``reference/``, the
traffic mix in ``traffic/`` (whose ``kind`` names its loop,
``harness/<kind>.py``), the correctness limits in ``limits/`` and each
per-layer metric's reader in ``metrics/``.  A cell on several cards
starts one process a card with ``torch.distributed.run --standalone``;
rank 0 reports.

The run exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), and if a JAX module (``jax``, ``jaxlib``,
``flax``) or the JAX package (``rtpose_tpu``) is loaded once the window
has closed, in this process or in any rank of a multi-card cell.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "rtpose_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank_out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--t_start", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


HOST_CORES = 4


def _env(pin: bool):
    """Kernel caches at fixed paths inside the checkout; one intra-op
    thread; a one-card run (not a rank of a multi-card one) on
    ``HOST_CORES`` fixed cores.  A B=1 eval stream is bound by the host's
    dispatch, and on the H100 machines it ran faster and steadier so than
    with a thread a core and no affinity."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "benchmark", ".cache",
                                                           "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "benchmark", ".cache",
                                                               "torch_extensions"))
    os.environ["OMP_NUM_THREADS"] = "1"
    if pin and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:HOST_CORES])


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(cell, res: dict, setup_s: float) -> dict:
    values = {"setup_s": setup_s}
    if "frame_ms" in res:
        values.update(frames_per_s=res["rate"], frame_ms_p50=percentile(res["frame_ms"], 50),
                      frame_ms_p95=percentile(res["frame_ms"], 95),
                      batch_frames_per_s=res["rate"],
                      batch_ms_p50=percentile(res["call_ms"], 50),
                      batch_ms_p95=percentile(res["call_ms"], 95))
    else:
        values["train_samples_per_s"] = res["rate"]
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def per_layer(cell, res: dict) -> dict:
    tr = res["trace"]
    tr.extra.update(cell=cell, host_ms=res.get("host_ms_untraced"),
                    unprofiled_s=res.get("unprofiled_s"))
    out = {}
    for m in cell.per_layer:
        v = cell.reader(m["name"])(tr)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def drive(cell, args, device, ranks) -> dict:
    """One run on this process's card: the loop's result plus the line's
    parts (rank 0's are reported)."""
    import torch
    res = cell.loop.run(cell, args.seed, args.seconds, bool(args.trace), device, ranks)
    t_start = args.t_start if args.t_start is not None else T_START
    setup_s = res["setup_end"] - time.perf_counter() + time.time() - t_start
    line = {"attempted": res.get("frames", res["units"]), "failed": res["failed"]}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips}
    peaks = ranks.gather(res.get("memory_peak_bytes", 0))
    device_info["memory_peak_bytes"] = max(peaks)
    if args.trace:
        tr = res["trace"]
        busy = ranks.gather((tr.busy_s, tr.window_s))
        device_info["busy_s"] = statistics.fmean(b for b, _ in busy)
        device_info["window_s"] = statistics.fmean(w for _, w in busy)
        line["metrics"] = per_layer(cell, res) if ranks.rank == 0 else {}
        line["breakdown"] = tr.breakdown()
    else:
        line["metrics"] = end_to_end(cell, res, setup_s)
    line["device"] = device_info
    if ranks.rank == 0:
        from benchmark.harness import check
        numbers = res["numbers"]
        line["correct"] = (check.verdict(numbers, cell.limits)
                           and res["failed"] == 0 and res["units"] > 0)
        line["checks"] = check.report(numbers, cell.limits)
    return line


def finish(line: dict) -> int:
    """Print the result line, unless a JAX module is loaded in this process
    or was in a rank that ran the program (``line["forbidden"]``)."""
    bad = sorted(set(forbidden_modules()) | set(line.get("forbidden", ())))
    if bad:
        print(f"run.py: JAX modules loaded in a process of the run: {bad}", file=sys.stderr)
        return 3
    ordered = {k: line[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in line:
        ordered["breakdown"] = line["breakdown"]
    ordered["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else str(v["value"]),
                             "limit": v["limit"]} for k, v in line["checks"].items()}
    for k, v in ordered["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(ordered), flush=True)
    return 0


def rank_line(cell, args, device, ranks) -> dict:
    """One rank's run; rank 0's line also names every JAX module loaded in
    any rank once the window has closed."""
    line = drive(cell, args, device, ranks)
    line["forbidden"] = sorted(set().union(*ranks.gather(forbidden_modules())))
    ranks.barrier()
    return line


def rank_main(args, cell) -> int:
    """One rank of a multi-card cell (under torch.distributed.run)."""
    from rtpose_tpu_torch import parallel
    from rtpose_tpu_torch.api import resolve_device
    from benchmark.harness.dist import Ranks
    device = resolve_device("cuda", multihost=True)
    ranks = Ranks(parallel.process_count(), parallel.process_index())
    try:
        line = rank_line(cell, args, device, ranks)
    finally:
        parallel.shutdown()
    if ranks.rank == 0:
        with open(args.rank_out, "w") as f:
            json.dump(line, f)
    return 0


def launch_ranks(args, cell) -> int:
    import tempfile
    fd, out = tempfile.mkstemp(prefix="bench_rank0_", suffix=".json")
    os.close(fd)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(cell.chips), os.path.abspath(__file__), "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace),
           "--rank_out", out, "--t_start", repr(T_START)]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                                    if p]))
    try:
        rc = subprocess.run(cmd, env=env).returncode
        if rc != 0:
            print(f"run.py: the ranks exited {rc}", file=sys.stderr)
            return rc or 1
        with open(out) as f:
            line = json.load(f)
    finally:
        os.unlink(out)
    return finish(line)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.harness.cells import resolve
    cell = resolve(args.workload)
    _env(pin=args.rank_out is None and cell.chips == 1)
    import torch
    torch.set_num_threads(1)
    if args.rank_out is not None:
        return rank_main(args, cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        return launch_ranks(args, cell)
    from rtpose_tpu_torch.api import resolve_device
    from benchmark.harness.dist import Ranks
    device = resolve_device("cuda")
    return finish(drive(cell, args, device, Ranks()))


if __name__ == "__main__":
    sys.exit(main())
