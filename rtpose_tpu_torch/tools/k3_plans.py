"""Time every launch-plan candidate of the K3 conv kernels on the card.

    python -m rtpose_tpu_torch.tools.k3_plans          # bf16 K3; needs one CUDA card
    python -m rtpose_tpu_torch.tools.k3_plans --int8   # the int8 K3 kernel

For each of the main path's four K3 shapes (B=1 and B=8, at full and half
resolution of the flagship grid) and each candidate tile of
``ops.conv_k3.candidates`` (with ``--int8``: ``ops.conv_k3_int8.candidates``;
tile width, 64-row blocks per warpgroup), prints one JSON line: the
candidate's plan, its cost key, the kernel's device time (``CALLS`` launches
captured in a CUDA graph, replayed between CUDA events) and whether
``plan`` picks it.  These are the times the plan's ``PLANE_COST`` and
``STAGE_COST`` are fitted to: the last line, ``{"fit": ...}``, gives the
pair on a grid of 0.1 steps under which the plan's choices lose the least
time against the fastest candidate of each shape (summed over the shapes
as ratios), the pair in the module now, and each one's ratios.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..ops import build
from ..ops import conv_k3 as ck
from ..ops import conv_k3_int8 as ck8

SHAPES = ((1, 16, 64, 160), (1, 8, 32, 80), (8, 16, 64, 160), (8, 8, 32, 80))
CALLS, REPLAYS = 20, 5


def device_ms(fn) -> float:
    """Device time of one ``fn()``: CALLS calls in a CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (CALLS * REPLAYS)


def fit(rows, mod, stage_bytes_per_position: int) -> dict:
    """The (PLANE_COST, STAGE_COST) pair whose plans come closest to the
    fastest candidate at every shape, and how the module's pair does."""
    shapes = sorted({tuple(r["shape"]) for r in rows})

    def ratios(pc: float, sc: float) -> list:
        out = []
        for shape in shapes:
            mine = [r for r in rows if tuple(r["shape"]) == shape]
            key = [(r["plan"]["max_planes"] * (2 * r["plan"]["nbw"] + pc)
                    + sc * r["plan"]["positions"] * stage_bytes_per_position / 1024,
                    r["plan"]["tiles"] * r["plan"]["nbw"], -r["plan"]["tx"]) for r in mine]
            chosen = mine[key.index(min(key))]["ms"]
            out.append(chosen / min(r["ms"] for r in mine))
        return out

    grid = [(pc / 10, sc / 10) for pc in range(21) for sc in range(21)]
    best = min(grid, key=lambda g: (sum(ratios(*g)), g))
    return {"PLANE_COST": best[0], "STAGE_COST": best[1], "ratios": ratios(*best),
            "module": [mod.PLANE_COST, mod.STAGE_COST],
            "module_ratios": ratios(mod.PLANE_COST, mod.STAGE_COST),
            "shapes": shapes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--int8", action="store_true",
                    help="time the int8 kernel's candidates (bf16 output)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_plans: no CUDA device; the times are the card's")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    mod = ck8 if args.int8 else ck
    sms = build.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.int8:
        wk = ck8.prepare(torch.randint(-127, 128, (32, 32, 3, 3, 3), generator=gen, device=dev,
                                       dtype=torch.int8))
        scale = torch.rand((32,), generator=gen, device=dev) * 1e-3
    else:
        wr, _ = ck.prepare(torch.randn((32, 32, 3, 3, 3), generator=gen, device=dev) * 0.06)
    rows = []
    for shape in SHAPES:
        if args.int8:
            xq = torch.randint(-127, 128, (*shape, 32), generator=gen, device=dev,
                               dtype=torch.int8)
        else:
            x = torch.randn((*shape, 32), generator=gen, device=dev).to(torch.bfloat16)
        chosen = mod.plan(*shape, sms)
        for key, p in mod.candidates(*shape, sms):
            if args.int8:
                ms = device_ms(lambda: ck8._run(xq, wk, scale, None, torch.bfloat16, p))
            else:
                ms = device_ms(lambda: ck._run(x, wr, None, "conv3d_k3", p))
            row = {"shape": shape, "plan": p._asdict(), "cost": key[0], "ms": ms,
                   "chosen": p == chosen}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"fit": fit(rows, mod, 32 if args.int8 else 64)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
