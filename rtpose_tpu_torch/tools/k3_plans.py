"""Time every launch-plan candidate of the K3 conv kernel on the card.

    python -m rtpose_tpu_torch.tools.k3_plans        # needs one CUDA card

For each of the main path's four K3 shapes (eval B=1 and training B=8, at
full and half resolution of the flagship grid) and each candidate tile of
``ops.conv_k3.candidate`` (tile width, 64-row blocks per warpgroup), prints
one JSON line: the candidate's plan, its cost key, the forward kernel's
device time (``CALLS`` launches captured in a CUDA graph, replayed between
CUDA events) and whether ``ops.conv_k3.plan`` picks it.  These are the
times the plan's ``PLANE_COST`` and ``STAGE_COST`` are fitted to.
"""

from __future__ import annotations

import json
import subprocess

import torch

from ..ops import conv_k3 as ck

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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k3_plans: no CUDA device; the times are the card's")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    sms = ck._sm_count(torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((32, 32, 3, 3, 3), generator=gen, device=dev) * 0.06
    wr, _ = ck.prepare(w)
    for shape in SHAPES:
        x = torch.randn((*shape, 32), generator=gen, device=dev).to(torch.bfloat16)
        chosen = ck.plan(*shape, sms)
        for tx in sorted({t for t in ck.X_TILES if t < shape[3]} | {shape[3]}):
            for nbw in (1, 2):
                found = ck.candidate(*shape, sms, tx, nbw)
                if found is None:
                    continue
                key, p = found
                ms = device_ms(lambda: ck._run(x, wr, None, p))
                print(json.dumps({"shape": shape, "plan": p._asdict(), "cost": key[0],
                                  "ms": ms, "chosen": p == chosen}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
