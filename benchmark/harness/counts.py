"""The yardstick's arithmetic: operations and bytes, from shapes alone.

* ``model_flops``: operations of one call as the program's algorithm
  needs them, counted by ``torch.utils.flop_counter.FlopCounterMode`` over
  the benchmark's own reference model on the ``meta`` device (two per
  multiply-add over every conv's full window; the regression tower on the
  5^3 patches the sparse path evaluates).  ``predict``: the sparse
  predict; ``train``: the loss forward and the backward of a train step.
* ``k3_shapes``: the input shapes of the convs the conv kernel (K3: 3x3x3,
  stride 1, 32 -> 32 channels) computes in one forward; its grad-input in
  the backward is the same conv again.
* ``k3_bound_s`` / ``k1_bound_s``: the least time of one K3 launch or one
  preprocess (K1) launch on the card: max(operations / peak, bytes /
  bandwidth), each input byte read once and each output byte written once.
"""

from __future__ import annotations

import functools
import json
from typing import List, Tuple

import torch

from benchmark.reference import model as ref_model

BF16_PEAK = 989e12      # H100 SXM, dense bf16 FLOP/s (NVIDIA's data sheet)
HBM_BW = 3.35e12        # H100 SXM HBM3 bytes/s
K3_C = 32


def in_channels(cfg: dict) -> int:
    """Input channels the config's radar type gives: D Doppler bins, two
    per bin for complex cubes."""
    ds = cfg["DATASET"]
    d = int(ds.get("DOPPLER_BINS", 32))
    return 2 * d if "complex" in ds["RDR_TYPE"] else d


def grid(cfg: dict) -> Tuple[int, int, int]:
    ds = cfg["DATASET"]
    roi = ds["ROI"][ds["RDR_CUBE"]["ROI_TYPE"]]
    sx, sy, sz = (float(v) for v in ds["RDR_CUBE"]["GRID_SIZE"])
    return tuple(int(round((float(roi[a][1]) - float(roi[a][0])) / s))
                 for a, s in (("z", sz), ("y", sy), ("x", sx)))


@functools.lru_cache(maxsize=None)
def _flops(cfg_json: str, batch: int, kind: str) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    cfg = json.loads(cfg_json)
    net = ref_model.build(cfg["model"], in_channels(cfg), device="meta")
    x = torch.zeros((batch, *grid(cfg), in_channels(cfg)), device="meta")
    with FlopCounterMode(display=False) as counter:
        if kind == "predict":
            with torch.no_grad():
                net.predict(x, sparse=True)
        elif kind == "train":
            ind = torch.zeros((batch, 1), dtype=torch.int64, device="meta")
            hm, reg = net.train_outputs(x, ind, sparse=True)
            (hm.sum() + reg.sum()).backward()
        else:
            raise ValueError(kind)
    return int(counter.get_total_flops())


def model_flops(cfg: dict, batch: int, kind: str) -> int:
    return _flops(json.dumps(cfg, sort_keys=True), batch, kind)


def k3_shapes(cfg: dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(B, Z, Y, X) of each K3-shaped conv of one forward (the trunk's
    3x3x3 stride-1 32 -> 32 convs), in call order."""
    net = ref_model.build(cfg["model"], in_channels(cfg), device="meta")
    shapes = []

    def hook(mod, args):
        w = mod.weight
        if mod.stride == 1 and tuple(w.shape) == (K3_C, K3_C, 3, 3, 3):
            b, _, z, y, x = args[0].shape
            shapes.append((b, z, y, x))

    for m in net.modules():
        if isinstance(m, ref_model.Conv):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        net.features(torch.zeros((batch, *grid(cfg), in_channels(cfg)), device="meta"))
    return shapes


def k3_bound_s(b: int, z: int, y: int, x: int) -> float:
    vox = b * z * y * x
    ops = 2 * vox * K3_C * K3_C * 27
    nbytes = 2 * vox * K3_C * 2 + 27 * K3_C * K3_C * 2 + K3_C * 4   # bf16 in/out, weights, bias
    return max(ops / BF16_PEAK, nbytes / HBM_BW)


def k1_bound_s(b: int, d: int, z: int, y: int, x: int, in_bytes: int = 2) -> float:
    """Raw cube read once (``in_bytes`` an element), float32 written once."""
    n = b * d * z * y * x
    return n * (in_bytes + 4) / HBM_BW
