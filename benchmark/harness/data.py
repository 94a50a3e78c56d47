"""Seeded weights and frames: the one general generator of the traffic.

Everything is drawn on the device from ``--seed`` with a
``torch.Generator`` in a few large calls, so a seed gives the same weights
and frames on every run.  A traffic file (``benchmark/traffic/*.json``)
sets the parameters: how many distinct frames, the pose geometry and the
radar energy around the joints.

* Weights (``make_weights``): every parameter the reference names, in the
  port's names: He-normal conv kernels (fan-in), zero biases, unit
  GroupNorm scales, the heatmap output bias at the config's init bias.
* Frames (``make_frames``): one person a frame; the pelvis at a random
  voxel inside the grid's margin, off the voxel edges by at least a tenth
  of a voxel (so no target voxel depends on rounding); the 15 joints a
  skeleton template, turned by a random yaw, jittered; the cube is
  background noise plus gaussian blobs of energy at the joints, spread
  over the Doppler bins by a random profile (``raw``: the ROI-cropped f16
  cube the loader ships with ``--device_preprocess``), or the complex
  cube's real and imaginary parts, cropped and in float32 as the dataset
  prepares them (``tensor``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness import counts
from benchmark.reference import model as ref_model

# a standing person, meters from the pelvis (x forward, y left, z up)
SKELETON = [
    (0.0, 0.0, 0.0), (0.0, -0.1, 0.0), (0.0, -0.1, -0.45), (0.0, -0.1, -0.88),
    (0.0, 0.1, 0.0), (0.0, 0.1, -0.45), (0.0, 0.1, -0.88), (0.0, 0.0, 0.25),
    (0.0, 0.0, 0.5), (0.0, 0.0, 0.68), (0.0, 0.18, 0.45), (0.0, 0.2, 0.18),
    (0.0, 0.2, -0.05), (0.0, -0.18, 0.45), (0.0, -0.2, 0.18),
]
MASK63 = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """Independent streams of one seed: 0 weights, 1 frames, 2 samples."""
    return torch.Generator(device=device).manual_seed((int(seed) * 4 + stream) & MASK63)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    specs = ref_model.param_specs(ref_model.build(cfg["model"], counts.in_channels(cfg),
                                                  device="meta"))
    init_bias = float(cfg["model"]["pose_head"].get("init_bias", -2.19))
    g = generator(seed, 0, device)
    convs = [(n, s) for n, s, k in specs if k == "conv"]
    draw = torch.randn(sum(math.prod(s) for _, s in convs), generator=g, device=device)
    out, at = {}, 0
    for n, s in convs:
        size = math.prod(s)
        out[n] = draw[at:at + size].view(s) * (2.0 / math.prod(s[1:])) ** 0.5
        at += size
    fill = {"conv_bias": 0.0, "norm_b": 0.0, "norm_w": 1.0, "hm_bias": init_bias}
    for n, s, k in specs:
        if k != "conv":
            out[n] = torch.full(s, fill[k], device=device)
    return out


def _poses(cfg: dict, traffic: dict, n: int, g: torch.Generator, device) -> torch.Tensor:
    """(n, 15, 3) world keypoints."""
    ds = cfg["DATASET"]
    roi = ds["ROI"][ds["RDR_CUBE"]["ROI_TYPE"]]
    vs = torch.tensor([float(v) for v in ds["RDR_CUBE"]["GRID_SIZE"]], device=device)
    rmin = torch.tensor([float(roi[a][0]) for a in "xyz"], device=device)
    Z, Y, X = counts.grid(cfg)
    p = traffic["pose"]
    mz, my, mx = p["margin_vox_zyx"]
    lo = torch.tensor([mx, my, mz], device=device, dtype=torch.float32)
    hi = torch.tensor([X - 1 - mx, Y - 1 - my, Z - 1 - mz], device=device, dtype=torch.float32)
    u = torch.rand((n, 3), generator=g, device=device)
    vox = torch.floor(lo + u * (hi - lo + 1)).clamp(max=hi)
    frac = 0.1 + 0.8 * torch.rand((n, 3), generator=g, device=device)
    pelvis = (vox + frac) * vs + rmin
    yaw = (torch.rand((n,), generator=g, device=device) * 2 - 1) * math.radians(p["yaw_deg"])
    c, s = torch.cos(yaw), torch.sin(yaw)
    t = torch.tensor(SKELETON, device=device) * p["scale"]
    rx = c[:, None] * t[None, :, 0] - s[:, None] * t[None, :, 1]
    ry = s[:, None] * t[None, :, 0] + c[:, None] * t[None, :, 1]
    body = torch.stack([rx, ry, t[None, :, 2].expand(n, -1)], dim=-1)
    jitter = torch.randn((n, 15, 3), generator=g, device=device) * p["jitter_m"]
    jitter[:, 0] = 0.0
    return pelvis[:, None, :] + body + jitter


def make_frames(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The traffic's ``frames`` distinct frames on ``device``: 'poses'
    (n, 15, 3) float32 and 'raw' (n, D, Z, Y, X) f16 or 'tensor'
    (n, Z, Y, X, C) float32."""
    n = int(traffic["frames"])
    g = generator(seed, 1, device)
    poses = _poses(cfg, traffic, n, g, device)
    ds = cfg["DATASET"]
    roi = ds["ROI"][ds["RDR_CUBE"]["ROI_TYPE"]]
    vs = [float(v) for v in ds["RDR_CUBE"]["GRID_SIZE"]]
    rmin = [float(roi[a][0]) for a in "xyz"]
    Z, Y, X = counts.grid(cfg)
    C = counts.in_channels(cfg)
    cube = traffic["cube"]
    kind = cube["kind"]
    sz, sy, sx = cube["blob_sigma_vox_zyx"]
    out = (torch.empty((n, C, Z, Y, X), dtype=torch.float16, device=device) if kind == "raw"
           else torch.empty((n, Z, Y, X, C), dtype=torch.float32, device=device))
    zz = torch.arange(Z, device=device, dtype=torch.float32)[:, None, None]
    yy = torch.arange(Y, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(X, device=device, dtype=torch.float32)[None, None, :]
    chunk = 4
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        m = b - a
        vox = [(poses[a:b, :, i] - rmin[i]) / vs[i] for i in range(3)]        # x, y, z
        amp = cube["amp"][0] + (cube["amp"][1] - cube["amp"][0]) * torch.rand(
            (m, 15), generator=g, device=device)
        energy = torch.zeros((m, Z, Y, X), device=device)
        for j in range(15):
            d2 = (((zz[None] - vox[2][:, j, None, None, None]) / sz) ** 2
                  + ((yy[None] - vox[1][:, j, None, None, None]) / sy) ** 2
                  + ((xx[None] - vox[0][:, j, None, None, None]) / sx) ** 2)
            energy += amp[:, j, None, None, None] * torch.exp(-0.5 * d2)
        noise = torch.randn((m, C, Z, Y, X), generator=g, device=device) * cube["noise"]
        if kind == "raw":
            profile = torch.exp(torch.randn((m, C), generator=g, device=device))
            profile = profile / profile.mean(dim=1, keepdim=True)
            out[a:b] = (cube["offset"] + noise + energy[:, None] * profile[:, :, None, None, None]
                        ).to(torch.float16)
        else:
            half = C // 2
            phase = torch.rand((m, half), generator=g, device=device) * (2 * math.pi)
            wave = torch.cat([torch.cos(phase), torch.sin(phase)], dim=1)
            out[a:b] = (noise + energy[:, None] * wave[:, :, None, None, None]
                        ).permute(0, 2, 3, 4, 1)
    return {"poses": poses, kind: out}


def to_host(frames: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Pinned host copies (the device copies can then be freed)."""
    pin = next(iter(frames.values())).device.type == "cuda"
    out = {}
    for k, v in frames.items():
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
        h.copy_(v)
        out[k] = h
    return out


class HostFrames:
    """The frames as a dataset of the program's item layout (what its
    CRUW dataset yields: 'meta', 'poses' (1, 15, 3), 'num_poses', and
    'rdr_raw' or 'rdr_tensor'), over pinned host tensors."""

    def __init__(self, host: Dict[str, torch.Tensor]):
        self.host = host
        self.key = "raw" if "raw" in host else "tensor"

    def __len__(self):
        return self.host["poses"].shape[0]

    def __getitem__(self, i: int) -> dict:
        import numpy as np
        item = {"meta": dict(seq="0", frame=str(i), rdr_frame=str(i)),
                "poses": self.host["poses"][i:i + 1].numpy(),
                "num_poses": np.int32(1)}
        item["rdr_raw" if self.key == "raw" else "rdr_tensor"] = self.host[self.key][i].numpy()
        return item
