"""Trilinear resize with ``align_corners=True`` on channels-last volumes.

Counterpart of ``rtpose_tpu/ops/interpolate.py::
resize_trilinear_align_corners``: the JAX package writes the resize as
three single-axis interpolation matmuls to reach the TPU's MXU; PyTorch has
the same sampling as ``F.interpolate(mode="trilinear", align_corners=True)``
(the reference's own op, hr3d.py:219-224).

``resize_trilinear_int8`` is the int8 serving form of the HRNet final-fuse
resize (``--int8_resize``), as the JAX package computes it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_trilinear_align_corners(x: torch.Tensor,
                                   size_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """(B, Z, Y, X, C) -> (B, tz, ty, tx, C)."""
    if tuple(x.shape[1:4]) == tuple(size_zyx):
        return x
    out = F.interpolate(x.permute(0, 4, 1, 2, 3), size=tuple(size_zyx),
                        mode="trilinear", align_corners=True)
    return out.permute(0, 2, 3, 4, 1).contiguous()


# --- the int8 form (serving path; rtpose_tpu/ops/interpolate.py:77-139) ---

@functools.lru_cache(maxsize=None)
def _interp_matrix_np(s_in: int, s_out: int) -> np.ndarray:
    """(S_out, S_in) align-corners linear interpolation matrix (a copy of
    ``rtpose_tpu/ops/interpolate.py::_interp_matrix_np``)."""
    w = np.zeros((s_out, s_in), dtype=np.float32)
    if s_out == 1 or s_in == 1:
        w[:, 0] = 1.0
        return w
    scale = (s_in - 1) / (s_out - 1)
    pos = np.arange(s_out, dtype=np.float64) * scale
    lo = np.floor(pos).astype(np.int64)
    lo = np.clip(lo, 0, s_in - 2)
    frac = (pos - lo).astype(np.float32)
    w[np.arange(s_out), lo] = 1.0 - frac
    w[np.arange(s_out), lo + 1] = frac
    return w


@functools.lru_cache(maxsize=None)
def _quantized_interp_np(s_in: int, s_out: int):
    """Per-output-row symmetric int8 quantization of the interp matrix
    (``_quantized_interp_np`` of the JAX package): (wq int8, sw float32)."""
    w = _interp_matrix_np(s_in, s_out)
    absmax = w.max(axis=1)
    sw = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    wq = np.clip(np.round(w / sw[:, None]), -127, 127).astype(np.int8)
    return wq, sw


def resize_trilinear_int8(x: torch.Tensor, size_zyx: Tuple[int, int, int],
                          act_scale: float, out_dtype=None) -> torch.Tensor:
    """Int8 form of the final-fuse resize, ``resize_trilinear_folded_int8``
    of the JAX package on the unfolded layout: passes X, then Z, then Y; the
    input re-quantized with the one calibrated scale before each pass; int8
    interpolation matrices with per-output-row scales; the float32 epilogue
    after each pass.

    The integer products run as a float32 matmul of the integer-valued
    tensors, on both devices: every output element sums at most two
    products of at most 127 * 127 (the rest are exact zeros), so each sum
    is an integer far below 2^24 and exact in float32 with TF32 off
    (``api.resolve_device`` turns it off)."""
    B, Z, Y, X, C = x.shape
    tz, ty, tx = size_zyx
    out_dtype = out_dtype or x.dtype
    inv = 1.0 / act_scale

    def q(v):
        return torch.round(v.float() * inv).clamp(-127, 127)

    def mat(s_in, s_out):
        wq, sw = _quantized_interp_np(s_in, s_out)
        return (torch.from_numpy(wq).to(device=x.device, dtype=torch.float32),
                torch.from_numpy(sw).to(x.device) * act_scale)

    out = x
    if X != tx:
        wq, s = mat(X, tx)
        out = torch.einsum("ox,bzyxc->bzyoc", wq, q(out)) * s[:, None]
    if Z != tz:
        wq, s = mat(Z, tz)
        out = torch.einsum("oz,bzyxc->boyxc", wq, q(out)) * s[:, None, None, None]
    if Y != ty:
        wq, s = mat(Y, ty)
        out = torch.einsum("oy,bzyxc->bzoxc", wq, q(out)) * s[:, None, None]
    return out.to(out_dtype)
