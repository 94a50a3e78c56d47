"""Radar-cube preprocessing: ROI crop + normalize + clamp + channels-last.

Counterpart of ``rtpose_tpu/ops/preprocess.py``.  The host ships the raw
(D, Z, Y, X) cube in its on-disk dtype and the card does crop + scale +
clamp + transpose in one pass, in the CUDA kernel ``csrc/preprocess.cu``
(which replaces the Pallas kernels K1 ``fused_preprocess_batch`` and K2
``fused_preprocess``).

* ``fused_preprocess_batch`` / ``fused_preprocess`` — the kernel's
  wrappers.  A CUDA tensor launches the kernel (or raises on a shape or
  dtype it does not take); a CPU tensor takes the plain version.
* ``preprocess_reference`` — the plain PyTorch version: slice, ``.float()``,
  ``(x - n0) * (1 / n1)``, ``clamp_min(0)``, permute.

Outputs are float32 in the model's (Z', Y', X', D) layout.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def preprocess_reference(cube: torch.Tensor, roi_idx, norm_start: float,
                         norm_scale: float) -> torch.Tensor:
    """Plain version: (..., D, Z, Y, X) raw -> (..., Z', Y', X', D) float32."""
    z0, z1, y0, y1, x0, x1 = roi_idx
    c = cube[..., z0:z1 + 1, y0:y1 + 1, x0:x1 + 1].float()
    c = ((c - float(norm_start)) * (1.0 / float(norm_scale))).clamp_min(0.0)
    n = c.dim()
    return c.permute(*range(n - 4), n - 3, n - 2, n - 1, n - 4).contiguous()


def fused_preprocess_batch(cubes: torch.Tensor,
                           roi_idx: Tuple[int, int, int, int, int, int],
                           norm_start: float, norm_scale: float) -> torch.Tensor:
    """(B, D, Z, Y, X) raw (f32/f16/bf16) -> (B, Z', Y', X', D) float32 over
    the static INCLUSIVE ROI ``(z0, z1, y0, y1, x0, x1)``."""
    if cubes.device.type == "cpu":
        return preprocess_reference(cubes, roi_idx, norm_start, norm_scale)
    return _launch(cubes, roi_idx, norm_start, norm_scale, "preprocess")


def _launch(cubes: torch.Tensor, roi_idx, norm_start: float, norm_scale: float,
            counter: str) -> torch.Tensor:
    """Check a CUDA (B, D, Z, Y, X) tensor and launch the kernel on it,
    counted under ``counter`` (the wrapper it came through)."""
    if cubes.device.type != "cuda":
        raise ValueError(f"preprocess kernel: unsupported device {cubes.device}")
    if cubes.dtype not in _DTYPE_CODE:
        raise TypeError(f"preprocess kernel: unsupported dtype {cubes.dtype}")
    if cubes.dim() != 5 or not cubes.is_contiguous():
        raise ValueError("preprocess kernel: needs a contiguous (B, D, Z, Y, X) "
                         f"tensor, got shape {tuple(cubes.shape)}")
    B, D, Z, Y, X = cubes.shape
    z0, z1, y0, y1, x0, x1 = (int(v) for v in roi_idx)
    if not (0 <= z0 <= z1 < Z and 0 <= y0 <= y1 < Y and 0 <= x0 <= x1 < X):
        raise ValueError(f"ROI {roi_idx} outside cube of shape {(Z, Y, X)}")
    zo, yo, xo = z1 - z0 + 1, y1 - y0 + 1, x1 - x0 + 1
    if B * zo > 65535 or yo > 65535:
        raise ValueError("preprocess kernel: grid too large")
    out = torch.empty((B, zo, yo, xo, D), dtype=torch.float32, device=cubes.device)
    build.launch("preprocess", counter, cubes.device,
                 cubes.data_ptr(), out.data_ptr(), _DTYPE_CODE[cubes.dtype], B, D, Z, Y, X,
                 z0, y0, x0, zo, yo, xo, float(norm_start), 1.0 / float(norm_scale))
    return out


def fused_preprocess(cube: torch.Tensor,
                     roi_idx: Tuple[int, int, int, int, int, int],
                     norm_start: float, norm_scale: float) -> torch.Tensor:
    """Single cube: (D, Z, Y, X) -> (Z', Y', X', D) float32 — the B = 1
    launch of the batch kernel."""
    if cube.dim() != 4:
        raise ValueError(f"expected (D, Z, Y, X), got shape {tuple(cube.shape)}")
    if cube.device.type == "cpu":
        return preprocess_reference(cube, roi_idx, norm_start, norm_scale)
    return _launch(cube.unsqueeze(0), roi_idx, norm_start, norm_scale, "preprocess_single")[0]
