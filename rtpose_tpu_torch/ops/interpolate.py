"""Trilinear resize with ``align_corners=True`` on channels-last volumes.

Counterpart of ``rtpose_tpu/ops/interpolate.py::
resize_trilinear_align_corners``: the JAX package writes the resize as
three single-axis interpolation matmuls to reach the TPU's MXU; PyTorch has
the same sampling as ``F.interpolate(mode="trilinear", align_corners=True)``
(the reference's own op, hr3d.py:219-224).
"""

from __future__ import annotations

from typing import Tuple

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
