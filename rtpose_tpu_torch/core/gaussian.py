"""Gaussian heatmap target math.

Counterpart of ``rtpose_tpu/core/gaussian.py:30-56, 114-148`` (reference
``det3d/core/utils/center_utils.py:17-99``): a truncated isotropic gaussian
centered at an integer voxel, window half-width ``radius``,
``sigma = (2 * radius + 1) / 6`` and the reference's 3-D normalization
``exp(-r^2 / (2 sigma^2)^(3/2))``, max-merged over objects.

* ``gaussian_radius`` — the closed-form minimal radius for a box (host,
  numpy).
* ``dense_pose_heatmap`` — the on-device form, batched: each object's
  truncated gaussian is evaluated densely over the fixed grid and
  max-reduced into the heatmap, one object at a time (so the working set
  is one (B, Z, Y, X) volume, not one per object).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gaussian_radius(det_size, min_overlap: float = 0.5) -> float:
    """Minimal gaussian radius keeping IoU >= min_overlap for a (h, w) box
    (center_utils.py:17-37: the three-case closed form)."""
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def dense_pose_heatmap(centers_zyx: torch.Tensor, valid: torch.Tensor,
                       grid_zyx: Tuple[int, int, int], radius: int) -> torch.Tensor:
    """Heatmaps of up to M objects per sample.

    Args:
      centers_zyx: (B, M, 3) integer voxel centers in (z, y, x) order.
      valid: (B, M) bool — which of the M padded centers are real objects.
      grid_zyx: static (Z, Y, X).
      radius: static truncation half-width.

    Returns (B, Z, Y, X) float32: the max over each sample's valid objects
    of the truncated gaussian (0 where none reaches).
    """
    nz, ny, nx = grid_zyx
    dev = centers_zyx.device
    sigma = (2 * radius + 1) / 6.0
    denom = (2.0 * sigma * sigma) ** 1.5
    B, M, _ = centers_zyx.shape
    zs = torch.arange(nz, device=dev, dtype=torch.int32)[None, :, None, None]
    ys = torch.arange(ny, device=dev, dtype=torch.int32)[None, None, :, None]
    xs = torch.arange(nx, device=dev, dtype=torch.int32)[None, None, None, :]
    c = centers_zyx.to(torch.int32)
    hm = torch.zeros((B, nz, ny, nx), dtype=torch.float32, device=dev)
    for m in range(M):
        dz = zs - c[:, m, 0, None, None, None]
        dy = ys - c[:, m, 1, None, None, None]
        dx = xs - c[:, m, 2, None, None, None]
        r2 = (dx * dx + dy * dy + dz * dz).to(torch.float32)
        g = torch.exp(-r2 / denom)
        inside = ((dz.abs() <= radius) & (dy.abs() <= radius) & (dx.abs() <= radius)
                  & valid[:, m, None, None, None])
        hm = torch.maximum(hm, torch.where(inside, g, 0.0))
    return hm
