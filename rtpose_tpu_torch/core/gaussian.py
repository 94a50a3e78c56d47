"""Gaussian heatmap target math.

Counterpart of ``rtpose_tpu/core/gaussian.py:30-56, 67-102, 114-148`` (reference
``det3d/core/utils/center_utils.py:17-99``): a truncated isotropic gaussian
centered at an integer voxel, window half-width ``radius``,
``sigma = (2 * radius + 1) / 6`` and the reference's 3-D normalization
``exp(-r^2 / (2 sigma^2)^(3/2))``, max-merged over objects.

* ``gaussian_radius`` — the closed-form minimal radius for a box (host,
  numpy).
* ``gaussian3d`` / ``draw_gaussian3d`` — the host form (numpy): one object's
  window splatted into the heatmap in place, as the host target assigner
  draws it.
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


def gaussian3d(shape, sigma: float = 1.0, modulation_coef: float = 1.0) -> np.ndarray:
    """(d, h, w) gaussian window with the reference's ``(2 sigma^2)^(3/2)``
    denominator (center_utils.py:67-72)."""
    m, n, p = [(ss - 1.0) / 2.0 for ss in shape]
    z, y, x = np.ogrid[-m: m + 1, -n: n + 1, -p: p + 1]
    h = np.exp(-(x * x + y * y + z * z) / (2 * sigma * sigma) ** 1.5) * modulation_coef
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian3d(heatmap: np.ndarray, center, radius: int, k: float = 1.0,
                    modulation_coef: float = 1.0) -> np.ndarray:
    """Splat a truncated 3-D gaussian into ``heatmap`` (Z, Y, X) in place.
    ``center`` is (x, y, z) integer voxel coordinates (center_utils.py:74-91);
    the window is clipped at the volume's boundary and merged by max."""
    diameter = 2 * radius + 1
    gaussian = gaussian3d((diameter,) * 3, sigma=diameter / 6.0,
                          modulation_coef=modulation_coef)
    x, y, z = int(center[0]), int(center[1]), int(center[2])
    nz, ny, nx = heatmap.shape[:3]
    x_lo, x_hi = min(x, radius), min(nx - x, radius + 1)
    y_lo, y_hi = min(y, radius), min(ny - y, radius + 1)
    z_lo, z_hi = min(z, radius), min(nz - z, radius + 1)
    masked_hm = heatmap[z - z_lo: z + z_hi, y - y_lo: y + y_hi, x - x_lo: x + x_hi]
    masked_g = gaussian[radius - z_lo: radius + z_hi, radius - y_lo: radius + y_hi,
                        radius - x_lo: radius + x_hi]
    if min(masked_g.shape) > 0 and min(masked_hm.shape) > 0:
        np.maximum(masked_hm, masked_g * k, out=masked_hm)
    return heatmap


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
