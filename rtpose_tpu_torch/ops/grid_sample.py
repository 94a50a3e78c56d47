"""Bilinear / trilinear grid sampling with ``F.grid_sample`` semantics
(``align_corners=False``, zero padding), channels-last.

Counterpart of ``rtpose_tpu/ops/grid_sample.py``, used by the
polar->cartesian feature transform (reference
``det3d/models/feat_transforms/polar_to_cart.py:43-47``).  The taps are
summed in the JAX package's order (x fastest, then y, then z), so the sums
round as its do.  ``F.grid_sample`` computes the same function on
channels-first tensors; the JAX package is the reference.
"""

from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] normalized -> pixel index, align_corners=False."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _tap(x: torch.Tensor, idx, sizes, w: torch.Tensor) -> torch.Tensor:
    """x (B, *sizes, C) at integer float coords ``idx`` (each (B, ...)),
    zero outside, times the weights ``w`` (B, ...)."""
    inside = torch.ones_like(w, dtype=torch.bool)
    clipped = []
    for i, n in zip(idx, sizes):
        inside = inside & (i >= 0) & (i < n)
        clipped.append(torch.clamp(i, 0, n - 1).long())
    b = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (w.dim() - 1)))
    v = x[(b, *clipped)]
    return v * (w * inside.to(x.dtype))[..., None]


def grid_sample_2d_batched(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C); grid: (B, ..., 2) with (gx, gy) normalized.
    -> (B, ..., C)."""
    _, H, W, _ = x.shape
    ix = _unnormalize(grid[..., 0], W)
    iy = _unnormalize(grid[..., 1], H)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx, wy = ix - x0, iy - y0
    sizes = (H, W)
    return (_tap(x, (y0, x0), sizes, (1 - wy) * (1 - wx))
            + _tap(x, (y0, x0 + 1), sizes, (1 - wy) * wx)
            + _tap(x, (y0 + 1, x0), sizes, wy * (1 - wx))
            + _tap(x, (y0 + 1, x0 + 1), sizes, wy * wx))


def grid_sample_3d_batched(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x: (B, D, H, W, C); grid: (B, ..., 3) with (gx, gy, gz) normalized.
    -> (B, ..., C)."""
    _, D, H, W, _ = x.shape
    ix = _unnormalize(grid[..., 0], W)
    iy = _unnormalize(grid[..., 1], H)
    iz = _unnormalize(grid[..., 2], D)
    x0, y0, z0 = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    wx, wy, wz = ix - x0, iy - y0, iz - z0
    out = 0
    for dz, fz in ((0, 1 - wz), (1, wz)):
        for dy, fy in ((0, 1 - wy), (1, wy)):
            for dx, fx in ((0, 1 - wx), (1, wx)):
                out = out + _tap(x, (z0 + dz, y0 + dy, x0 + dx), (D, H, W), fz * fy * fx)
    return out


def grid_sample_2d(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x: (H, W, C); grid: (..., 2) with (gx, gy) normalized.  -> (..., C)."""
    return grid_sample_2d_batched(x[None], grid[None])[0]


def grid_sample_3d(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x: (D, H, W, C); grid: (..., 3) with (gx, gy, gz) normalized."""
    return grid_sample_3d_batched(x[None], grid[None])[0]
