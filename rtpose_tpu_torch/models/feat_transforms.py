"""Feature transforms: polar (range-azimuth-elevation) -> cartesian resample.

Counterpart of ``rtpose_tpu/models/feat_transforms.py`` (reference
``det3d/models/feat_transforms/polar_to_cart.py:10-47``): a sampling grid,
built once in numpy from the cartesian ROI and the polar extent, bilinearly
resamples polar feature maps onto a cartesian grid (``ops.grid_sample``).

Both of the JAX package's ``normalized`` modes are kept.  The reference
computes the grid as [0, 1] ratios but samples as if they were in [-1, 1]
(``F.grid_sample``), so it only ever reads the upper-right quadrant of the
polar map: ``normalized='torch_ratio'`` reproduces that; the default
``'minus1_1'`` maps the ratios to [-1, 1].  Grid axis order: (a_ratio,
r_ratio) in 2-D, (e, a, r) in 3-D.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.grid_sample import grid_sample_2d_batched, grid_sample_3d_batched
from ..registry import FEAT_TRANSFORMS

DEG2RAD = np.pi / 180.0


@FEAT_TRANSFORMS.register_module
class PolarToCart(nn.Module):
    def __init__(self, cart_roi: dict = None, voxel_size: float = 0.1,
                 polar_range: Sequence[float] = (0, 100, -60, 60, -20, 20),
                 dimension: str = "2", normalized: str = "minus1_1"):
        super().__init__()
        self.cart_roi = cart_roi
        self.voxel_size = voxel_size
        self.polar_range = tuple(polar_range)   # r, a (deg), e (deg)
        self.dimension = dimension              # '2' (BEV) or '3'
        self.normalized = normalized            # 'minus1_1' | 'torch_ratio'
        self.register_buffer("grid", torch.from_numpy(self._grids()), persistent=False)

    @property
    def transform_dim(self) -> str:
        return self.dimension

    def _grids(self) -> np.ndarray:
        z_min, z_max = self.cart_roi["z"]
        y_min, y_max = self.cart_roi["y"]
        x_min, x_max = self.cart_roi["x"]
        r_min, r_max, a_min, a_max, e_min, e_max = self.polar_range
        a_min, a_max, e_min, e_max = np.array([a_min, a_max, e_min, e_max]) * DEG2RAD
        xs = np.arange(x_min, x_max, self.voxel_size)
        ys = np.arange(y_min, y_max, self.voxel_size)
        if self.dimension == "2":
            yy, xx = np.meshgrid(ys, xs, indexing="ij")
            r = np.sqrt(yy ** 2 + xx ** 2)
            r_ratio = (r - r_min) / (r_max - r_min)
            a_ratio = (np.arctan2(yy, xx) - a_min) / (a_max - a_min)
            grid = np.stack([a_ratio, r_ratio], axis=-1)          # (H, W, 2)
        else:
            zs = np.arange(z_min, z_max, self.voxel_size)
            zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
            r = np.sqrt(zz ** 2 + yy ** 2 + xx ** 2)
            r_ratio = (r - r_min) / (r_max - r_min)
            a_ratio = (np.arctan2(yy, xx) - a_min) / (a_max - a_min)
            e_ratio = (np.arctan2(zz, xx) - e_min) / (e_max - e_min)
            grid = np.stack([e_ratio, a_ratio, r_ratio], axis=-1)  # (D, H, W, 3)
        if self.normalized == "minus1_1":
            grid = grid * 2.0 - 1.0
        return grid.astype(np.float32)

    def forward(self, polar_feature: torch.Tensor) -> torch.Tensor:
        """polar_feature: (B, [D,] H, W, C) channels-last."""
        grid = self.grid.expand(polar_feature.shape[0], *self.grid.shape)
        if self.dimension == "2":
            return grid_sample_2d_batched(polar_feature, grid)
        return grid_sample_3d_batched(polar_feature, grid)
