"""Input readers (counterpart of ``rtpose_tpu/models/readers.py``).

* ``RadarFeatureNet`` — identity pass-through for the radar cube
  (reference ``det3d/models/readers/radar_encoder.py:8-17``).
* ``VoxelFeatureExtractorV3`` — mean of the points in each voxel
  (``voxel_encoder.py:9-24``), over padded (V, P, F) voxels with a per-voxel
  point count.
* ``PillarFeatureNet`` / ``PointPillarsScatter`` — the PointPillars encoding
  and the dense BEV scatter (``pillar_encoder.py:15-218``) in the JAX
  package's fixed-shape form.  ``PillarFeatureNet``'s layers are flax's: a
  ``nn.Dense`` without bias (``linears.i``, a torch-layout (out, in)
  weight) and a ``nn.LayerNorm`` (``norms.i``: epsilon 1e-6, the fast
  variance; ``dcn_head.LayerNormNHWC``).

Readers take unbatched inputs, as the flax modules do under ``jax.vmap``.
``VoxelFeatureExtractorV3`` and ``PillarFeatureNet`` index from the last
axes, so a leading batch axis passes through them unchanged;
``PointPillarsScatter`` takes one sample.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import READERS
from .dcn_head import LayerNormNHWC


@READERS.register_module
class RadarFeatureNet(nn.Module):
    """Identity reader: the radar cube is already a dense grid."""

    def forward(self, rdr_tensor: torch.Tensor) -> torch.Tensor:
        return rdr_tensor


@READERS.register_module
class VoxelFeatureExtractorV3(nn.Module):
    """Mean of the padded points in each voxel: (..., V, P, F) features and
    (..., V) counts -> (..., V, F); zeros for empty and padding voxels."""

    def __init__(self, num_input_features: int = 4):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, features: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
        denom = torch.clamp(num_points.to(features.dtype), min=1.0)[..., None]
        return features.sum(dim=-2) / denom


@READERS.register_module
class PillarFeatureNet(nn.Module):
    """PointPillars per-pillar PointNet (one PFN layer by default, as the
    reference's ``num_filters=(64,)``): (..., V, P, F) raw point features,
    (..., V) counts and (..., V, 3) int (z, y, x) pillar coordinates ->
    (..., V, C)."""

    def __init__(self, num_filters: Sequence[int] = (64,),
                 voxel_size: Sequence[float] = (0.2, 0.2, 4.0),
                 pc_range: Sequence[float] = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
                 num_input_features: int = 4, with_distance: bool = False):
        super().__init__()
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in pc_range)
        self.with_distance = with_distance
        widths = [num_input_features + 5 + int(with_distance), *num_filters]
        self.linears = nn.ModuleList(nn.Linear(i, o, bias=False)
                                     for i, o in zip(widths[:-1], widths[1:]))
        self.norms = nn.ModuleList(LayerNormNHWC(o, eps=1e-6) for o in widths[1:])

    def forward(self, features: torch.Tensor, num_points: torch.Tensor,
                coors: torch.Tensor) -> torch.Tensor:
        P = features.shape[-2]
        countf = torch.clamp(num_points.to(features.dtype), min=1.0)
        # decorations: offsets from the pillar's mean and from its center
        points_mean = features[..., :3].sum(dim=-2, keepdim=True) / countf[..., None, None]
        f_cluster = features[..., :3] - points_mean
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x_offset = vx / 2 + self.pc_range[0]
        y_offset = vy / 2 + self.pc_range[1]
        cf = coors.to(features.dtype)
        xc = features[..., 0:1] - (cf[..., None, 2:3] * vx + x_offset)
        yc = features[..., 1:2] - (cf[..., None, 1:2] * vy + y_offset)
        feats = [features, f_cluster, xc, yc]
        if self.with_distance:
            feats.append(torch.linalg.norm(features[..., :3], dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1)
        pmask = torch.arange(P, device=x.device) < num_points[..., None]
        pmask = pmask.to(x.dtype)[..., None]
        x = x * pmask
        for linear, norm in zip(self.linears, self.norms):
            x = F.relu(norm(linear(x))) * pmask
        return x.max(dim=-2).values


@READERS.register_module
class PointPillarsScatter(nn.Module):
    """Scatter (V, C) pillar features at (V, 3) (z, y, x) coordinates onto a
    dense (Y, X, C) BEV canvas; ``valid`` (V,) drops padding pillars (weight
    0 on row 0)."""

    def __init__(self, num_input_features: int = 64):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxel_features: torch.Tensor, coors: torch.Tensor, valid: torch.Tensor,
                grid_yx) -> torch.Tensor:
        ny, nx = grid_yx
        C = voxel_features.shape[-1]
        flat = coors[:, 1].long() * nx + coors[:, 2].long()
        flat = torch.where(valid, flat, torch.zeros_like(flat))
        w = valid.to(voxel_features.dtype)[:, None]
        canvas = torch.zeros((ny * nx, C), dtype=voxel_features.dtype,
                             device=voxel_features.device)
        canvas.index_add_(0, flat, voxel_features * w)
        return canvas.reshape(ny, nx, C)
