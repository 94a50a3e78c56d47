"""Second-stage feature extraction: bilinear BEV sampling at box centers.

Counterpart of ``rtpose_tpu/models/second_stage.py`` (reference
``det3d/models/second_stage/bird_eye_view.py:10-41``): world centers ->
feature-map coordinates via (c - pc_start) / voxel / out_stride, then
bilinear interpolation of the BEV feature map with clamped edges (not
``grid_sample``'s zero padding); the multi-point form concatenates the
points' sections on channels.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..registry import SECOND_STAGE


def bilinear_interpolate(im: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) sampled at unnormalized pixel coords xs, ys (B, N):
    the clamped-edge semantics of the reference's
    ``bilinear_interpolate_torch`` (center_utils.py:130-159).  -> (B, N, C).
    An unbatched (H, W, C) image with (N,) coords gives (N, C)."""
    if im.dim() == 3:
        return bilinear_interpolate(im[None], xs[None], ys[None])[0]
    B, H, W, _ = im.shape
    x0 = torch.clamp(torch.floor(xs), 0, W - 1)
    y0 = torch.clamp(torch.floor(ys), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    xi0, yi0, xi1, yi1 = (a.long() for a in (x0, y0, x1, y1))
    b = torch.arange(B, device=im.device)[:, None]
    Ia, Ib, Ic, Id = im[b, yi0, xi0], im[b, yi1, xi0], im[b, yi0, xi1], im[b, yi1, xi1]
    wa = (x1 - xs) * (y1 - ys)
    wb = (x1 - xs) * (ys - y0)
    wc = (xs - x0) * (y1 - ys)
    wd = (xs - x0) * (ys - y0)
    return (Ia * wa[..., None] + Ib * wb[..., None] + Ic * wc[..., None]
            + Id * wd[..., None])


@SECOND_STAGE.register_module
class BEVFeatureExtractor(nn.Module):
    def __init__(self, pc_start: Sequence[float] = (0.0, 0.0),
                 voxel_size: Sequence[float] = (0.1, 0.1), out_stride: int = 1):
        super().__init__()
        self.pc_start = tuple(pc_start)
        self.voxel_size = tuple(voxel_size)
        self.out_stride = out_stride

    def absl_to_relative(self, absolute: torch.Tensor):
        a1 = (absolute[..., 0] - self.pc_start[0]) / self.voxel_size[0] / self.out_stride
        a2 = (absolute[..., 1] - self.pc_start[1]) / self.voxel_size[1] / self.out_stride
        return a1, a2

    def forward(self, bev_feature: torch.Tensor, batch_centers: torch.Tensor,
                num_point: int = 1) -> torch.Tensor:
        """bev_feature: (B, H, W, C); batch_centers: (B, N * num_point, 2+)
        world xy.  Returns (B, N, C * num_point)."""
        xs, ys = self.absl_to_relative(batch_centers)
        fm = bilinear_interpolate(bev_feature, xs, ys)           # (B, N * np, C)
        if num_point > 1:
            sec = fm.shape[1] // num_point
            fm = torch.cat([fm[:, i * sec:(i + 1) * sec] for i in range(num_point)], dim=2)
        return fm
