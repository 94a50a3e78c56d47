"""Input readers (counterpart of ``rtpose_tpu/models/readers.py``; the LiDAR
readers are not ported yet)."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..registry import READERS


@READERS.register_module
class RadarFeatureNet(nn.Module):
    """Identity reader: the radar cube is already a dense grid
    (reference ``det3d/models/readers/radar_encoder.py:8-17``)."""

    def forward(self, rdr_tensor: torch.Tensor) -> torch.Tensor:
        return rdr_tensor
