"""VoxelNet: the LiDAR companion detector.

Counterpart of ``rtpose_tpu/models/voxelnet.py`` (reference
``voxelnet.py:8-66``): padded voxels -> ``VoxelFeatureExtractorV3`` (mean)
-> the dense scatter onto the (Z, Y, X) grid (``ops.voxelize.
scatter_to_dense``, the whole batch in one ``index_add_``) -> HRNet3D ->
[neck] -> CenterHead.  The reader and the dense grid stay float32; the backbone casts
to its compute dtype, as the flax modules do.

Batch layout (the model input, ``engine.steps.VOXEL_KEYS``):
  voxels:               (B, V, P, F) float32
  num_points_per_voxel: (B, V) int
  coors:                (B, V, 3) int (z, y, x)
  num_voxels:           (B,) int

The backbone's first block takes the reader's ``num_input_features``
channels (flax infers them from the input; the arch table's ``inplanes``
is the radar cube's).  Module names are RadarPoseNet's (``reader``,
``backbone``, ``pose_head``), so ``engine.convert`` maps the JAX
``reader_m`` / ``backbone_m`` / ``head_m`` trees and the int8 sites alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.voxelize import scatter_to_dense
from ..registry import BACKBONES, DETECTORS, HEADS, NECKS, READERS
from .detectors import build_submodule


@DETECTORS.register_module
class VoxelNet(nn.Module):
    def __init__(self, reader: dict = None, backbone: dict = None, pose_head: dict = None,
                 neck: Optional[dict] = None, grid_zyx: Tuple[int, int, int] = (40, 128, 128),
                 pretrained: Optional[str] = None):
        super().__init__()
        self.grid_zyx = tuple(int(g) for g in grid_zyx)
        self.reader = build_submodule(reader, READERS)
        width = getattr(self.reader, "num_input_features", None)
        self.backbone = build_submodule(
            backbone, BACKBONES, None if width is None else {"in_channels": width})
        self.neck = build_submodule(neck, NECKS)
        self.pose_head = build_submodule(pose_head, HEADS)

    def extract_feat(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        vf = self.reader(batch["voxels"], batch["num_points_per_voxel"])     # (B, V, C)
        dense = scatter_to_dense(vf, batch["coors"], batch["num_voxels"], self.grid_zyx)
        x = self.backbone(dense)
        return x if self.neck is None else self.neck(x)

    def forward(self, batch: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        return self.pose_head(self.extract_feat(batch))
