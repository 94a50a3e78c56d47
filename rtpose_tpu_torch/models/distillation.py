"""LiDAR -> radar cross-modal distillation.

Counterpart of ``rtpose_tpu/models/distillation.py`` (the reference ships
an empty stub, detectors/distillation.py:1-4): a LiDAR teacher
(``VoxelNet``) and a radar student (``RadarPoseNet``); ``forward`` runs both
and ``distill_loss`` is a feature L2 plus a heatmap term (the student's
heatmap logits under sigmoid BCE against the teacher's clipped sigmoid).
The feature term needs equal feature widths on both sides.

The caller freezes the teacher (``utils.freeze.split_frozen(..., ["teacher"])``):
its parameters then need no gradient and stay in no param group, so a step
leaves them bit-equal and autograd records nothing of the teacher's forward.
Module names: ``student`` / ``teacher`` (flax ``student_m`` / ``teacher_m``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import DETECTORS, build_from_cfg


@DETECTORS.register_module
class Distillation(nn.Module):
    def __init__(self, student: dict = None, teacher: dict = None,
                 feat_weight: float = 1.0, hm_weight: float = 1.0):
        super().__init__()
        self.student = build_from_cfg(dict(student), DETECTORS)
        self.teacher = build_from_cfg(dict(teacher), DETECTORS)
        self.feat_weight, self.hm_weight = feat_weight, hm_weight

    def forward(self, radar_batch: Dict[str, torch.Tensor],
                lidar_batch: Dict[str, torch.Tensor]):
        """Returns (student preds, teacher preds, student feature, teacher
        feature)."""
        s_feat = self.student.extract_feat(radar_batch["rdr_tensor"])
        s_preds = self.student.pose_head(s_feat)
        t_feat = self.teacher.extract_feat(lidar_batch)
        t_preds = self.teacher.pose_head(t_feat)
        return s_preds, t_preds, s_feat, t_feat

    def distill_loss(self, s_preds, t_preds, s_feat, t_feat) -> torch.Tensor:
        """Feature L2 + heatmap sigmoid BCE against the teacher, float32."""
        feat_l2 = torch.mean(torch.square(s_feat.float() - t_feat.float()))
        s_hm = s_preds[0]["hm"].float()
        t_hm = torch.clamp(torch.sigmoid(t_preds[0]["hm"].float()), 1e-4, 1 - 1e-4)
        bce = torch.mean(F.relu(s_hm) - s_hm * t_hm + torch.log1p(torch.exp(-s_hm.abs())))
        return self.feat_weight * feat_l2 + self.hm_weight * bce
