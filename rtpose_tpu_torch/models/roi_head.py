"""Two-stage RoI refinement head (PV-RCNN style).

Counterpart of ``rtpose_tpu/models/roi_head.py`` (reference
``det3d/models/roi_heads/roi_head.py:17-111``): pooled per-RoI features ->
shared FC stack -> class and box-residual branches; and the proposal-target
assignment (``target_assigner/proposal_target_layer.py``) as a function
over fixed-shape padded proposals.

Layers follow the flax modules: bias-free dense layers, flax's LayerNorm
(epsilon 1e-6, float32 statistics with the fast variance) and ReLU, then an
output dense layer with bias.  Module names are the flax ones
(``shared_fc0``, ``shared_ln0``, ``cls_fc0``, ``cls_ln0``, ``cls_out``,
``reg_*``), which ``engine.convert.state_dict_from_jax`` maps one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.nms import boxes_iou3d
from ..registry import ROI_HEAD
from .dcn_head import LayerNormNHWC


@ROI_HEAD.register_module
class RoIHead(nn.Module):
    # init std of the output layers' weights (flax normal initializers)
    FINAL_STD = {"cls": 0.01, "reg": 0.001}

    def __init__(self, input_channels: int = 256, shared_fc: Sequence[int] = (256, 256),
                 cls_fc: Sequence[int] = (256, 256), reg_fc: Sequence[int] = (256, 256),
                 num_class: int = 1, code_size: int = 7, dp_ratio: float = 0.0,
                 add_box_param: bool = False):
        super().__init__()
        self.add_box_param = add_box_param
        self.shared_fc, self.cls_fc, self.reg_fc = tuple(shared_fc), tuple(cls_fc), tuple(reg_fc)
        width = input_channels + (8 if add_box_param else 0)
        for i, w in enumerate(self.shared_fc):
            setattr(self, f"shared_fc{i}", nn.Linear(width, w, bias=False))
            setattr(self, f"shared_ln{i}", LayerNormNHWC(w))
            width = w
        for name, widths, out_dim in (("cls", self.cls_fc, num_class),
                                      ("reg", self.reg_fc, code_size)):
            w_in = width
            for i, w in enumerate(widths):
                setattr(self, f"{name}_fc{i}", nn.Linear(w_in, w, bias=False))
                setattr(self, f"{name}_ln{i}", LayerNormNHWC(w))
                w_in = w
            setattr(self, f"{name}_out", nn.Linear(w_in, out_dim))

    def _branch(self, x: torch.Tensor, name: str, widths) -> torch.Tensor:
        for i in range(len(widths)):
            x = torch.relu(getattr(self, f"{name}_ln{i}")(getattr(self, f"{name}_fc{i}")(x)))
        return getattr(self, f"{name}_out")(x)

    def forward(self, roi_features: torch.Tensor, rois: torch.Tensor = None,
                roi_scores: torch.Tensor = None):
        """roi_features: (B, N, C).  Returns dict(rcnn_cls (B, N, num_class),
        rcnn_reg (B, N, code_size))."""
        h = roi_features
        if self.add_box_param:
            h = torch.cat([h, rois, roi_scores[..., None]], dim=-1)
        for i in range(len(self.shared_fc)):
            h = torch.relu(getattr(self, f"shared_ln{i}")(getattr(self, f"shared_fc{i}")(h)))
        return dict(rcnn_cls=self._branch(h, "cls", self.cls_fc),
                    rcnn_reg=self._branch(h, "reg", self.reg_fc))


def assign_roi_targets(rois: torch.Tensor, roi_scores: torch.Tensor, gt_boxes: torch.Tensor,
                       num_gt, fg_thresh: float = 0.55, bg_thresh: float = 0.1):
    """Proposal-target assignment over fixed shapes: each padded RoI gets
    its best-IoU ground truth (the first of equal maxima), an fg (1) / bg
    (0) / ignore (-1) label, and the matched box as its regression target.

    rois: (N, 7); roi_scores: (N,); gt_boxes: (M, 7); num_gt: valid GT count.
    Returns dict(labels (N,) int32, target_boxes (N, 7), max_iou (N,)).
    """
    iou = boxes_iou3d(rois, gt_boxes)                           # (N, M)
    gt_valid = torch.arange(gt_boxes.shape[0], device=rois.device) < num_gt
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    best = torch.argmax(iou, dim=1)
    max_iou = torch.gather(iou, 1, best[:, None])[:, 0]
    one, zero, ign = (torch.full_like(best, v, dtype=torch.int32) for v in (1, 0, -1))
    labels = torch.where(max_iou >= fg_thresh, one, torch.where(max_iou < bg_thresh, zero, ign))
    return dict(labels=labels, target_boxes=gt_boxes[best], max_iou=max_iou)
