"""Detector composition: reader -> backbone -> [neck] -> pose head.

Counterpart of ``rtpose_tpu/models/detectors.py::RadarPoseNet`` (reference
``radar_pose_net.py:10-46``): identity reader over the dense radar cube,
HRNet3D backbone, CenterHead.  Inputs are (B, Z, Y, X, C) channels-last
cubes, heatmaps come back (B, Z, Y, X, C) — the JAX package's layouts.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ..core.decode import flat_argmax
from ..registry import BACKBONES, DETECTORS, HEADS, NECKS, READERS, build_from_cfg
from ..utils import trace
from .center_head import SepHead
from .dcn_head import Conv2dNHWC, DCNSepHead, DeformConv2d, FeatureAdaption, LayerNormNHWC
from .layers import GroupNorm8, TorchConv3d
from .necks import BatchNormNHWC
from .roi_head import RoIHead


def build_submodule(cfg, registry, extra: dict | None = None):
    if cfg is None:
        return None
    cfg = dict(cfg)
    if extra:
        cfg.update(extra)
    return build_from_cfg(cfg, registry)


def _window(center: torch.Tensor, size: int):
    """Positions center-2..center+2 clamped into [0, size) and their
    in-volume mask: (B, 5) each."""
    pos = center[:, None] - 2 + torch.arange(5, device=center.device)
    return pos.clamp(0, size - 1), (pos >= 0) & (pos < size)


@DETECTORS.register_module
class RadarPoseNet(nn.Module):
    """HRRadarPose detector over a dense (B, Z, Y, X, C) radar cube."""

    def __init__(self, reader: dict = None, backbone: dict = None,
                 pose_head: dict = None, neck: Optional[dict] = None,
                 pretrained: Optional[str] = None):
        super().__init__()
        self.reader = build_submodule(reader, READERS)
        self.backbone = build_submodule(backbone, BACKBONES)
        self.neck = build_submodule(neck, NECKS)
        self.pose_head = build_submodule(pose_head, HEADS)

    def extract_feat(self, rdr_tensor: torch.Tensor) -> torch.Tensor:
        """Reader, backbone and the neck if any; the neck normalizes with its
        running statistics (the JAX detector calls it without ``train``)."""
        x = self.backbone(self.reader(rdr_tensor))
        return x if self.neck is None else self.neck(x)

    def forward(self, rdr_tensor: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        return self.pose_head(self.extract_feat(rdr_tensor))

    def forward_sparse_train(self, rdr_tensor: torch.Tensor, ind: torch.Tensor):
        """Training forward with the reg tower evaluated only at the target
        indices ``ind`` (B, M) (detectors.py:66-88): the reg loss gathers
        there, so loss and gradients equal the dense step's.

        Returns (hm (B, Z, Y, X, C) logits, reg_at_ind (B, M, D)).
        """
        feat = self.extract_feat(rdr_tensor)
        hm = self.pose_head(feat, branch="hm")[0]["hm"]
        B, Z, Y, X, _ = hm.shape
        M = ind.shape[1]
        flat = ind.reshape(B * M).long()
        feat_rep = feat.repeat_interleave(M, dim=0) if M > 1 else feat
        reg = self._reg_patches(feat_rep, flat // (Y * X), (flat % (Y * X)) // X,
                                flat % X, (Z, Y, X))
        return hm, reg.reshape(B, M, -1)

    def _reg_patches(self, feat: torch.Tensor, z, y, x, zyx) -> torch.Tensor:
        """Reg-tower values at voxel coords (B,) via 5^3 receptive-field
        patches: the head's two 3x3x3 convs see exactly the 5^3 cube around
        a voxel, with zeros outside the volume (detectors.py:90-144)."""
        Z, Y, X = zyx
        B = feat.shape[0]
        if min(Z, Y, X) < 5:
            # grid smaller than the receptive field: dense reg + gather
            reg = self.pose_head(feat, branch="reg")[0]["reg"]
            flat = (z * Y + y) * X + x
            dense = reg.reshape(B, -1, reg.shape[-1])
            return dense[torch.arange(B, device=feat.device), flat]
        pz, mz = _window(z, Z)
        py, my = _window(y, Y)
        px, mx = _window(x, X)
        bi = torch.arange(B, device=feat.device)[:, None, None, None]
        patches = feat[bi, pz[:, :, None, None], py[:, None, :, None],
                       px[:, None, None, :]]                     # (B, 5, 5, 5, C)
        mask = (mz[:, :, None, None] & my[:, None, :, None]
                & mx[:, None, None, :])[..., None].to(feat.dtype)
        reg_p = self.pose_head(patches * mask, branch="reg",
                               inner_mask=mask)[0]["reg"]
        return reg_p[:, 2, 2, 2, :]

    def predict_sparse(self, rdr_tensor: torch.Tensor):
        """Sparse single-peak inference: dense heatmap, reg tower evaluated
        only on the 5^3 patch around each sample's heatmap peak.

        Returns (hm (B, Z, Y, X, C) logits, reg_at_peak (B, D), peak_ind (B,)).
        """
        with trace.span("predict.backbone"):
            feat = self.extract_feat(rdr_tensor)
        with trace.span("predict.hm"):
            hm = self.pose_head(feat, branch="hm")[0]["hm"]
            B, Z, Y, X, C = hm.shape
            flat = flat_argmax(hm.reshape(B, -1, C)[..., 0])        # pelvis class
            z = flat // (Y * X)
            y = (flat % (Y * X)) // X
            x = flat % X
        with trace.span("predict.reg"):
            reg = self._reg_patches(feat, z, y, x, (Z, Y, X))
        return hm, reg, flat


def build_detector(cfg: dict):
    """Build a detector from a ``model`` config dict."""
    return build_from_cfg(dict(cfg), DETECTORS)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random initialization: He-normal conv and dense kernels (fan-in), zero
    biases except the heatmap output's ``init_bias``, unit GroupNorm,
    LayerNorm and BatchNorm scales (BatchNorm's running statistics at 0 and
    1); the deformable head's offset convs start at zero, so it starts as a
    plain conv (reference center_head.py:56-57); the RoI head's output
    layers are normal with its ``FINAL_STD``.  Draws happen on the CPU from
    ``generator`` in module order."""
    offset_convs = {m.conv_offset for m in model.modules() if isinstance(m, FeatureAdaption)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (TorchConv3d, Conv2dNHWC, DeformConv2d, nn.Linear, nn.Conv2d,
                              nn.ConvTranspose2d)):
                if m in offset_convs:
                    m.weight.zero_()
                else:
                    fan_in = m.weight[0].numel()
                    w = torch.randn(m.weight.shape, generator=generator) * (2.0 / fan_in) ** 0.5
                    m.weight.copy_(w)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, (GroupNorm8, LayerNormNHWC, BatchNormNHWC)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNormNHWC):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
        for m in model.modules():
            if isinstance(m, SepHead) and "hm" in m.heads:
                m.hm[-1].bias.fill_(m.init_bias)
            elif isinstance(m, DCNSepHead):
                m.cls_out.bias.fill_(m.init_bias)
            elif isinstance(m, RoIHead):
                for name, std in m.FINAL_STD.items():
                    out = getattr(m, f"{name}_out")
                    out.weight.copy_(torch.randn(out.weight.shape, generator=generator) * std)
    return model
