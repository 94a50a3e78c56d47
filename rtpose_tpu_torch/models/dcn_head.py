"""Deformable-conv pose head (``dcn_head=True``).

Counterpart of ``rtpose_tpu/models/dcn_head.py`` (reference
``center_head.py:24-163``):

* ``FeatureAdaption`` — a 1x1 conv, zero-initialized, predicts the
  offsets; a ``DeformConv2d`` applies them; ReLU.
* ``DCNSepHead`` — separate feature adaptions for the heatmap and the
  regression; the heatmap head is conv -> LayerNorm -> ReLU -> conv with the
  -2.19 bias, the regression a regular ``SepHead``.

The modules are 2-D: a (B, Z, Y, X, C) input folds Z into the batch around
them and unfolds after.  Dtypes follow the flax modules: the offset conv and
the heatmap convs are flax ``nn.Conv`` without a ``dtype``, so they compute
in float32 (bf16 features promote against float32 parameters); the
deformable conv casts its weights to the features' dtype
(``ops.deform_conv``); the LayerNorm is flax's (epsilon 1e-6, statistics in
float32 as E[x^2] - E[x]^2 clipped at 0).

Span ``dcn.offset`` (``utils.trace``) covers each branch's offset conv; the
deformable conv's own spans and counters are ``ops.deform_conv``'s.

Parameter names are the flax ones (``feature_adapt_cls.conv_offset``,
``.conv_adaption``, ``cls_conv0``, ``cls_norm``, ``cls_out``,
``task_head.reg.{0,2}``), which ``engine.convert.state_dict_from_jax`` maps
one to one; 2-D kernels are torch-layout (Cout, Cin, kh, kw).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import deform_conv2d
from ..utils import trace
from .center_head import SepHead


class Conv2dNHWC(nn.Module):
    """flax ``nn.Conv`` (no ``dtype``) on (N, H, W, C): computes in the
    promotion of the input's and the parameters' dtypes, 'SAME' padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        k = self.weight.shape[-1]
        out = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), self.bias.to(dt),
                       padding=k // 2)
        return out.permute(0, 2, 3, 1)


class LayerNormNHWC(nn.Module):
    """flax ``nn.LayerNorm`` over the channel axis: float32 statistics with
    the fast variance, epsilon 1e-6, output in the promoted dtype."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * mul + self.bias


class DeformConv2d(nn.Module):
    """Deformable conv v1 with offsets supplied by the caller, no bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 padding: int = 1, deformable_groups: int = 4):
        super().__init__()
        self.padding = padding
        self.deformable_groups = deformable_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        w = self.weight.permute(2, 3, 1, 0).to(x.dtype)      # (kh, kw, Cin, Cout)
        return deform_conv2d(x, offset, w, padding=self.padding,
                             deformable_groups=self.deformable_groups)


class FeatureAdaption(nn.Module):
    def __init__(self, channels: int, kernel: int = 3, deformable_groups: int = 4):
        super().__init__()
        self.conv_offset = Conv2dNHWC(channels, deformable_groups * kernel * kernel * 2, 1)
        self.conv_adaption = DeformConv2d(channels, channels, kernel, (kernel - 1) // 2,
                                          deformable_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("dcn.offset"):
            offset = self.conv_offset(x)
        return F.relu(self.conv_adaption(x, offset))


class DCNSepHead(nn.Module):
    """Deformable separate head on (B, Z, Y, X, C) or (B, H, W, C)."""

    def __init__(self, in_channels: int, num_cls: int, heads: Dict[str, Tuple[int, int]],
                 head_conv: int = 64, final_kernel: int = 3, init_bias: float = -2.19,
                 dtype=None):
        super().__init__()
        self.init_bias = init_bias
        self.feature_adapt_cls = FeatureAdaption(in_channels)
        self.feature_adapt_reg = FeatureAdaption(in_channels)
        self.cls_conv0 = Conv2dNHWC(in_channels, head_conv, 3)
        self.cls_norm = LayerNormNHWC(head_conv)
        self.cls_out = Conv2dNHWC(head_conv, num_cls, 3)
        self.task_head = SepHead(in_channels, heads, head_conv=head_conv,
                                 final_kernel=final_kernel, init_bias=init_bias, dtype=dtype)

    def set_final_dtype(self, final_dtype) -> None:
        """No-op: the JAX package's serving override does not reach the
        deformable head (``CenterHead`` builds it without ``final_dtype``)."""

    def forward(self, x: torch.Tensor, branch: Optional[str] = None,
                inner_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if branch is not None or inner_mask is not None:
            raise ValueError("the deformable head has no branch-routed (sparse) form")
        is_3d = x.dim() == 5
        if is_3d:
            B, Z, Y, X, C = x.shape
            x = x.reshape(B * Z, Y, X, C)
        center_feat = self.feature_adapt_cls(x)
        reg_feat = self.feature_adapt_reg(x)
        h = F.relu(self.cls_norm(self.cls_conv0(center_feat)))
        cls_score = self.cls_out(h)
        if is_3d:
            reg_feat = reg_feat.reshape(B, Z, Y, X, -1)
            cls_score = cls_score.reshape(B, Z, Y, X, -1)
        ret = self.task_head(reg_feat)
        ret["hm"] = cls_score
        return ret
