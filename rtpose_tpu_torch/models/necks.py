"""Necks: the SECOND-style RPN 2-D conv pyramid.

Counterpart of ``rtpose_tpu/models/necks.py`` (reference
``det3d/models/necks/rpn.py:22-160``): downsample blocks (a padded 3x3
strided conv, then ``layer_nums[i]`` 3x3 convs, each with BatchNorm and
ReLU) and upsample deblocks (a transposed conv for a stride above 1, a
strided conv below), their outputs concatenated on channels.

Channels-last like the flax module: (B, H, W, C) in and out.  A 5-D input
(B, Z, H, W, C), the radar backbone's feature, runs as flax's 2-D
``nn.Conv`` runs it: (B, Z) is the batch, so the neck is a per-Z-plane 2-D
RPN whose BatchNorm reduces over B, Z, H and W; Z is folded into the batch
and unfolded after.

BatchNorm is flax's, not ``torch.nn.BatchNorm2d`` (``BatchNormNHWC``):
``momentum=0.99`` (running = 0.99 * running + 0.01 * batch), epsilon 1e-3,
float32 statistics, the fast variance E[x^2] - E[x]^2 clipped at 0, and the
running variance updated with that *biased* batch variance
(``BatchNorm2d`` would use the unbiased one).  ``train=False``, the
default, normalizes with the running statistics: the detectors call the
neck so, as the JAX detectors do.  ``sync_bn_axis`` (any name) sums the
batch statistics over the ranks of the process group
(``parallel.all_reduce_sum_``) when there is more than one, as flax's
``axis_name`` does with ``pmean``; the sum is differentiable.

Module names are the flax ones (``block{i}_conv{j}``, ``block{i}_bn{j}``,
``deblock{k}_deconv`` / ``deblock{k}_conv``, ``deblock{k}_bn``).  The
transposed conv's weight is ``ConvTranspose2d``'s (Ci, Co, s, s): flax's
``nn.ConvTranspose`` (kernel (s, s, Ci, Co), stride s, 'SAME', no kernel
flip) writes output pixel i * s + r from kernel tap s - 1 - r, so the flax
kernel maps onto it spatially flipped (``engine.convert``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import parallel
from ..registry import NECKS


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its transpose (the backward) is the same sum."""

    @staticmethod
    def forward(ctx, x):
        return parallel.all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return parallel.all_reduce_sum_(g.clone())


class BatchNormNHWC(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis of a (..., C) tensor, in
    float32 (see the module docstring)."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-3,
                 sync: bool = False):
        super().__init__()
        self.momentum, self.eps, self.sync = momentum, eps, sync
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            dims = tuple(range(xf.dim() - 1))
            stats = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
            if self.sync and parallel.process_count() > 1:
                stats = _AllReduceSum.apply(stats) / parallel.process_count()
            mean = stats[0]
            var = torch.clamp(stats[1] - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * mul + self.bias


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """'SAME' padding of an (N, C, H, W) input for a k x k conv of stride s."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


@NECKS.register_module
class RPN(nn.Module):
    def __init__(self, layer_nums: Sequence[int] = (3, 5, 5),
                 ds_layer_strides: Sequence[int] = (2, 2, 2),
                 ds_num_filters: Sequence[int] = (128, 128, 256),
                 us_layer_strides: Sequence[float] = (1, 2, 4),
                 us_num_filters: Sequence[int] = (256, 256, 256),
                 num_input_features: int = 128, dtype: Optional[str] = None,
                 sync_bn_axis: Optional[str] = None):
        super().__init__()
        assert len(ds_layer_strides) == len(layer_nums)
        assert len(ds_num_filters) == len(layer_nums)
        assert len(us_num_filters) == len(us_layer_strides)
        self.layer_nums = tuple(int(n) for n in layer_nums)
        self.ds_layer_strides = tuple(int(s) for s in ds_layer_strides)
        self.us_layer_strides = tuple(us_layer_strides)
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.up_start = len(self.layer_nums) - len(self.us_layer_strides)
        sync = sync_bn_axis is not None
        width = int(num_input_features)
        for i, n_layers in enumerate(self.layer_nums):
            c = int(ds_num_filters[i])
            for j in range(n_layers + 1):
                setattr(self, f"block{i}_conv{j}", nn.Conv2d(width if j == 0 else c, c, 3,
                                                             bias=False))
                setattr(self, f"block{i}_bn{j}", BatchNormNHWC(c, sync=sync))
            width = c
            k = i - self.up_start
            if k >= 0:
                stride, co = self.us_layer_strides[k], int(us_num_filters[k])
                if stride > 1:
                    setattr(self, f"deblock{k}_deconv",
                            nn.ConvTranspose2d(c, co, int(stride), stride=int(stride),
                                               bias=False))
                else:
                    s = int(round(1 / stride))
                    setattr(self, f"deblock{k}_conv", nn.Conv2d(c, co, s, stride=s, bias=False))
                setattr(self, f"deblock{k}_bn", BatchNormNHWC(co, sync=sync))

    @property
    def downsample_factor(self) -> int:
        factor = int(np.prod(self.ds_layer_strides))
        if len(self.us_layer_strides) > 0:
            factor //= int(self.us_layer_strides[-1])
        return max(factor, 1)

    def _conv(self, x: torch.Tensor, conv: nn.Module, stride: int, padding) -> torch.Tensor:
        """A bias-free flax conv on (N, C, H, W): computes in ``dtype`` if
        given, else in the promotion of the input's and float32."""
        dt = self.dtype or torch.promote_types(x.dtype, conv.weight.dtype)
        x, w = x.to(dt), conv.weight.to(dt)
        if isinstance(conv, nn.ConvTranspose2d):
            return F.conv_transpose2d(x, w, stride=stride)
        if padding == "same":
            return F.conv2d(_same_pad(x, w.shape[-1], stride), w, stride=stride)
        return F.conv2d(x, w, stride=stride, padding=padding)

    def _bn_relu(self, x: torch.Tensor, bn: BatchNormNHWC, train: bool) -> torch.Tensor:
        """BatchNorm over channels of an (N, C, H, W) tensor, then ReLU."""
        return torch.relu(bn(x.permute(0, 2, 3, 1), train).permute(0, 3, 1, 2))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)     # (N, C, H, W)
        ups = []
        for i, n_layers in enumerate(self.layer_nums):
            for j in range(n_layers + 1):
                x = self._conv(x, getattr(self, f"block{i}_conv{j}"),
                               self.ds_layer_strides[i] if j == 0 else 1, 1)
                x = self._bn_relu(x, getattr(self, f"block{i}_bn{j}"), train)
            k = i - self.up_start
            if k >= 0:
                stride = self.us_layer_strides[k]
                if stride > 1:
                    h = self._conv(x, getattr(self, f"deblock{k}_deconv"), int(stride), 0)
                else:
                    h = self._conv(x, getattr(self, f"deblock{k}_conv"),
                                   int(round(1 / stride)), "same")
                ups.append(self._bn_relu(h, getattr(self, f"deblock{k}_bn"), train))
        if ups:
            x = torch.cat(ups, dim=1)
        x = x.permute(0, 2, 3, 1)
        return x.reshape(*lead, *x.shape[1:])
