"""The port's kernels as ``torch.library`` custom ops, for ``torch.export``.

``torch.export`` cannot trace a ctypes call on a ``data_ptr``, so the
serving artifact (``export.py``) reaches the kernels through these ops:

* ``rtpose::preprocess(raw, roi, norm_start, norm_scale)`` — K1
  (``preprocess.fused_preprocess_batch``);
* ``rtpose::conv3d_k3(x, wr, bias)`` — K3 on ``conv_k3.prepare``d weights;
* ``rtpose::conv3d_k3_int8(xq, wk, scale, bias, out_dtype)`` — the int8 K3
  on ``conv_k3_int8.prepare``d weights;
* ``rtpose::conv3d_k3_grad_input(g, wr)`` — K3's grad-input launch on
  ``conv_k3.prepare_flipped`` weights (no artifact holds it: the wrappers
  launch through the ops while a dispatch mode is active, ``conv_k3``);
* ``rtpose::group_norm(x, weight, bias, groups, eps)`` — the GroupNorm
  kernel (``group_norm.launch``) on a bf16 (B, ..., C) input;
* ``rtpose::resize_trilinear(x, size, addend)`` — the trilinear resize
  kernel (``interpolate.launch``) on a bf16 (B, Z, Y, X, C) input, with the
  addend's epilogue (the wrapper writes a result meant for a channel slice
  with ``copy_``).

Each has a fake (meta) implementation for tracing and one for the CPU and
CUDA that is the kernel's wrapper, called with the mode off: the plain
version on a CPU tensor, the kernel (whose launch is counted) on a CUDA
one.  Importing ``rtpose_tpu_torch.ops`` registers them; a loaded artifact
needs nothing else of the package.

Importing it also registers the conv ops' formulas with
``torch.utils.flop_counter`` (two operations per multiply-add over the full
3x3x3 window) and one for ``torch._int_mm`` (2 M K N, the int8 stock
route's product), where PyTorch has none: so ``FlopCounterMode``
(``utils.flops.estimate_flops``) counts a conv the same whichever of its
routes ran.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.flop_counter import flop_registry, register_flop_formula

from . import conv_k3, conv_k3_int8, group_norm, interpolate, preprocess


_DEVICES = ("cpu", "cuda")


@torch.library.custom_op("rtpose::preprocess", mutates_args=(), device_types=_DEVICES)
def preprocess_op(raw: torch.Tensor, roi: List[int], norm_start: float,
                  norm_scale: float) -> torch.Tensor:
    return preprocess.fused_preprocess_batch(raw, roi, norm_start, norm_scale)


@preprocess_op.register_fake
def _(raw, roi, norm_start, norm_scale):
    z0, z1, y0, y1, x0, x1 = roi
    return raw.new_empty((raw.shape[0], z1 - z0 + 1, y1 - y0 + 1, x1 - x0 + 1, raw.shape[1]),
                         dtype=torch.float32)


@torch.library.custom_op("rtpose::conv3d_k3", mutates_args=(), device_types=_DEVICES)
def conv3d_k3_op(x: torch.Tensor, wr: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    return conv_k3.launch(x, wr, bias)


@conv3d_k3_op.register_fake
def _(x, wr, bias):
    return torch.empty_like(x, dtype=torch.bfloat16)


@torch.library.custom_op("rtpose::conv3d_k3_int8", mutates_args=(), device_types=_DEVICES)
def conv3d_k3_int8_op(xq: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    return conv_k3_int8.launch(xq, wk, scale, bias, out_dtype)


@conv3d_k3_int8_op.register_fake
def _(xq, wk, scale, bias, out_dtype):
    conv_k3_int8.check_prepared(wk)
    return torch.empty_like(xq, dtype=out_dtype)


@torch.library.custom_op("rtpose::conv3d_k3_grad_input", mutates_args=(),
                         device_types=_DEVICES)
def conv3d_k3_grad_input_op(g: torch.Tensor, wr: torch.Tensor) -> torch.Tensor:
    return conv_k3.launch_grad_input(g, wr)


@conv3d_k3_grad_input_op.register_fake
def _(g, wr):
    return torch.empty_like(g, dtype=torch.bfloat16)


@torch.library.custom_op("rtpose::group_norm", mutates_args=(), device_types=_DEVICES)
def group_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                  eps: float) -> torch.Tensor:
    return group_norm.launch(x, weight, bias, groups, eps)


@group_norm_op.register_fake
def _(x, weight, bias, groups, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op("rtpose::resize_trilinear", mutates_args=(), device_types=_DEVICES)
def resize_trilinear_op(x: torch.Tensor, size: List[int],
                        addend: Optional[torch.Tensor]) -> torch.Tensor:
    return interpolate.launch(x, size, addend)


@resize_trilinear_op.register_fake
def _(x, size, addend):
    return x.new_empty((x.shape[0], *size, x.shape[4]))


def _k3_flops(x_shape, *args, out_shape=None, **kwargs) -> int:
    return conv_k3.flops(x_shape)


def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


for _op, _formula in ((torch.ops.rtpose.conv3d_k3, _k3_flops),
                      (torch.ops.rtpose.conv3d_k3_grad_input, _k3_flops),
                      (torch.ops.rtpose.conv3d_k3_int8, _k3_flops),
                      (torch.ops.aten._int_mm, _int_mm_flops)):
    if _op not in flop_registry:    # a later PyTorch may count _int_mm itself
        register_flop_formula(_op)(_formula)
