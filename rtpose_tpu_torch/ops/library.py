"""The port's kernels as ``torch.library`` custom ops, for ``torch.export``.

``torch.export`` cannot trace a ctypes call on a ``data_ptr``, so the
serving artifact (``export.py``) reaches the kernels through these ops:

* ``rtpose::preprocess(raw, roi, norm_start, norm_scale)`` — K1
  (``preprocess.fused_preprocess_batch``);
* ``rtpose::conv3d_k3(x, wr, bias)`` — K3 on ``conv_k3.prepare``d weights;
* ``rtpose::conv3d_k3_int8(xq, wk, scale, bias, out_dtype)`` — the int8 K3
  on ``conv_k3_int8.prepare``d weights.

Each has a fake (meta) implementation for tracing, a CUDA implementation
that calls the kernel's wrapper (which counts the launch), and a CPU
implementation that is the kernel's plain version.  Importing
``rtpose_tpu_torch.ops`` registers them; a loaded artifact needs nothing
else of the package.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import conv_k3, conv_k3_int8, preprocess


@torch.library.custom_op("rtpose::preprocess", mutates_args=(), device_types="cpu")
def preprocess_op(raw: torch.Tensor, roi: List[int], norm_start: float,
                  norm_scale: float) -> torch.Tensor:
    return preprocess.preprocess_reference(raw, roi, norm_start, norm_scale)


@preprocess_op.register_kernel("cuda")
def _(raw, roi, norm_start, norm_scale):
    return preprocess.fused_preprocess_batch(raw, roi, norm_start, norm_scale)


@preprocess_op.register_fake
def _(raw, roi, norm_start, norm_scale):
    z0, z1, y0, y1, x0, x1 = roi
    return raw.new_empty((raw.shape[0], z1 - z0 + 1, y1 - y0 + 1, x1 - x0 + 1, raw.shape[1]),
                         dtype=torch.float32)


@torch.library.custom_op("rtpose::conv3d_k3", mutates_args=(), device_types="cpu")
def conv3d_k3_op(x: torch.Tensor, wr: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    return conv_k3.conv3d_k3_reference(x, conv_k3.unprepare(wr), bias)


@conv3d_k3_op.register_kernel("cuda")
def _(x, wr, bias):
    return conv_k3.launch(x, wr, bias)


@conv3d_k3_op.register_fake
def _(x, wr, bias):
    return torch.empty_like(x, dtype=torch.bfloat16)


@torch.library.custom_op("rtpose::conv3d_k3_int8", mutates_args=(), device_types="cpu")
def conv3d_k3_int8_op(xq: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    return conv_k3_int8.conv3d_k3_int8_reference(xq, conv_k3_int8.unprepare(wk), scale, bias,
                                                 out_dtype)


@conv3d_k3_int8_op.register_kernel("cuda")
def _(xq, wk, scale, bias, out_dtype):
    return conv_k3_int8.launch(xq, wk, scale, bias, out_dtype)


@conv3d_k3_int8_op.register_fake
def _(xq, wk, scale, bias, out_dtype):
    conv_k3_int8._check_prepared(wk)
    return torch.empty_like(xq, dtype=out_dtype)
