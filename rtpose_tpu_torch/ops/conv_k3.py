"""Stride-1 3x3x3 conv, 32 -> 32 channels, channels-last bf16.

Counterpart of ``rtpose_tpu/ops/pallas_conv.py`` (the Pallas kernel K3,
``_pallas_forward``): the CUDA kernel ``csrc/conv_k3.cu`` computes the same
conv on the unfolded (B, Z, Y, X, 32) layout, with float32 accumulation and
one rounding to bf16.  ``models.layers.TorchConv3d`` dispatches every CUDA
bf16 conv of this shape here.

The backward (``_fused_bwd``, ``pallas_conv.py:211-225``) is ``Conv3dK3``:
grad-input is the same kernel on the flipped, channel-transposed weights
(``_flip_transpose``, ``:197-199``), as on the TPU; grad-weight is the
library's conv weight-gradient (bf16 operands, float32 accumulation), where
the JAX package used XLA's.

* ``conv3d_k3`` — the kernel's wrapper on torch-layout weights.  A CUDA
  tensor launches the kernel (or raises on what it does not take); a CPU
  tensor takes the plain version.
* ``prepare`` + ``launch`` — the same launch split in two: ``prepare``
  re-lays torch-layout (Co, Ci, 3, 3, 3) weights to the kernel's
  (27, 32, 32) [tap][ci][co] bf16 and the bias to float32, once;
  ``launch`` runs the kernel on them (``TorchConv3d`` keeps the prepared
  weights between calls).
* ``conv3d_k3_reference`` — the plain version: ``F.conv3d`` in float32 on
  the bf16-rounded operands, bias added in float32, rounded to bf16.
* ``Conv3dK3`` — the autograd Function over the kernel; ``grad_input`` /
  ``grad_weight`` are its two backward halves (a CPU tensor takes the plain
  versions: ``conv3d_k3_reference`` on the flipped weights, and the float32
  weight-gradient of ``F.conv3d`` on bf16-rounded operands).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

C = 32

# kernel launches since the last reset (ops.reset_launch_counts): the
# forward conv, and the grad-input conv of the backward
launches = 0
launches_bwd = 0


def supports(x: torch.Tensor, w: torch.Tensor, stride: int) -> bool:
    """The shape and dtype the kernel is for (the dispatch rule)."""
    return (x.dtype == torch.bfloat16 and stride == 1
            and tuple(w.shape) == (C, C, 3, 3, 3) and x.dim() == 5
            and x.shape[-1] == C)


def conv3d_k3_reference(x: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: (B, Z, Y, X, 32) -> (B, Z, Y, X, 32) bf16."""
    xf = x.to(torch.bfloat16).float().permute(0, 4, 1, 2, 3)
    wf = w.to(torch.bfloat16).float()
    out = F.conv3d(xf, wf, None if bias is None else bias.float(), padding=1)
    return out.permute(0, 2, 3, 4, 1).to(torch.bfloat16).contiguous()


def prepare(w: torch.Tensor, bias: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(Co, Ci, 3, 3, 3) weights, (Co,) bias -> the kernel's (27, 32, 32)
    bf16 weights and float32 bias."""
    wr = w.detach().to(torch.bfloat16).permute(2, 3, 4, 1, 0).reshape(27, C, C)
    return wr.contiguous(), None if bias is None else bias.detach().float().contiguous()


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """Torch-layout weights of the grad-input conv: the three taps flipped,
    Ci and Co swapped (``_flip_transpose``, pallas_conv.py:197-199)."""
    return w.flip((2, 3, 4)).transpose(0, 1)


def prepare_flipped(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) weights -> the kernel's (27, 32, 32) bf16 layout of
    their ``flip_transpose``: the weights of the grad-input launch."""
    return prepare(flip_transpose(w))[0]


def conv3d_k3(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Z, Y, X, 32) bf16 -> (B, Z, Y, X, 32) bf16, zero padding 1."""
    if x.device.type == "cpu":
        return conv3d_k3_reference(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_k3: unsupported device {x.device}")
    if not supports(x, w, 1):
        raise ValueError(f"conv3d_k3: needs (B, Z, Y, X, 32) bf16 and (32, 32, 3, 3, 3) "
                         f"weights, got {tuple(x.shape)} {x.dtype}, {tuple(w.shape)}")
    return launch(x, *prepare(w, bias))


def launch(x: torch.Tensor, wr: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on a CUDA (B, Z, Y, X, 32) bf16 input with ``prepare``d
    weights and bias (the forward conv)."""
    global launches
    out = _run(x, wr, bias)
    launches += 1
    return out


def _run(x: torch.Tensor, wr: torch.Tensor,
         bias: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 5 \
            or x.shape[-1] != C:
        raise ValueError(f"conv3d_k3: needs a CUDA (B, Z, Y, X, 32) bf16 input, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3d_k3: input must be contiguous and 16-byte aligned")
    if (tuple(wr.shape) != (27, C, C) or wr.dtype != torch.bfloat16
            or not wr.is_contiguous()):
        raise ValueError(f"conv3d_k3: weights must be prepared (27, 32, 32) bf16, "
                         f"got {tuple(wr.shape)} {wr.dtype}")
    if bias is not None and (tuple(bias.shape) != (C,) or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f"conv3d_k3: bias must be prepared ({C},) float32, "
                         f"got {tuple(bias.shape)} {bias.dtype}")
    if wr.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("conv3d_k3: weights and bias must be on the input's device")
    B, Z, Y, X, _ = x.shape
    if B * Z > 65535:
        raise ValueError("conv3d_k3: B * Z exceeds the launch grid")
    out = torch.empty_like(x)
    rc = build.kernel("conv_k3")(
        x.data_ptr(), wr.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), B, Z, Y, X,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "conv3d_k3 kernel")
    return out


def grad_input(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d(loss)/dx of the conv from the output gradient ``g`` (B, Z, Y, X, 32)
    and the torch-layout weights: the same conv on ``flip_transpose(w)``,
    bf16 in and out.  A CUDA tensor launches the kernel, a CPU tensor takes
    the plain version."""
    global launches_bwd
    g = g.to(torch.bfloat16).contiguous()
    if g.device.type == "cpu":
        return conv3d_k3_reference(g, flip_transpose(w))
    out = _run(g, prepare_flipped(w), None)
    launches_bwd += 1
    return out


def grad_weight(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d(loss)/dw, float32 in the layout and dtype of ``w``, from the bf16
    input ``x`` and output gradient ``g`` (both (B, Z, Y, X, 32)).  On the
    card the library's bf16 weight-gradient (float32 accumulation, the role
    XLA had in the JAX package); on the CPU the same in float32 on the
    bf16-rounded operands."""
    xc = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    gc = g.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    wc = w.detach().to(torch.bfloat16)
    if x.device.type == "cpu":
        xc, gc, wc = xc.float(), gc.float(), wc.float()
    gw = torch.ops.aten.convolution_backward(
        gc, xc, wc, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
        [False, True, False])[1]
    return gw.to(w.dtype).contiguous()


class Conv3dK3(torch.autograd.Function):
    """The k3/s1/32->32 conv with its backward: ``apply(x, weight, bias)``,
    ``x`` (B, Z, Y, X, 32) bf16, torch-layout float32 ``weight`` (cast to
    bf16 inside, so the parameter receives a float32 gradient), optional
    ``bias``.  Saves ``x`` and ``weight``; the backward returns the bf16
    grad-input (kernel), the float32 grad-weight and grad-bias."""

    @staticmethod
    def forward(ctx, x, weight, bias=None):
        if x.device.type == "cpu":
            out = conv3d_k3_reference(x, weight, bias)
        else:
            if not supports(x, weight, 1):
                raise ValueError(f"Conv3dK3: needs (B, Z, Y, X, 32) bf16 and (32, 32, 3, 3, 3) "
                                 f"weights, got {tuple(x.shape)} {x.dtype}, {tuple(weight.shape)}")
            out = launch(x, *prepare(weight, bias))
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(torch.bfloat16).contiguous()
        gx = grad_input(g, weight) if ctx.needs_input_grad[0] else None
        gw = grad_weight(x, g, weight) if ctx.needs_input_grad[1] else None
        gb = (g.float().sum((0, 1, 2, 3))
              if ctx.has_bias and ctx.needs_input_grad[2] else None)
        return gx, gw, gb
