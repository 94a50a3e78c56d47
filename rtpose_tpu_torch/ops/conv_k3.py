"""Stride-1 3x3x3 conv, 32 -> 32 channels, channels-last bf16.

Counterpart of ``rtpose_tpu/ops/pallas_conv.py`` (the Pallas kernel K3,
``_pallas_forward``): the CUDA kernel ``csrc/conv_k3.cu`` computes the same
conv on the unfolded (B, Z, Y, X, 32) layout, with float32 accumulation and
one rounding to bf16.  ``models.layers.TorchConv3d`` dispatches every CUDA
bf16 conv of this shape here.

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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

C = 32

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0


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
    weights and bias."""
    global launches
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
    launches += 1
    return out
