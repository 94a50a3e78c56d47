"""Int8 stride-1 3x3x3 conv, 32 -> 32 channels, channels-last.

Not a port of a TPU kernel: the JAX package runs its int8 convs on XLA's
int8 convolutions (``rtpose_tpu/ops/quant.py::conv3d_int8``), and PyTorch
has no int8 ``conv3d`` on CUDA.  The stock route (an int8 im2col and
``torch._int_mm``) writes and reads back a 27x im2col, so the K3 shape,
which carries most of the flagship's operations, gets this hand kernel,
``csrc/conv_k3_int8.cu``: int8 ``mma.sync`` over a shared-memory halo tile
with the weights resident in shared memory, an exact int32 accumulator and
the float32 epilogue ``acc * scale[co] (+ bias[co])`` of
``ops/quant.py``, rounded once to the output dtype.  The kernel equals its
plain version bit for bit.

* ``conv3d_k3_int8`` — the wrapper on int8 torch-layout weights.  A CUDA
  tensor launches the kernel (or raises on what it does not take); a CPU
  tensor takes the plain version.
* ``prepare`` + ``launch`` — the same split in two: ``prepare`` re-lays
  (32, 32, 3, 3, 3) int8 weights to the kernel's (27, 32, 32)
  [kz * 9 + ky * 3 + kx][co][ci] int8, once; ``launch`` runs the kernel on
  them.  ``unprepare`` is its inverse.
* ``conv3d_k3_int8_reference`` — the plain version: ``F.conv3d`` in float64
  on the int8 values (exact), cast to int32, then the epilogue.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import build

C = 32
TILE = (2, 16, 16)       # output voxels (z, y, x) of one tile of the kernel
BLOCKS_PER_SM = 2        # 69,120 B of shared memory and 256 threads each

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0

_OUT_CODE = {torch.bfloat16: 0, torch.float32: 1}


def supports_weight(wq: torch.Tensor, stride: int) -> bool:
    """The weight shape and stride the kernel is for."""
    return stride == 1 and tuple(wq.shape) == (C, C, 3, 3, 3)


def prepare(wq: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) int8 -> the kernel's (27, Co, Ci) int8, taps
    ``kz * 9 + ky * 3 + kx``."""
    return wq.detach().to(torch.int8).permute(2, 3, 4, 0, 1).reshape(27, C, C).contiguous()


def unprepare(wk: torch.Tensor) -> torch.Tensor:
    """The inverse of ``prepare``: (27, Co, Ci) -> (Co, Ci, 3, 3, 3)."""
    return wk.reshape(3, 3, 3, C, C).permute(3, 4, 0, 1, 2).contiguous()


def conv3d_k3_int8_reference(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: (B, Z, Y, X, 32) int8 -> (B, Z, Y, X, 32) ``out_dtype``."""
    acc = F.conv3d(xq.permute(0, 4, 1, 2, 3).double(), wq.double(), padding=1)
    out = acc.permute(0, 2, 3, 4, 1).to(torch.int32).float() * scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype).contiguous()


def conv3d_k3_int8(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, Z, Y, X, 32) int8, (32, 32, 3, 3, 3) int8 weights, (32,) float32
    ``scale`` (``sw * act_scale``), optional (32,) float32 bias -> (B, Z, Y,
    X, 32) ``out_dtype`` (bf16 or float32), zero padding 1."""
    if xq.device.type == "cpu":
        return conv3d_k3_int8_reference(xq, wq, scale, bias, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"conv3d_k3_int8: unsupported device {xq.device}")
    if not supports_weight(wq, 1) or wq.dtype != torch.int8:
        raise ValueError(f"conv3d_k3_int8: needs (32, 32, 3, 3, 3) int8 weights, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    return launch(xq, prepare(wq), scale, bias, out_dtype)


def launch(xq: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel on a CUDA (B, Z, Y, X, 32) int8 input with ``prepare``d
    weights."""
    global launches
    out = _run(xq, wk, scale, bias, out_dtype)
    launches += 1
    return out


def _check_vec(name: str, t: torch.Tensor, dev) -> None:
    if (tuple(t.shape) != (C,) or t.dtype != torch.float32 or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"conv3d_k3_int8: {name} must be a contiguous ({C},) float32 "
                         f"tensor on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _run(xq, wk, scale, bias, out_dtype) -> torch.Tensor:
    if (xq.device.type != "cuda" or xq.dtype != torch.int8 or xq.dim() != 5
            or xq.shape[-1] != C):
        raise ValueError(f"conv3d_k3_int8: needs a CUDA (B, Z, Y, X, 32) int8 input, got "
                         f"{tuple(xq.shape)} {xq.dtype} on {xq.device}")
    if not xq.is_contiguous() or xq.data_ptr() % 16:
        raise ValueError("conv3d_k3_int8: input must be contiguous and 16-byte aligned")
    if (tuple(wk.shape) != (27, C, C) or wk.dtype != torch.int8 or not wk.is_contiguous()
            or wk.data_ptr() % 16 or wk.device != xq.device):
        raise ValueError(f"conv3d_k3_int8: weights must be prepared (27, 32, 32) int8 on the "
                         f"input's device, got {tuple(wk.shape)} {wk.dtype} on {wk.device}")
    _check_vec("scale", scale, xq.device)
    if bias is not None:
        _check_vec("bias", bias, xq.device)
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"conv3d_k3_int8: out_dtype must be bf16 or float32, got {out_dtype}")
    B, Z, Y, X, _ = xq.shape
    out = torch.empty((B, Z, Y, X, C), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    # a persistent grid: at most BLOCKS_PER_SM blocks per SM walk the tiles
    tz, ty, tx = TILE
    tiles = B * -(-Z // tz) * -(-Y // ty) * -(-X // tx)
    grid = min(tiles, BLOCKS_PER_SM * _sm_count(
        xq.device.index if xq.device.index is not None else torch.cuda.current_device()))
    rc = build.kernel("conv_k3_int8")(
        xq.data_ptr(), wk.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), _OUT_CODE[out_dtype],
        B, Z, Y, X, grid, torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(rc, "conv3d_k3_int8 kernel")
    return out
