"""Int8 stride-1 3x3x3 conv, 32 -> 32 channels, channels-last.

Not a port of a TPU kernel: the JAX package runs its int8 convs on XLA's
int8 convolutions (``rtpose_tpu/ops/quant.py::conv3d_int8``), and PyTorch
has no int8 ``conv3d`` on CUDA.  The stock route (an int8 im2col and
``torch._int_mm``) writes and reads back a 27x im2col, so the K3 shape,
which carries most of the flagship's operations, gets this hand kernel,
``csrc/conv_k3_int8.cu``: an exact int32 accumulator and the float32
epilogue ``acc * scale[co] (+ bias[co])`` of ``ops/quant.py``, rounded once
to the output dtype.  The kernel equals its plain version bit for bit.

What bounds it on an H100: operations and bytes about equally (at
(1, 16, 64, 160) 4.6 us of int8 operations at 1979 TOPS and 4.7 us of
bytes at 3.35 TB/s, the bf16 output two thirds of them).  So its design is
the bf16 K3 kernel's (``ops/conv_k3.py``) in int8: a persistent grid
walking z-fastest tile-planes, so each input plane of a column is loaded
once; the weights resident in shared memory; a producer warp streaming
input planes through a TMA ring whose out-of-bounds zero fill is the
padding; int8 ``wgmma`` m64n96k32 with dz folded into N, each plane adding
into three running output sums, which rotate through the weights' dz
slices instead of moving between registers; two consumer warpgroups
taking turns, so that one's epilogue runs under the other's products; and
an N order of the weights (``N_CHANNEL``) that leaves each thread 8
contiguous output channels, so that every store is 16 bytes of a whole
line.  The source's notes give the details.

* ``conv3d_k3_int8`` — the wrapper on int8 torch-layout weights:
  ``prepare``, then ``launch`` (raises on weights the kernel does not take).
* ``prepare`` + ``launch`` — the same split in two: ``prepare`` re-lays
  (32, 32, 3, 3, 3) int8 weights to the kernel's (9, 2, 3, 32, 16)
  [dy * 3 + dx][ci // 16][dz][n][ci % 16] int8 (output channels in the
  ``N_CHANNEL`` order), once; ``launch`` runs the conv on them by
  ``conv_k3``'s rule: the custom op while a dispatch mode is active, the
  plain version on a CPU tensor, the kernel on a CUDA one.  ``unprepare``
  is ``prepare``'s inverse.  Both refuse any other shape, so the
  (27, 32, 32) layout of earlier artifacts is never misread.
* ``plan`` — the launch plan the kernel runs: tile shape, padded row width,
  stages of the input ring, shared memory and grid.
* ``conv3d_k3_int8_reference`` — the plain version: ``F.conv3d`` in float64
  on the int8 values (exact), cast to int32, then the epilogue.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from . import conv_k3
from .conv_k3 import Plan

C = 32
PREPARED_SHAPE = (9, 2, 3, C, 16)
# the output channel of each of a dz slice's 32 N columns: the wgmma gives
# thread t columns 8 g + 2 (t % 4) + e (g = 0..3, e = 0..1), so column
# 8 g + 2 q + e holds channel 8 q + 2 g + e and each thread ends up with 8
# contiguous channels of its rows (the permutation is its own inverse)
N_CHANNEL = tuple(8 * (n // 2 % 4) + 2 * (n // 8) + n % 2 for n in range(C))

_OUT_CODE = {torch.bfloat16: 0, torch.float32: 1}


def supports_weight(wq: torch.Tensor, stride: int) -> bool:
    """The weight shape and stride the kernel is for."""
    return stride == 1 and tuple(wq.shape) == (C, C, 3, 3, 3)


def check_prepared(wk: torch.Tensor) -> None:
    """Raise unless ``wk`` has ``prepare``'s shape and dtype."""
    if tuple(wk.shape) != PREPARED_SHAPE or wk.dtype != torch.int8:
        raise ValueError(f"conv3d_k3_int8: weights must be prepared {PREPARED_SHAPE} int8 "
                         f"(ops.conv_k3_int8.prepare), got {tuple(wk.shape)} {wk.dtype}")


def prepare(wq: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) int8 -> the kernel's (9, 2, 3, 32, 16)
    [dy * 3 + dx][ci // 16][dz][n][ci % 16] int8, row n the weights of
    output channel ``N_CHANNEL[n]``.  For one tap (dy, dx) and 16 input
    channels, the 96 rows (dz, n) are the wgmma's N, each 8-row block one
    128-byte core matrix."""
    wr = (wq.detach().to(torch.int8).permute(3, 4, 1, 2, 0)    # ky kx ci kz co
          .reshape(9, 2, 16, 3, C).permute(0, 1, 3, 4, 2))
    return wr[:, :, :, list(N_CHANNEL)].contiguous()


def unprepare(wk: torch.Tensor) -> torch.Tensor:
    """The inverse of ``prepare``: (9, 2, 3, 32, 16) -> (Co, Ci, 3, 3, 3)."""
    check_prepared(wk)
    wr = wk[:, :, :, list(N_CHANNEL)]
    return wr.reshape(3, 3, 2, 3, C, 16).permute(4, 2, 5, 3, 0, 1).reshape(C, C, 3, 3, 3)


def conv3d_k3_int8_reference(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: (B, Z, Y, X, 32) int8 -> (B, Z, Y, X, 32) ``out_dtype``."""
    acc = F.conv3d(xq.permute(0, 4, 1, 2, 3).double(), wq.double(), padding=1)
    out = acc.permute(0, 2, 3, 4, 1).to(torch.int32).float() * scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype).contiguous()


# the weights in the kernel's shared memory: each (tap, c16) chunk held as
# dz slices 0, 1, 2, 0, 1, so that a rotation of the slices is an offset
WEIGHT_SMEM = 9 * 2 * 5 * C * 16
PLANE_COST, STAGE_COST = 0.5, 0.2   # see ``candidate``


def candidate(B: int, Z: int, Y: int, X: int, sms: int, tx: int, nbw: int
              ) -> Optional[Tuple[tuple, Plan]]:
    """``conv_k3.plan_candidate`` for this kernel: ``WEIGHT_SMEM`` of
    weights, two 16-channel chunk planes a stage (32 bytes a position), two
    mbarriers more for the warpgroups' turns, and its own ``PLANE_COST``
    and ``STAGE_COST`` (in the time of one 64-row block's 9 int8 wgmmas with
    one input plane, half a bf16 block's), fitted to the kernel's device
    times over these candidates at the flagship shapes on an H100
    (``tools.k3_plans --int8``)."""
    return conv_k3.plan_candidate(B, Z, Y, X, sms, tx, nbw, fixed_bytes=WEIGHT_SMEM, barriers=5,
                                  position_bytes=32, plane_cost=PLANE_COST,
                                  stage_cost=STAGE_COST)


def candidates(B: int, Z: int, Y: int, X: int, sms: int):
    """Every ``candidate`` that fits (``conv_k3.candidates``)."""
    return conv_k3.candidates(B, Z, Y, X, sms, candidate)


@functools.lru_cache(maxsize=256)
def plan(B: int, Z: int, Y: int, X: int, sms: int) -> Plan:
    """The launch plan for a (B, Z, Y, X, 32) input on a card of ``sms``
    SMs: the cheapest of ``candidates``."""
    found = candidates(B, Z, Y, X, sms)
    if not found:
        raise ValueError(f"conv3d_k3_int8: no launch plan for {(B, Z, Y, X)}")
    return min(found)[1]


def conv3d_k3_int8(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, Z, Y, X, 32) int8, (32, 32, 3, 3, 3) int8 weights, (32,) float32
    ``scale`` (``sw * act_scale``), optional (32,) float32 bias -> (B, Z, Y,
    X, 32) ``out_dtype`` (bf16 or float32), zero padding 1."""
    if not supports_weight(wq, 1) or wq.dtype != torch.int8:
        raise ValueError(f"conv3d_k3_int8: needs (32, 32, 3, 3, 3) int8 weights, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    return launch(xq, prepare(wq), scale, bias, out_dtype)


def launch(xq: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The conv of a (B, Z, Y, X, 32) int8 input on ``prepare``d weights,
    by the module's rule (custom op, plain version or kernel)."""
    if build.dispatch_mode_active():
        return torch.ops.rtpose.conv3d_k3_int8(xq, wk, scale, bias, out_dtype)
    if xq.device.type == "cpu":
        return conv3d_k3_int8_reference(xq, unprepare(wk), scale, bias, out_dtype)
    return _run(xq, wk, scale, bias, out_dtype)


def _check_vec(name: str, t: torch.Tensor, dev) -> None:
    if (tuple(t.shape) != (C,) or t.dtype != torch.float32 or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"conv3d_k3_int8: {name} must be a contiguous ({C},) float32 "
                         f"tensor on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _run(xq, wk, scale, bias, out_dtype, p: Optional[Plan] = None) -> torch.Tensor:
    """One kernel launch, on ``plan``'s launch plan unless ``p`` names another
    (``tools.k3_plans --int8`` times each candidate)."""
    check_prepared(wk)
    if (xq.device.type != "cuda" or xq.dtype != torch.int8 or xq.dim() != 5
            or xq.shape[-1] != C):
        raise ValueError(f"conv3d_k3_int8: needs a CUDA (B, Z, Y, X, 32) int8 input, got "
                         f"{tuple(xq.shape)} {xq.dtype} on {xq.device}")
    if not xq.is_contiguous() or xq.data_ptr() % 16:
        raise ValueError("conv3d_k3_int8: input must be contiguous and 16-byte aligned")
    if not wk.is_contiguous() or wk.data_ptr() % 16 or wk.device != xq.device:
        raise ValueError("conv3d_k3_int8: prepared weights must be contiguous, 16-byte "
                         "aligned and on the input's device")
    _check_vec("scale", scale, xq.device)
    if bias is not None:
        _check_vec("bias", bias, xq.device)
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"conv3d_k3_int8: out_dtype must be bf16 or float32, got {out_dtype}")
    B, Z, Y, X, _ = xq.shape
    out = torch.empty((B, Z, Y, X, C), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    if p is None:
        p = plan(B, Z, Y, X, build.sm_count(xq.device))
    build.launch("conv_k3_int8", "conv3d_k3_int8", xq.device,
                 xq.data_ptr(), wk.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(), _OUT_CODE[out_dtype],
                 B, Z, Y, X, p.wp, p.ty, p.nbw, p.positions, p.stages, p.grid)
    return out
