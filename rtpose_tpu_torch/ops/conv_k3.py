"""Stride-1 3x3x3 conv, 32 -> 32 channels, channels-last bf16.

Counterpart of ``rtpose_tpu/ops/pallas_conv.py`` (the Pallas kernel K3,
``_pallas_forward``): the CUDA kernel ``csrc/conv_k3.cu`` computes the same
conv on the unfolded (B, Z, Y, X, 32) layout, with float32 accumulation and
one rounding to bf16 (TMA-fed input planes, weights resident in shared
memory, wgmma).  ``models.layers.TorchConv3d`` dispatches every bf16 conv
of this shape here.

The backward (``_fused_bwd``, ``pallas_conv.py:211-225``) is ``Conv3dK3``:
grad-input is the same kernel on the flipped, channel-transposed weights
(``_flip_transpose``, ``:197-199``), as on the TPU; grad-weight is the
library's conv weight-gradient (bf16 operands, float32 accumulation), where
the JAX package used XLA's.

* ``conv3d_k3`` — the wrapper on torch-layout weights: ``prepare``, then
  ``launch`` (raises on a shape or dtype the kernel does not take).
* ``prepare`` + ``launch`` — the same split in two: ``prepare`` re-lays
  torch-layout (Co, Ci, 3, 3, 3) weights to the kernel's (9, 4, 3, 32, 8)
  [dy * 3 + dx][ci // 8][dz][co][ci % 8] bf16 and the bias to float32,
  once (``TorchConv3d`` keeps them between calls); ``launch`` runs the
  conv on them by ``build``'s rule: through the ``torch.ops.rtpose``
  custom op (``ops/library.py``) while a ``TorchDispatchMode`` is active
  (a ``FlopCounterMode`` sees the op and counts its registered formula;
  ``torch.export`` traces it), the plain version on a CPU tensor, the
  kernel on a CUDA tensor (or an error on what it does not take).  The
  op's implementation is ``launch`` again, with the mode off.
* ``plan`` — the launch plan the kernel runs: tile shape, padded row width,
  stages of the input ring, shared memory and grid.
* ``conv3d_k3_reference`` — the plain version: ``F.conv3d`` in float32 on
  the bf16-rounded operands, bias added in float32, rounded to bf16.
* ``Conv3dK3`` — the autograd Function over ``conv3d_k3``; ``grad_input``
  (``launch_grad_input`` on ``prepare_flipped`` weights, by the same rule)
  and ``grad_weight`` (on the CPU the float32 weight-gradient of
  ``F.conv3d`` on bf16-rounded operands) are its two backward halves.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

C = 32


def flops(x_shape) -> int:
    """Operations of one launch on a (B, Z, Y, X, 32) input: two per
    multiply-add over the full 3x3x3 window (the forward and grad-input
    alike)."""
    B, Z, Y, X, _ = x_shape
    return 2 * B * Z * Y * X * C * C * 27


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
    """(Co, Ci, 3, 3, 3) weights, (Co,) bias -> the kernel's (9, 4, 3, 32, 8)
    [dy * 3 + dx][ci // 8][dz][co][ci % 8] bf16 weights and float32 bias.
    For one tap (dy, dx) and 8 input channels, the 96 rows (dz, co) are the
    wgmma's N, each 8-row block one 128-byte core matrix."""
    wr = (w.detach().to(torch.bfloat16).permute(3, 4, 1, 2, 0)   # ky kx ci kz co
          .reshape(9, 4, 8, 3, C).permute(0, 1, 3, 4, 2))
    return wr.contiguous(), None if bias is None else bias.detach().float().contiguous()


def unprepare(wr: torch.Tensor) -> torch.Tensor:
    """The inverse of ``prepare`` on the weights: (9, 4, 3, 32, 8) ->
    (Co, Ci, 3, 3, 3), in ``wr``'s dtype."""
    return wr.reshape(3, 3, 4, 3, C, 8).permute(4, 2, 5, 3, 0, 1).reshape(C, C, 3, 3, 3)


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """Torch-layout weights of the grad-input conv: the three taps flipped,
    Ci and Co swapped (``_flip_transpose``, pallas_conv.py:197-199)."""
    return w.flip((2, 3, 4)).transpose(0, 1)


def prepare_flipped(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) weights -> the kernel's (9, 4, 3, 32, 8) bf16 layout
    of their ``flip_transpose``: the weights of the grad-input launch."""
    return prepare(flip_transpose(w))[0]


SMEM_LIMIT = 232448        # shared memory a block may use on the H100 (227 KB)
WEIGHT_BYTES = 27 * C * C * 2   # (9, 4, 3, 32, 8) bf16
MAX_STAGES = 8
MIN_STAGES = 4            # the plane in use and three loading behind it
PLANE_COST, STAGE_COST = 0.25, 0.1   # see ``candidate``
X_TILES = (14, 30, 40, 62, 80)   # output columns per tile tried besides X itself


class Plan(NamedTuple):
    """A launch of the kernel: output tiles of ``ty`` rows x ``tx`` columns
    (row width ``wp = tx + 2`` with the halo), ``2 * nbw`` 64-row wgmma
    blocks per tile (``nbw`` per consumer warpgroup), a ring of ``stages``
    input planes of ``positions`` 16-byte positions per channel chunk (8
    bf16 channels here, 16 int8 in ``conv_k3_int8``);
    ``tiles`` tile-planes (B * ny * nx * Z, z fastest) split into ``grid``
    contiguous ranges, one per block, the busiest of which reads
    ``max_planes`` input planes."""
    tx: int
    ty: int
    wp: int
    nbw: int
    positions: int
    stages: int
    nx: int
    ny: int
    tiles: int
    grid: int
    smem: int
    max_planes: int


def segments(tiles: int, grid: int, Z: int):
    """Per block, its runs of output planes: (block, column, za, zb) for each
    run [za, zb) of one column in the block's contiguous range of
    tile-planes (z fastest), as the kernel's ``segment_at`` cuts it."""
    for blk in range(grid):
        L, end = tiles * blk // grid, tiles * (blk + 1) // grid
        while L < end:
            col, za = divmod(L, Z)
            zb = min(Z, za + (end - L))
            yield blk, col, za, zb
            L += zb - za


def plan_candidate(B: int, Z: int, Y: int, X: int, sms: int, tx: int, nbw: int, *,
                   fixed_bytes: int, barriers: int, position_bytes: int, plane_cost: float,
                   stage_cost: float) -> Optional[Tuple[tuple, Plan]]:
    """The plan with output tiles ``tx`` wide and ``2 * nbw`` 64-row blocks
    (``ty`` as many rows as fit), and its cost key, for a kernel of this
    design (this one's and the int8 kernel's): ``fixed_bytes`` of shared
    memory besides the ring, ``barriers`` mbarriers besides the ring's two
    per stage, ``position_bytes`` bytes of a stage per position.  The cost,
    in the time of one 64-row block's products with one input plane: the
    busiest block's input planes, each ``2 * nbw`` blocks plus
    ``plane_cost`` for its waits and epilogue, and ``stage_cost`` per KB of
    a stage for the prologue that loads the first planes; then the total
    work, then the widest tile.  None if the rows or the ring (at least
    ``MIN_STAGES``) and the rest in ``SMEM_LIMIT`` do not fit."""
    wp = tx + 2
    rows = 2 * nbw * 64
    if wp > rows or wp > 256:
        return None
    ty = min(rows // wp, Y)
    # the last block's bottom-right tap reads rows + 2 wp + 2 positions
    positions = -(-max((ty + 2) * wp, rows + 2 * wp + 2) // 8) * 8
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed_bytes - 8 * (2 * MAX_STAGES + barriers))
                 // (position_bytes * positions))
    if stages < MIN_STAGES:
        return None
    nx, ny = -(-X // tx), -(-Y // ty)
    tiles = B * ny * nx * Z
    grid = min(sms, tiles)
    per_block = [0] * grid
    for blk, _, za, zb in segments(tiles, grid, Z):
        per_block[blk] += min(zb, Z - 1) - max(za - 1, 0) + 1   # input planes za - 1 .. zb
    max_planes = max(per_block)
    smem = fixed_bytes + stages * position_bytes * positions + 8 * (2 * stages + barriers)
    cost = max_planes * (2 * nbw + plane_cost) + stage_cost * positions * position_bytes / 1024
    return (cost, tiles * nbw, -tx), Plan(tx, ty, wp, nbw, positions, stages, nx, ny, tiles,
                                          grid, smem, max_planes)


def candidate(B: int, Z: int, Y: int, X: int, sms: int, tx: int, nbw: int
              ) -> Optional[Tuple[tuple, Plan]]:
    """``plan_candidate`` for this kernel: the weights in shared memory,
    four 8-channel chunk planes a stage, ``PLANE_COST`` and ``STAGE_COST``
    fitted to the kernel's device times over these candidates at the
    flagship shapes on an H100 (``tools.k3_plans``)."""
    return plan_candidate(B, Z, Y, X, sms, tx, nbw, fixed_bytes=WEIGHT_BYTES, barriers=3,
                          position_bytes=64, plane_cost=PLANE_COST, stage_cost=STAGE_COST)


def candidates(B: int, Z: int, Y: int, X: int, sms: int, candidate=candidate):
    """Every ``candidate`` that fits: tile widths ``X_TILES`` below X and X
    itself, one or two blocks per warpgroup, as (cost key, plan)."""
    return [c for tx in sorted({t for t in X_TILES if t < X} | {X}) for nbw in (1, 2)
            if (c := candidate(B, Z, Y, X, sms, tx, nbw)) is not None]


@functools.lru_cache(maxsize=256)
def plan(B: int, Z: int, Y: int, X: int, sms: int) -> Plan:
    """The launch plan for a (B, Z, Y, X, 32) input on a card of ``sms``
    SMs: the cheapest of ``candidates``."""
    found = candidates(B, Z, Y, X, sms)
    if not found:
        raise ValueError(f"conv3d_k3: no launch plan for {(B, Z, Y, X)}")
    return min(found)[1]


def conv3d_k3(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Z, Y, X, 32) bf16 -> (B, Z, Y, X, 32) bf16, zero padding 1."""
    if not supports(x, w, 1):
        raise ValueError(f"conv3d_k3: needs (B, Z, Y, X, 32) bf16 and (32, 32, 3, 3, 3) "
                         f"weights, got {tuple(x.shape)} {x.dtype}, {tuple(w.shape)}")
    return launch(x, *prepare(w, bias))


def launch(x: torch.Tensor, wr: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward conv of a (B, Z, Y, X, 32) bf16 input on ``prepare``d
    weights and bias, by the module's rule (custom op, plain version or
    kernel)."""
    if build.dispatch_mode_active():
        return torch.ops.rtpose.conv3d_k3(x, wr, bias)
    if x.device.type == "cpu":
        return conv3d_k3_reference(x, unprepare(wr), bias)
    return _run(x, wr, bias, "conv3d_k3")


def _run(x: torch.Tensor, wr: torch.Tensor, bias: Optional[torch.Tensor], counter: str,
         p: Optional[Plan] = None) -> torch.Tensor:
    """One kernel launch, counted under ``counter``, on ``plan``'s launch
    plan unless ``p`` names another (``tools.k3_plans`` times each
    candidate)."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 5 \
            or x.shape[-1] != C:
        raise ValueError(f"conv3d_k3: needs a CUDA (B, Z, Y, X, 32) bf16 input, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3d_k3: input must be contiguous and 16-byte aligned")
    if (tuple(wr.shape) != (9, 4, 3, C, 8) or wr.dtype != torch.bfloat16
            or not wr.is_contiguous() or wr.data_ptr() % 16):
        raise ValueError(f"conv3d_k3: weights must be prepared (9, 4, 3, 32, 8) bf16, "
                         f"got {tuple(wr.shape)} {wr.dtype}")
    if bias is not None and (tuple(bias.shape) != (C,) or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f"conv3d_k3: bias must be prepared ({C},) float32, "
                         f"got {tuple(bias.shape)} {bias.dtype}")
    if wr.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("conv3d_k3: weights and bias must be on the input's device")
    B, Z, Y, X, _ = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    if p is None:
        p = plan(B, Z, Y, X, build.sm_count(x.device))
    build.launch("conv_k3", counter, x.device,
                 x.data_ptr(), wr.data_ptr(), None if bias is None else bias.data_ptr(),
                 out.data_ptr(), B, Z, Y, X, p.wp, p.ty, p.nbw, p.positions, p.stages, p.grid)
    return out


def grad_input(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d(loss)/dx of the conv from the output gradient ``g`` (B, Z, Y, X, 32)
    and the torch-layout weights: the same conv on ``flip_transpose(w)``,
    bf16 in and out."""
    return launch_grad_input(g.to(torch.bfloat16).contiguous(), prepare_flipped(w))


def launch_grad_input(g: torch.Tensor, wr: torch.Tensor) -> torch.Tensor:
    """The grad-input conv of a (B, Z, Y, X, 32) bf16 output gradient on
    ``prepare_flipped`` weights, by the module's rule."""
    if build.dispatch_mode_active():
        return torch.ops.rtpose.conv3d_k3_grad_input(g, wr)
    if g.device.type == "cpu":
        return conv3d_k3_reference(g, unprepare(wr))
    return _run(g, wr, None, "conv3d_k3_bwd")


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
        out = conv3d_k3(x, weight, bias)
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
