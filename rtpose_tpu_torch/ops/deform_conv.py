"""Deformable 2-D convolution v1 / v2 (mask), channels-last: a hand CUDA
kernel for the no-grad bf16 forward, and the plain route in stock ops.

Counterpart of ``rtpose_tpu/ops/deform_conv.py`` (reference
``det3d/ops/dcn``): the predicted offsets move each tap of a KxK conv; each
moved sample is a bilinear gather of the input (four corners and their
weights), the deformed im2col tensor (n, Ho, Wo, K * C) is contracted with
the (K * C, Cout) weights.  The JAX package builds it from XLA gathers and
an einsum, not from a Pallas kernel.

Two routes, chosen by one predicate on the inputs (``kernel_route``):

* **the kernel** (``csrc/deform_conv.cu``, added for the deformable head's
  eval path): one launch samples, weights and contracts, with no im2col
  tensor in device memory.  It takes a call when the tensors are on CUDA, x
  and the weights are bf16 and the offsets float32, no gradient is required
  (no grad mode, or no input requiring one), no ``TorchDispatchMode`` is
  active (a fake-tensor trace or a FLOP counter sees the plain route), there
  is no mask and no bias, the kernel is 3x3 with stride 1 and dilation 1,
  and C is a multiple of 64, C / dg of 8 and Cout of 128.  Its arithmetic:
  sample positions in float32 as below, bilinear weights and the four-corner
  sum in float32, each column value rounded once to bf16, the contraction
  accumulated in float32 and rounded once to bf16.  Deterministic.
* **the plain route** takes every other call (training with autograd, the
  CPU, float32, a mask or a bias): ``index_select`` and a matmul; autograd's
  backward of the gather is ``index_add_``, a scatter-add (atomics on the
  card, so two runs' gradients differ in the last bits).  The gather takes
  the four corners of a sample as one row (an input laid out as the four
  shifted copies of its zero-padded self): ``index_select``'s time on the
  card grows with the number of rows, hardly with their width.

Boundary semantics (the reference CUDA kernel's): a sample whose moved
center leaves the map (y <= -1, y >= H, x <= -1 or x >= W) contributes
zero; inside, each corner outside the map contributes zero on its own (it
reads the zero padding, where the JAX function multiplies by zero).

Dtypes of the plain route follow the JAX function: the base grid is built
in ``x.dtype`` and added to the offsets (float32 offsets make float32 sample
positions); the bilinear weights, the gathered corners and their sum are in
``x.dtype``; a v2 mask multiplies in its own dtype's promotion; the
contraction accumulates in float32 and is cast back to ``x.dtype``.

Memory of the plain route: at the DCN head's training shape (B * Z = 128
images of 64 x 160, 128 channels, 9 taps) the im2col tensor alone is ~2.4
GB in bf16 and its four corner gathers four times that.  The images are
processed in chunks of at most ``CHUNK_ELEMS`` im2col elements; with
autograd on, each chunk runs under ``torch.utils.checkpoint``, so the
backward recomputes a chunk's gathers instead of keeping them.  Images are
independent, so chunking changes no value.

Spans (``utils.trace``, off by default): on the plain route ``dcn.sample``
around each chunk's bilinear gather and weighting, ``dcn.contract`` around
its matrix product (again in the backward's recomputation); on the kernel
route ``dcn.fused`` around the launch.  ``counts()`` holds what the calls
since ``reset()`` asked for: ``calls``, ``samples`` (bilinear samples, n *
Ho * Wo * K * dg) and ``column_elems`` (im2col elements, n * Ho * Wo * K *
C) on either route, and ``chunks`` the plain route's chunks; the Python
call adds to them, so a captured call counts once and the replays of its
CUDA graph do not.  The kernel's launches are ``ops.launch_counts()``'s
``deform_conv2d``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..utils import trace
from . import build

CHUNK_ELEMS = 1 << 28     # im2col elements per chunk (512 MB in bf16)
# the kernel's output positions a tile, input channels a step, output channels a block
TILE_M, STEP_C, TILE_N = 128, 64, 128

_COUNTS = dict(calls=0, chunks=0, samples=0, column_elems=0)


def counts() -> dict:
    """What the calls since the last ``reset`` asked for (see the module's doc)."""
    return dict(_COUNTS)


def reset() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _grid(n_out: int, n_k: int, stride: int, padding: int, dilation: int, dtype, device):
    """(n_out, n_k): base position of each output row/column plus each
    tap's offset, in ``dtype``."""
    base = torch.arange(n_out, device=device) * stride - padding
    return (base[:, None] + torch.arange(n_k, device=device)[None, :] * dilation).to(dtype)


def _columns(x, offset, mask, Kh, Kw, stride, padding, dilation, dg, grid_dtype=None):
    """One chunk's deformed im2col tensor: (n, H, W, C) -> (n * Ho * Wo, K * C)
    in x.dtype; the base grid in ``grid_dtype`` (default x.dtype)."""
    n, H, W, C = x.shape
    _, Ho, Wo, _ = offset.shape
    K, Cg = Kh * Kw, C // dg
    dev = x.device
    gdt = x.dtype if grid_dtype is None else grid_dtype
    gy = _grid(Ho, Kh, stride, padding, dilation, gdt, dev)         # (Ho, Kh)
    gx = _grid(Wo, Kw, stride, padding, dilation, gdt, dev)         # (Wo, Kw)
    # tap k = ky * Kw + kx; everything below is laid out (n, Ho, Wo, K, dg)
    grid_y = gy.repeat_interleave(Kw, dim=1)[:, None, :, None]       # (Ho, 1, K, 1)
    grid_x = gx.repeat(1, Kh)[None, :, :, None]                      # (1, Wo, K, 1)
    off = offset.reshape(n, Ho, Wo, dg, K, 2).transpose(3, 4)       # (n, Ho, Wo, K, dg, 2)
    ys = grid_y + off[..., 0]
    xs = grid_x + off[..., 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0).to(x.dtype), (xs - x0).to(x.dtype)
    valid = (ys > -1) & (ys < H) & (xs > -1) & (xs < W)

    # the four corners of every top-left position of the zero-padded input,
    # one row per (position, group): a corner outside the map reads a zero
    # of the padding, as the JAX function weights it by zero
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(n, H + 2, W + 2, dg, Cg)
    rows = torch.stack([xp[:, :-1, :-1], xp[:, :-1, 1:], xp[:, 1:, :-1], xp[:, 1:, 1:]],
                       dim=4).reshape(-1, 4 * Cg)
    b = torch.arange(n, device=dev).view(n, 1, 1, 1, 1) * (H + 1)
    g = torch.arange(dg, device=dev).view(1, 1, 1, 1, dg)
    # padded top-left (y0 + 1, x0 + 1), clamped for the samples `valid` drops
    yc = (y0 + 1).clamp(0, H).long()
    xc = (x0 + 1).clamp(0, W).long()
    idx = ((b + yc) * (W + 1) + xc) * dg + g                         # (n, Ho, Wo, K, dg)
    v = rows.index_select(0, idx.reshape(-1)).reshape(*idx.shape, 4, Cg)
    cols = (v[..., 0, :] * ((1 - wy) * (1 - wx))[..., None]
            + v[..., 1, :] * ((1 - wy) * wx)[..., None]
            + v[..., 2, :] * (wy * (1 - wx))[..., None]
            + v[..., 3, :] * (wy * wx)[..., None])
    cols = cols * valid[..., None].to(x.dtype)
    if mask is not None:
        cols = cols * mask.reshape(n, Ho, Wo, dg, K).transpose(3, 4)[..., None]
    return cols.reshape(n * Ho * Wo, K * C)


def _deform_out(x, offset, mask, weight, bias, Kh, Kw, stride, padding, dilation, dg):
    """One chunk: (n, H, W, C) -> (n, Ho, Wo, Cout) in x.dtype."""
    with trace.span("dcn.sample"):
        cols = _columns(x, offset, mask, Kh, Kw, stride, padding, dilation, dg)
    with trace.span("dcn.contract"):
        wmat = weight.reshape(cols.shape[1], -1)
        if bias is None and cols.dtype == wmat.dtype == x.dtype:
            # one GEMM in x.dtype: float32 accumulation, one rounding
            out = cols @ wmat
        else:
            acc = torch.promote_types(x.dtype, torch.float32)
            out = cols.to(acc) @ wmat.to(acc)
            if bias is not None:
                out = out + bias
        return out.to(x.dtype).reshape(*offset.shape[:3], -1)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def kernel_route(x, offset, weight, bias, mask, stride, dilation, deformable_groups) -> bool:
    """True where the kernel takes the call (the module's doc lists why)."""
    Kh, Kw, C, Cout = weight.shape
    return (x.is_cuda and offset.is_cuda and weight.is_cuda
            and not _needs_grad(x, offset, weight, bias, mask)
            and x.dtype == weight.dtype == torch.bfloat16 and offset.dtype == torch.float32
            and mask is None and bias is None and not build.dispatch_mode_active()
            and (Kh, Kw, stride, dilation) == (3, 3, 1, 1) and max(x.shape[1:3]) < 1 << 15
            and C % STEP_C == 0 and (C // deformable_groups) % 8 == 0 and Cout % TILE_N == 0
            and deformable_groups <= 8)


def prepare(weight: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Cout) weights -> the kernel's (9, C / 64, Cout, 64) [ky * 3 +
    kx][ci / 64][co][ci % 64] layout: for one tap and 64 input channels (one
    step of the kernel), the Cout 128-byte rows of the wgmma's B operand."""
    _, _, C, Cout = weight.shape
    return weight.reshape(9, C // STEP_C, STEP_C, Cout).transpose(2, 3).contiguous()


def kernel_reference(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                     padding: int = 1, deformable_groups: int = 1) -> torch.Tensor:
    """The kernel's arithmetic in stock ops, on any device: the base grid
    rounded to bf16, sample positions, bilinear weights and the four-corner
    sum in float32 on the bf16 input, each column rounded once to bf16, the
    contraction in float32 with the bf16 weights, rounded once to bf16.
    (The kernel forms each sum with fused multiply-adds, so a column may
    round one bf16 ulp apart.)"""
    x = x.to(torch.bfloat16)
    out = []
    step = max(1, CHUNK_ELEMS // max(1, offset.shape[1] * offset.shape[2] * 9 * x.shape[-1]))
    for s in range(0, x.shape[0], step):
        cols = _columns(x[s:s + step].float(), offset[s:s + step].float(), None, 3, 3, 1,
                        padding, 1, deformable_groups, torch.bfloat16)
        wmat = weight.to(torch.bfloat16).float().reshape(cols.shape[1], -1)
        out.append((cols.to(torch.bfloat16).float() @ wmat).to(torch.bfloat16)
                   .reshape(*offset[s:s + step].shape[:3], -1))
    return torch.cat(out, 0)


def launch(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor, padding: int,
           deformable_groups: int) -> torch.Tensor:
    """The kernel on CUDA bf16 x (B, H, W, C), float32 offsets and bf16
    (3, 3, C, Cout) weights, under ``kernel_route``'s conditions."""
    B, H, W, C = x.shape
    _, Ho, Wo, _ = offset.shape
    Cout = weight.shape[-1]
    x, offset = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (x, offset))
    wr = prepare(weight)
    out = torch.empty((B, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    work = -(-B * Ho * Wo // TILE_M) * (Cout // TILE_N)
    build.launch("deform_conv", "deform_conv2d", x.device,
                 x.data_ptr(), offset.data_ptr(), wr.data_ptr(), out.data_ptr(), B, H, W, C, Cout,
                 deformable_groups, padding, min(work, build.sm_count(x.device)))
    return out


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                  dilation: int = 1, deformable_groups: int = 1,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deformable 2-D convolution (v1; v2 when ``mask`` is given).

    x (B, H, W, C); offset (B, Ho, Wo, dg * K * 2), channel order [group,
    tap, {dy, dx}]; weight (Kh, Kw, C, Cout); bias (Cout,); mask (B, Ho, Wo,
    dg * K), already through the sigmoid.  Returns (B, Ho, Wo, Cout) in
    ``x.dtype``."""
    B, H, W, C = x.shape
    Kh, Kw, _, Cout = weight.shape
    if C % deformable_groups:
        raise ValueError(f"{C} channels do not split into {deformable_groups} groups")
    Ho = (H + 2 * padding - dilation * (Kh - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (Kw - 1) - 1) // stride + 1
    if tuple(offset.shape) != (B, Ho, Wo, deformable_groups * Kh * Kw * 2):
        raise ValueError(f"offset shape {tuple(offset.shape)} for output ({B}, {Ho}, {Wo})")
    positions = B * Ho * Wo * Kh * Kw
    _COUNTS["calls"] += 1
    _COUNTS["samples"] += positions * deformable_groups
    _COUNTS["column_elems"] += positions * C
    if kernel_route(x, offset, weight, bias, mask, stride, dilation, deformable_groups):
        with trace.span("dcn.fused"):
            return launch(x, offset, weight, padding, deformable_groups)
    step = max(1, CHUNK_ELEMS // max(1, Ho * Wo * Kh * Kw * C))
    args = (Kh, Kw, stride, padding, dilation, deformable_groups)
    _COUNTS["chunks"] += -(-B // step)
    grad = _needs_grad(x, offset, weight, bias, mask)
    outs = []
    for s in range(0, B, step):
        part = (x[s:s + step], offset[s:s + step],
                None if mask is None else mask[s:s + step])
        if grad:
            outs.append(torch.utils.checkpoint.checkpoint(
                _deform_out, *part, weight, bias, *args, use_reentrant=False,
                preserve_rng_state=False))
        else:
            outs.append(_deform_out(*part, weight, bias, *args))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 0)
