"""Deformable 2-D convolution v1 / v2 (mask), channels-last, in stock ops.

Counterpart of ``rtpose_tpu/ops/deform_conv.py`` (reference
``det3d/ops/dcn``): the predicted offsets move each tap of a KxK conv; each
moved sample is a bilinear gather of the input (four corners and their
weights), the deformed im2col tensor (n, Ho, Wo, K * C) is contracted with
the (K * C, Cout) weights in one matrix product.  The JAX package builds it
from XLA gathers and an einsum, not from a Pallas kernel; the port does the
same with ``index_select`` and a matmul; autograd's backward of the gather
is ``index_add_``, a scatter-add (atomics on the card, so two runs'
gradients differ in the last bits).  The gather takes the four corners of a
sample as one row (an input laid out as the four shifted copies of its
zero-padded self): ``index_select``'s time on the card grows with the number
of rows, hardly with their width.

Boundary semantics (the reference CUDA kernel's): a sample whose moved
center leaves the map (y <= -1, y >= H, x <= -1 or x >= W) contributes
zero; inside, each corner outside the map contributes zero on its own (it
reads the zero padding, where the JAX function multiplies by zero).

Dtypes follow the JAX function: the base grid is built in ``x.dtype`` and
added to the offsets (float32 offsets make float32 sample positions); the
bilinear weights, the gathered corners and their sum are in ``x.dtype``; a
v2 mask multiplies in its own dtype's promotion; the contraction
accumulates in float32 and is cast back to ``x.dtype``.

Memory: at the DCN head's training shape (B * Z = 128 images of 64 x 160,
128 channels, 9 taps) the im2col tensor alone is ~2.4 GB in bf16 and its
four corner gathers four times that.  The images are processed in chunks
of at most ``CHUNK_ELEMS`` im2col elements; with autograd on, each chunk
runs under ``torch.utils.checkpoint``, so the backward recomputes a chunk's
gathers instead of keeping them.  Images are independent, so chunking
changes no value.

Spans (``utils.trace``, off by default): ``dcn.sample`` around each chunk's
bilinear gather and weighting, ``dcn.contract`` around its matrix product
(again in the backward's recomputation).  ``counts()`` holds what the calls
since ``reset()`` asked for: ``calls``, ``chunks``, ``samples`` (bilinear
samples, n * Ho * Wo * K * dg) and ``column_elems`` (im2col elements,
n * Ho * Wo * K * C); the Python call adds to them, so a captured call
counts once and the replays of its CUDA graph do not.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..utils import trace

CHUNK_ELEMS = 1 << 28     # im2col elements per chunk (512 MB in bf16)

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


def _columns(x, offset, mask, Kh, Kw, stride, padding, dilation, dg):
    """One chunk's deformed im2col tensor: (n, H, W, C) -> (n * Ho * Wo, K * C)
    in x.dtype."""
    n, H, W, C = x.shape
    _, Ho, Wo, _ = offset.shape
    K, Cg = Kh * Kw, C // dg
    dev = x.device
    gy = _grid(Ho, Kh, stride, padding, dilation, x.dtype, dev)     # (Ho, Kh)
    gx = _grid(Wo, Kw, stride, padding, dilation, x.dtype, dev)     # (Wo, Kw)
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
    step = max(1, CHUNK_ELEMS // max(1, Ho * Wo * Kh * Kw * C))
    args = (Kh, Kw, stride, padding, dilation, deformable_groups)
    positions = B * Ho * Wo * Kh * Kw
    _COUNTS["calls"] += 1
    _COUNTS["chunks"] += -(-B // step)
    _COUNTS["samples"] += positions * deformable_groups
    _COUNTS["column_elems"] += positions * C
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, offset, weight, bias, mask))
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
