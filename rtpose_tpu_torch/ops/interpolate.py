"""Trilinear resize with ``align_corners=True`` on channels-last volumes:
a hand CUDA kernel for the no-grad bf16 forward, and the plain version in
stock ops.

Counterpart of ``rtpose_tpu/ops/interpolate.py::
resize_trilinear_align_corners``: the JAX package writes the resize as
three single-axis interpolation matmuls to reach the TPU's MXU; PyTorch has
the same sampling as ``F.interpolate(mode="trilinear", align_corners=True)``
(the reference's own op, hr3d.py:219-224).

* ``resize_trilinear_align_corners`` — the entry point (``models/hrnet3d.py``'s
  fuse layers and final fuse): the kernel's calls (``kernel_takes``) go to
  ``launch``, every other one to ``resize_reference``.  Two epilogues serve
  the callers: ``addend`` gives ``addend + resize(x)`` (the fuse's running
  sum, rounded as the two operations round it: ``bf16(addend +
  bf16(resize))``), ``out`` writes the result into a channel slice of a
  channels-last buffer (the final fuse's concat).
* ``launch`` — by ``build``'s rule: the ``torch.ops.rtpose.resize_trilinear``
  custom op (``ops/library.py``) while a ``TorchDispatchMode`` is active,
  the plain version on a CPU tensor, the kernel on a CUDA one.
* ``kernel_route`` — True where a call launches the kernel.
* ``resize_reference`` — the plain version: a permute to channels-first,
  ``F.interpolate``, a permute back and a copy, then the addend's add.
* ``plan`` and ``kernel_reference`` — the kernel's launch shape, and its
  arithmetic modelled in stock float32 ops.

The kernel (``csrc/resize_trilinear.cu``) takes bf16 (B, Z, Y, X, C) with C a
multiple of 8, a contiguous input (and addend; an output whose voxels are a
multiple of 8 channels apart), each starting at a multiple of 8 elements
into its storage, fewer than 2^31 elements in and out, and
no gradient required (no grad mode, or no tensor requiring one); float32 and
float64, training, the CPU, other widths and a resize to the input's own
size take the plain version.  Its arithmetic is ATen's: source index scale *
o with the float32 scale (in - 1) / (out - 1), its floor, the next index
clamped at the edge, the remainder as the weight; the blend along x, then
y, then z in float32, each product and sum rounded on its own (ATen's
compiled kernel may fuse some into fma: within one bf16 ulp of it), rounded
once to bf16.  Launches and graph replays are bit-equal.  A launch counts
once under ``ops.launch_counts()["resize_trilinear"]``; ``counts()`` holds
the calls of each route (``kernel``, ``plain``; the int8 form's among the
plain), the Python call's, so a CUDA graph's replays are not in it.

``resize_trilinear_int8`` is the int8 serving form of the HRNet final-fuse
resize (``--int8_resize``), as the JAX package computes it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build

MAX_THREADS = 512           # the kernel's most threads a block
SMEM_BYTES = 96 * 1024      # the shared memory a block may take (the input rows it blends)
# output vectors (8 channels) a thread writes, where the grid allows, and the
# blocks a SM the grid keeps at least, where the output has the rows: of the
# pairs timed on an H100 (4-64 vectors, 0.25-8 blocks), (16, 1) ran the 13
# resizes of a forward fastest at the cells' own trunks and batches (the
# flagship's at B=8, the feat64 trunk's at B=1)
VECTORS_PER_THREAD = 16
BLOCKS_PER_SM = 1

_COUNTS = dict(kernel=0, plain=0)


def counts() -> dict:
    """Calls of each route since the last ``reset`` (see the module's doc)."""
    return dict(_COUNTS)


def reset() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def resize_reference(x: torch.Tensor, size_zyx: Sequence[int],
                     addend: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: (B, Z, Y, X, C) -> (B, tz, ty, tx, C), plus
    ``addend`` if given, written into ``out`` if given."""
    _COUNTS["plain"] += 1
    y = x
    if tuple(x.shape[1:4]) != tuple(size_zyx):
        y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=tuple(size_zyx),
                          mode="trilinear", align_corners=True)
        y = y.permute(0, 2, 3, 4, 1).contiguous()
    if addend is not None:
        y = addend + y
    return y if out is None else out.copy_(y)


def _slice_stride(out: torch.Tensor) -> Optional[int]:
    """The voxel stride of ``out`` where it is a channel slice of a
    contiguous channels-last buffer (its last dimension dense), else None."""
    if out.dim() != 5:
        return None
    s, (_, Z, Y, X, _) = out.stride(), out.shape
    if s[4] != 1 or s[3] % 8 or s[3] < out.shape[4]:
        return None
    want = (Z * Y * X * s[3], Y * X * s[3], X * s[3], s[3])
    return s[3] if all(n == 1 or a == w for n, a, w in zip(out.shape[:4], s[:4], want)) \
        else None


def kernel_takes(x: torch.Tensor, size_zyx: Sequence[int],
                 addend: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> bool:
    """The dtype, widths, layouts and grad state the kernel is for, on any
    device."""
    if x.dtype != torch.bfloat16 or x.dim() != 5 or len(size_zyx) != 3:
        return False
    B, C = x.shape[0], x.shape[4]
    shape = (B, *size_zyx, C)
    n_out = B * size_zyx[0] * size_zyx[1] * size_zyx[2] * C
    if (C % 8 or not x.is_contiguous() or x.storage_offset() % 8 or x.numel() >= 1 << 31
            or n_out >= 1 << 31 or tuple(x.shape[1:4]) == tuple(size_zyx)
            or 8 * x.shape[3] * C > SMEM_BYTES):
        return False
    if addend is not None and (addend.dtype != x.dtype or tuple(addend.shape) != shape
                               or not addend.is_contiguous() or addend.storage_offset() % 8
                               or addend.device != x.device):
        return False
    if out is not None and (out.dtype != x.dtype or tuple(out.shape) != shape
                            or out.device != x.device or _slice_stride(out) is None
                            or out.storage_offset() % 8
                            or B * size_zyx[0] * size_zyx[1] * size_zyx[2] * out.stride(3)
                            >= 1 << 31):
        return False
    return not (torch.is_grad_enabled()
                and (x.requires_grad or (addend is not None and addend.requires_grad)))


def kernel_route(x: torch.Tensor, size_zyx: Sequence[int],
                 addend: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> bool:
    """True where the call launches the kernel."""
    return (x.is_cuda and not build.dispatch_mode_active()
            and kernel_takes(x, size_zyx, addend, out))


def _axis(n_in: int, n_out: int):
    """Per output index along one axis: the lower and upper source indices
    and the lower and upper weights, in ATen's float32 arithmetic for
    align_corners (numpy float32 rounds each operation as the card does)."""
    scale = np.float32(n_in - 1) / np.float32(n_out - 1) if n_out > 1 else np.float32(0)
    r = np.arange(n_out, dtype=np.float32) * scale
    i0 = r.astype(np.int64)
    i1 = i0 + (i0 < n_in - 1)
    l1 = r - i0.astype(np.float32)
    return i0, i1, np.float32(1) - l1, l1


def _row_span(n_in: int, n_out: int, rows: int) -> int:
    """The most input rows a block of ``rows`` output rows along Y reads."""
    i0, i1, _, _ = _axis(n_in, n_out)
    starts = np.arange(0, n_out, rows)
    ends = np.minimum(starts + rows, n_out) - 1
    return int((i1[ends] - i0[starts]).max()) + 1


@functools.lru_cache(maxsize=256)
def plan(B: int, in_zyx: Sequence[int], out_zyx: Sequence[int], C: int,
         sms: int) -> Tuple[int, int, int]:
    """(threads a block, output rows a block, shared bytes a block) of a
    launch.  A thread keeps its (x, 8 channels) place in every row of its
    block: the threads are the divisor of X * C / 8 that is a multiple of 32
    and at most ``MAX_THREADS`` (all of a row's vectors where that fits),
    the largest that leaves each thread whole rows; the rows give each
    thread about ``VECTORS_PER_THREAD`` outputs, fewer where the grid would
    otherwise hold fewer than ``BLOCKS_PER_SM`` blocks a SM, and fewer again
    until the two input planes' rows fit in ``SMEM_BYTES``."""
    Zo, Yo, Xo = out_zyx
    items = Xo * (C // 8)
    if items <= MAX_THREADS:
        threads = -(-items // 32) * 32
    else:
        threads = next((t for t in range(MAX_THREADS, 31, -32) if items % t == 0), 256)
    per_row = -(-items // threads)
    rows = max(1, VECTORS_PER_THREAD // per_row)
    rows = max(1, min(rows, B * Zo * Yo // (BLOCKS_PER_SM * sms), Yo))

    def smem(r):
        return 2 * _row_span(in_zyx[1], Yo, r) * in_zyx[2] * C * 2

    while rows > 1 and smem(rows) > SMEM_BYTES:
        rows -= 1
    return threads, rows, smem(rows)


def kernel_reference(x: torch.Tensor, size_zyx: Sequence[int],
                     addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in stock float32 ops: the blend along x, then
    y, then z (``w0 * a + w1 * b``, each product and sum rounded on its own),
    rounded once to ``x.dtype``, then ``bf16(addend + that)``."""
    (z0, z1, t0, t1), (y0, y1, h0, h1), (x0, x1, w0, w1) = (
        (torch.from_numpy(a).to(x.device) for a in _axis(n, m))
        for n, m in zip(x.shape[1:4], size_zyx))
    v = x.float()
    v = w0[:, None] * v[:, :, :, x0] + w1[:, None] * v[:, :, :, x1]
    v = h0[:, None, None] * v[:, :, y0] + h1[:, None, None] * v[:, :, y1]
    v = t0[:, None, None, None] * v[:, z0] + t1[:, None, None, None] * v[:, z1]
    v = v.to(x.dtype)
    return v if addend is None else (addend.float() + v.float()).to(x.dtype)


def launch(x: torch.Tensor, size_zyx: Sequence[int], addend: Optional[torch.Tensor] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The resize of a call ``kernel_takes``, by the module's rule (custom
    op, plain version or kernel)."""
    if build.dispatch_mode_active():
        y = torch.ops.rtpose.resize_trilinear(x, list(size_zyx), addend)
        return y if out is None else out.copy_(y)
    if x.device.type == "cpu":
        return resize_reference(x, size_zyx, addend, out)
    return _run(x, size_zyx, addend, out)


def _run(x: torch.Tensor, size_zyx: Sequence[int], addend: Optional[torch.Tensor],
         out: Optional[torch.Tensor]) -> torch.Tensor:
    """One kernel launch on a CUDA bf16 input the kernel takes."""
    B, C = x.shape[0], x.shape[4]
    if out is None:
        out = x.new_empty((B, *size_zyx, C))
    if (x.device.type != "cuda" or not kernel_takes(x, size_zyx, addend, out)
            or any(t.data_ptr() % 16 for t in (x, addend, out) if t is not None)):
        raise ValueError(f"resize_trilinear: the kernel does not take {tuple(x.shape)} "
                         f"{x.dtype} on {x.device} -> {tuple(size_zyx)}, or an operand is "
                         "not 16-byte aligned")
    _COUNTS["kernel"] += 1
    if out.numel() == 0:
        return out
    threads, rows, _ = plan(B, tuple(x.shape[1:4]), tuple(size_zyx), C,
                            build.sm_count(x.device))
    build.launch("resize_trilinear", "resize_trilinear", x.device,
                 x.data_ptr(), 0 if addend is None else addend.data_ptr(), out.data_ptr(),
                 B, *x.shape[1:4], *size_zyx, C, _slice_stride(out), rows, threads)
    return out


def resize_trilinear_align_corners(x: torch.Tensor, size_zyx: Sequence[int],
                                   addend: Optional[torch.Tensor] = None,
                                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Z, Y, X, C) -> (B, tz, ty, tx, C), plus ``addend`` (B, tz, ty, tx,
    C) if given, written into ``out`` (a channel slice of a channels-last
    buffer) if given: the kernel's route (``launch``) for what it takes, the
    plain version for the rest.  Without ``addend`` and ``out``, a resize
    to the input's own size returns ``x``."""
    if kernel_takes(x, size_zyx, addend, out):
        return launch(x, size_zyx, addend, out)
    if addend is None and out is None and tuple(x.shape[1:4]) == tuple(size_zyx):
        return x
    return resize_reference(x, size_zyx, addend, out)


# --- the int8 form (serving path; rtpose_tpu/ops/interpolate.py:77-139) ---

@functools.lru_cache(maxsize=None)
def _interp_matrix_np(s_in: int, s_out: int) -> np.ndarray:
    """(S_out, S_in) align-corners linear interpolation matrix (a copy of
    ``rtpose_tpu/ops/interpolate.py::_interp_matrix_np``)."""
    w = np.zeros((s_out, s_in), dtype=np.float32)
    if s_out == 1 or s_in == 1:
        w[:, 0] = 1.0
        return w
    scale = (s_in - 1) / (s_out - 1)
    pos = np.arange(s_out, dtype=np.float64) * scale
    lo = np.floor(pos).astype(np.int64)
    lo = np.clip(lo, 0, s_in - 2)
    frac = (pos - lo).astype(np.float32)
    w[np.arange(s_out), lo] = 1.0 - frac
    w[np.arange(s_out), lo + 1] = frac
    return w


@functools.lru_cache(maxsize=None)
def _quantized_interp_np(s_in: int, s_out: int):
    """Per-output-row symmetric int8 quantization of the interp matrix
    (``_quantized_interp_np`` of the JAX package): (wq int8, sw float32)."""
    w = _interp_matrix_np(s_in, s_out)
    absmax = w.max(axis=1)
    sw = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    wq = np.clip(np.round(w / sw[:, None]), -127, 127).astype(np.int8)
    return wq, sw


def resize_trilinear_int8(x: torch.Tensor, size_zyx: Tuple[int, int, int],
                          act_scale: float, out_dtype=None) -> torch.Tensor:
    """Int8 form of the final-fuse resize, ``resize_trilinear_folded_int8``
    of the JAX package on the unfolded layout: passes X, then Z, then Y; the
    input re-quantized with the one calibrated scale before each pass; int8
    interpolation matrices with per-output-row scales; the float32 epilogue
    after each pass.

    The integer products run as a float32 matmul of the integer-valued
    tensors, on both devices: every output element sums at most two
    products of at most 127 * 127 (the rest are exact zeros), so each sum
    is an integer far below 2^24 and exact in float32 with TF32 off
    (``api.resolve_device`` turns it off)."""
    _COUNTS["plain"] += 1
    B, Z, Y, X, C = x.shape
    tz, ty, tx = size_zyx
    out_dtype = out_dtype or x.dtype
    inv = 1.0 / act_scale

    def q(v):
        return torch.round(v.float() * inv).clamp(-127, 127)

    def mat(s_in, s_out):
        wq, sw = _quantized_interp_np(s_in, s_out)
        return (torch.from_numpy(wq).to(device=x.device, dtype=torch.float32),
                torch.from_numpy(sw).to(x.device) * act_scale)

    out = x
    if X != tx:
        wq, s = mat(X, tx)
        out = torch.einsum("ox,bzyxc->bzyoc", wq, q(out)) * s[:, None]
    if Z != tz:
        wq, s = mat(Z, tz)
        out = torch.einsum("oz,bzyxc->boyxc", wq, q(out)) * s[:, None, None, None]
    if Y != ty:
        wq, s = mat(Y, ty)
        out = torch.einsum("oy,bzyxc->bzoxc", wq, q(out)) * s[:, None, None]
    return out.to(out_dtype)
