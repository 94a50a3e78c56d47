"""Post-training int8 quantization for the serving path.

Counterpart of ``rtpose_tpu/ops/quant.py``: symmetric PTQ, zero-point 0
everywhere, bit for bit the JAX package's arithmetic.

* **Weights**: per-output-channel scales ``sw[co] = absmax(w[co]) / 127``
  (1.0 where the absmax is 0), ``wq = clip(round(w / sw), -127, 127)``.
* **Activations**: one per-tensor scale per conv input, from a calibration
  pass; ``xq = clip(round(x.float() * (1 / scale)), -127, 127)``, rounded
  half to even (``torch.round``, as ``jnp.round``).
* **Accumulator**: int32, exact.  **Epilogue**: ``acc.float() * (sw *
  act_scale)``, then ``+ bias``, in float32 and in that order, then cast
  to the conv's input dtype.

Sites are keyed by the JAX package's flax paths (``engine.convert.
site_paths``), so a scales dict carries across verbatim and
``DEFAULT_EXCLUDE``'s suffix rule means the same thing.  ``TorchConv3d``
and the HRNet final fuse consult the context (``consult``) under their
``site``.

How the int32 accumulator is computed, by shape and device (a dispatch,
no fallback):

* the K3 shape (3x3x3, stride 1, 32 -> 32, channels-last):
  ``conv_k3_int8.launch`` (on CUDA the hand kernel, accumulator and
  epilogue fused; on the CPU its plain version);
* every other CUDA shape: an int8 im2col (padding and stride included) and
  ``torch._int_mm`` (int8 x int8 -> int32, exact);
* other CPU shapes: ``F.conv3d`` in float32 on the int8-valued tensors,
  over chunks of input channels whose sums cannot reach 2^24 (exact: every
  partial sum is a representable integer), the chunks added as int32.

``site_conv`` is a site of the eager int8 path (``TorchConv3d`` calls it
under ``int8_mode``): the span ``int8.site`` around the conv, and the
site counted in ``counts()``: ``sites`` (int8 site calls), the calls of
each route (``k3_kernel``: the K3 shape on CUDA; ``int_mm``: every other
CUDA shape; ``plain``: every CPU call, the K3 shape's plain version
included), ``concat_1x1`` (calls of the HRNet final fuse's concat + 1x1
conv, the site ``FINAL_CONV``) and ``quant_elems`` (activation elements
quantized).  The counts are the Python call's: a loaded ``torch.export``
artifact runs none of this Python, so they stay at 0 while it serves (its
kernels' custom ops count their launches in ``ops.launch_counts()``), and
the export's own trace counts its one traced forward.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import trace
from . import conv_k3_int8

_state = threading.local()

# the leaf of the HRNet final fuse's int8 concat + 1x1 conv site
# (``engine.convert.site_paths``: ``backbone_m/final_conv``)
FINAL_CONV = "final_conv"

_COUNTS = dict(sites=0, k3_kernel=0, int_mm=0, plain=0, concat_1x1=0, quant_elems=0)


def counts() -> dict:
    """Int8 site calls since the last ``reset`` (see the module's doc)."""
    return dict(_COUNTS)


def reset() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


class QuantState:
    def __init__(self, mode: str, scales: Optional[Dict[str, float]] = None,
                 exclude: tuple = (), quantile: Optional[float] = None):
        self.mode = mode                    # 'calib' | 'int8'
        self.scales = scales or {}          # path -> float (act absmax/127)
        self.exclude = exclude              # leaf-name suffixes left unquantized
        self.quantile = quantile            # calib: clip statistic (None=absmax)
        self.traced = {}                    # calib: path -> statistic (0-dim tensor)

    def excluded(self, path: str) -> bool:
        # the FINAL path component by suffix: a parent whose name merely
        # contains an exclude string does not exclude its whole subtree
        leaf = path.rsplit("/", 1)[-1]
        return any(leaf.endswith(s) for s in self.exclude)


def current() -> Optional[QuantState]:
    return getattr(_state, "q", None)


@contextmanager
def calibrate(exclude: tuple = (), quantile: Optional[float] = None):
    """Run a forward inside this context; each site records its input
    statistic into ``state.traced``: the absmax (default), or the
    ``quantile``-th quantile of |x| over a strided subsample (the PTQ
    outlier defense, see ``rtpose_tpu/ops/quant.py::calibrate``)."""
    prev = current()
    q = QuantState("calib", exclude=exclude, quantile=quantile)
    _state.q = q
    try:
        yield q
    finally:
        _state.q = prev


@contextmanager
def int8_mode(scales: Dict[str, float], exclude: tuple = ()):
    """Run (or export) a forward inside this context to get the int8 program;
    ``scales`` maps site paths to activation scales (absmax / 127)."""
    prev = current()
    _state.q = QuantState("int8", dict(scales), exclude=exclude)
    try:
        yield _state.q
    finally:
        _state.q = prev


def scales_from_calib(batch_maxima) -> Dict[str, float]:
    """Per-batch calibration statistics (a list of {path: value}) ->
    activation scales; a statistic of 0 (dead input) gives scale 1."""
    out: Dict[str, float] = {}
    for rec in batch_maxima:
        for k, v in rec.items():
            out[k] = max(out.get(k, 0.0), float(v))
    return {k: (v / 127.0 if v > 0 else 1.0) for k, v in out.items()}


# The head output convs ("<branch>_out") stay float by default, and so do
# the final-fuse resizes ("<site>_resize"; opt in with INT8_RESIZE_EXCLUDE,
# ``tools.export --int8_resize``).  Suffixes of the final path component.
DEFAULT_EXCLUDE = ("_out", "_resize")

# opt-in variant: int8 resizes too (only the head out-convs stay float)
INT8_RESIZE_EXCLUDE = ("_out",)


def calibration_scales(fn, batches, exclude: tuple = DEFAULT_EXCLUDE,
                       quantile: Optional[float] = None) -> Dict[str, float]:
    """Run ``fn(batch)`` under calibration for every batch and return
    activation scales for :func:`int8_mode`."""
    maxima = []
    with torch.inference_mode():
        for b in batches:
            with calibrate(exclude, quantile=quantile) as q:
                fn(b)
                maxima.append({k: float(v) for k, v in q.traced.items()})
    return scales_from_calib(maxima)


def consult(path: str, x: torch.Tensor) -> Optional[float]:
    """The quant context's hook for a site keyed by ``path``.

    Under calibration, records the input statistic (max-accumulated over
    repeated applications of a site) and returns None; under int8 mode
    returns the site's activation scale if one was calibrated; otherwise
    None (the caller runs its float path)."""
    q = current()
    if q is None or q.excluded(path):
        return None
    if q.mode == "calib":
        flat = x.detach().float().abs().reshape(-1)
        if q.quantile is not None:
            # strided subsample: the sort stays ~200k elements per site,
            # and torch.quantile refuses inputs above 2^24 elements
            stride = max(1, flat.shape[0] // 200_000)
            stat = torch.quantile(flat[::stride], q.quantile)
        else:
            stat = flat.max()
        prev = q.traced.get(path)
        q.traced[path] = stat if prev is None else torch.maximum(prev, stat)
        return None
    if q.mode == "int8":
        return q.scales.get(path)
    return None


def _quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric per-tensor int8, rounded half to even."""
    q = torch.round(x.float() * (1.0 / scale))
    return q.clamp(-127, 127).to(torch.int8)


def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of torch-layout (Co, ...) weights:
    returns (wq int8 of w's shape, sw (Co,) float32)."""
    w32 = w.detach().float()
    absmax = w32.abs().amax(dim=tuple(range(1, w.dim())))
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which is not always the correctly rounded quotient
    sw = torch.where(absmax > 0, absmax / absmax.new_tensor(127.0), torch.ones_like(absmax))
    wq = torch.round(w32 / sw.view(-1, *([1] * (w.dim() - 1)))).clamp(-127, 127)
    return wq.to(torch.int8), sw


def int8_conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int) -> torch.Tensor:
    """The exact int32 accumulator of an int8 conv with torch padding
    (k // 2): ``xq`` (B, Z, Y, X, C) int8, ``wq`` (Co, C, k, k, k) int8 ->
    (B, Zo, Yo, Xo, Co) int32.  CPU: ``F.conv3d`` in float32 on the int8
    values, over chunks of input channels small enough that no sum can
    reach 2^24 (so every partial sum is an exact integer, in any order),
    the chunks' results added as int32; CUDA: an int8 im2col and
    ``torch._int_mm`` (no hand kernel: ``conv3d_int8_prepared`` sends the
    K3 shape to ``conv_k3_int8.launch`` before this)."""
    k = wq.shape[-1]
    p = k // 2
    if xq.device.type == "cpu":
        x, C = xq.permute(0, 4, 1, 2, 3).float(), xq.shape[-1]
        per = (2 ** 24 - 1) // (127 * 127 * k ** 3)
        acc = sum(F.conv3d(x[:, c:c + per], wq[:, c:c + per].float(), stride=stride,
                           padding=p).to(torch.int32) for c in range(0, C, per))
        return acc.permute(0, 2, 3, 4, 1).contiguous()
    if xq.device.type != "cuda":
        raise ValueError(f"int8 conv: unsupported device {xq.device}")
    B, Z, Y, X, C = xq.shape
    Co = wq.shape[0]
    Zo, Yo, Xo = ((n + 2 * p - k) // stride + 1 for n in (Z, Y, X))
    if k == 1 and stride == 1:
        cols = xq.reshape(-1, C)
    else:
        xp = F.pad(xq, (0, 0, p, p, p, p, p, p)) if p else xq
        taps = [xp[:, dz:dz + stride * (Zo - 1) + 1:stride,
                   dy:dy + stride * (Yo - 1) + 1:stride,
                   dx:dx + stride * (Xo - 1) + 1:stride]
                for dz in range(k) for dy in range(k) for dx in range(k)]
        cols = torch.stack(taps, dim=-2).reshape(-1, k * k * k * C)
    # (Co, kz, ky, kx, C) rows: the im2col's column order; passed transposed
    # (a column-major (K, Co) operand), the layout cuBLASLt's int8 GEMM takes
    wmat = wq.permute(0, 2, 3, 4, 1).reshape(Co, -1).contiguous()
    M, K = cols.shape
    if K % 8:
        # torch._int_mm takes inner widths of multiples of 8 (a LiDAR reader's
        # 4 features): zero columns add nothing to the integer sums
        cols = F.pad(cols, (0, -K % 8))
        wmat = F.pad(wmat, (0, -K % 8))
        K = cols.shape[1]
    # torch._int_mm's CUDA shape limits (aten/src/ATen/native/cuda/Blas.cpp)
    if not (M > 16 and Co % 8 == 0):
        raise ValueError(f"int8 conv: torch._int_mm needs rows > 16 and output widths "
                         f"multiples of 8, got ({M}, {K}) x ({K}, {Co})")
    acc = torch._int_mm(cols.contiguous(), wmat.t())
    return acc.reshape(B, Zo, Yo, Xo, Co)


def epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
             out_dtype) -> torch.Tensor:
    """``acc.float() * scale``, then ``+ bias``, in float32, then the cast."""
    out = acc.float() * scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def prepare(w: torch.Tensor, bias: Optional[torch.Tensor], act_scale: float, stride: int):
    """What an int8 conv of torch-layout weights needs, made once: the int8
    weights, the float32 ``sw * act_scale``, the float32 bias and, for a
    conv the K3 int8 kernel takes, its prepared weights (else None)."""
    wq, sw = _quantize_weight(w)
    scale = (sw * act_scale).contiguous()
    b = None if bias is None else bias.detach().float().contiguous()
    wk = conv_k3_int8.prepare(wq) if conv_k3_int8.supports_weight(wq, stride) else None
    return wq, scale, b, wk


def conv3d_int8_prepared(x: torch.Tensor, act_scale: float, prepared: tuple, stride: int,
                         out_dtype=None) -> torch.Tensor:
    """The int8 conv of the UNquantized (B, Z, Y, X, C) activation ``x``,
    quantized at ``act_scale``, on the ``prepare``d weights ``prepared``.
    The K3 shape takes ``conv_k3_int8.launch``; everything else takes
    ``int8_conv_acc`` and ``epilogue``.  Returns the dequantized output in
    ``out_dtype`` (default the input's dtype)."""
    wq, scale, bias, wk = prepared
    xq = _quantize_act(x, act_scale)
    out_dtype = out_dtype or x.dtype
    if _takes_k3(x, wk):
        return conv_k3_int8.launch(xq, wk, scale, bias, out_dtype)
    return epilogue(int8_conv_acc(xq, wq, stride), scale, bias, out_dtype)


def _takes_k3(x: torch.Tensor, wk: Optional[torch.Tensor]) -> bool:
    """Whether ``conv3d_int8_prepared`` sends ``x`` to ``conv_k3_int8.launch``."""
    return wk is not None and x.dim() == 5 and x.shape[-1] == conv_k3_int8.C


def _route(x: torch.Tensor, prepared: tuple) -> str:
    """The route ``conv3d_int8_prepared`` takes for ``x``, as ``counts()``
    names it: 'k3_kernel', 'int_mm' or 'plain'."""
    if x.device.type != "cuda":
        return "plain"
    return "k3_kernel" if _takes_k3(x, prepared[3]) else "int_mm"


def site_conv(path: str, x: torch.Tensor, act_scale: float, prepared: tuple,
              stride: int) -> torch.Tensor:
    """``conv3d_int8_prepared`` as the int8 site ``path``: inside the span
    ``int8.site``, counted in ``counts()``."""
    with trace.span("int8.site"):
        _COUNTS["sites"] += 1
        _COUNTS[_route(x, prepared)] += 1
        _COUNTS["quant_elems"] += x.numel()
        if path.rsplit("/", 1)[-1] == FINAL_CONV:
            _COUNTS["concat_1x1"] += 1
        return conv3d_int8_prepared(x, act_scale, prepared, stride)


def conv3d_int8(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int, act_scale: float, out_dtype=None) -> torch.Tensor:
    """Int8 conv with ``TorchConv3d`` semantics: ``x`` the UNquantized
    (B, Z, Y, X, C) activation, ``w`` torch-layout (Co, C, k, k, k) float
    weights.  Returns the dequantized output in ``out_dtype`` (default the
    input's dtype)."""
    return conv3d_int8_prepared(x, act_scale, prepare(w, bias, act_scale, stride), stride,
                                out_dtype)


def conv3d_int8_concat_1x1(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                           act_scale: float, out_dtype=None) -> torch.Tensor:
    """Int8 form of the HRNet final fuse conv: a 1x1 int8 conv of the
    channel concat with per-channel weight scales (the JAX package's
    block-diagonal folded form computes the same integers).  On CUDA it runs
    ``torch._int_mm``."""
    return conv3d_int8(x, w, bias, 1, act_scale, out_dtype)
