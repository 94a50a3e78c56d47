"""GroupNorm on channels-last (B, ..., C) activations: a hand CUDA kernel
for the no-grad bf16 forward, and the plain version in stock ops.

Counterpart of ``rtpose_tpu/models/layers.py::GroupNorm8`` (stock XLA ops;
no TPU kernel).  Float32 statistics over each batch item's positions and the
C / groups channels of a group, the population variance, eps as given, the
affine in float32, the output in the input's dtype.

* ``group_norm`` — the entry point (``models.layers.GroupNorm8``): the
  kernel's calls (``kernel_takes``) go to ``launch``, every other one to
  ``group_norm_reference``.
* ``launch`` — by ``build``'s rule: the ``torch.ops.rtpose.group_norm``
  custom op (``ops/library.py``) while a ``TorchDispatchMode`` is active
  (``torch.export`` traces it), the plain version on a CPU tensor, the
  kernel on a CUDA one.  The op's implementation is ``launch`` again, with
  the mode off.
* ``kernel_route`` — True where a call launches the kernel: a CUDA tensor
  the kernel takes and no dispatch mode.
* ``group_norm_reference`` — the plain version: a cast to float32, two
  means, the affine, a cast back.
* ``plan`` and ``kernel_reference`` — the kernel's chunking, and its
  statistics and affine modelled in stock float32 ops.

The kernel (``csrc/group_norm.cu``) takes bf16 with C a multiple of 8 and of
``groups`` (at most ``MAX_CHANNELS``), no gradient required (no grad mode,
or no tensor requiring one); float32 and float64, training, the CPU and
other widths take the plain version.  Its arithmetic: per-thread Welford
means and M2 in float32, merged with Chan's formula in a fixed order (no
atomics: launches and graph replays are bit-equal), rstd = 1 / sqrt(M2 / n
+ eps), out = x * scale + shift with scale = w * rstd, shift = b - mean *
scale, rounded once to bf16: within one bf16 ulp of the plain version.
One launch runs its two kernels (statistics, apply) and counts once under
``ops.launch_counts()["group_norm"]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

THREADS = 256               # the kernel's threads a block
MAX_CHANNELS = 8 * THREADS  # a block reads at least one row of C / 8 vectors a sweep
BLOCKS_PER_SM = 2           # blocks a SM over the grid (2 timed fastest of 2, 4, 8)
MIN_SWEEPS = 4              # rows a thread reads at least, where the tensor allows


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         groups: int, eps: float) -> torch.Tensor:
    """The plain version: float32 statistics (float64 for a float64 input),
    the output in ``x.dtype``."""
    B, C = x.shape[0], x.shape[-1]
    dt = torch.promote_types(x.dtype, torch.float32)   # float64 stays float64
    xg = x.to(dt).reshape(B, -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (out * weight.to(dt) + bias.to(dt)).to(x.dtype)


def kernel_takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 groups: int) -> bool:
    """The dtype, widths and grad state the kernel is for, on any device."""
    C = x.shape[-1]
    return (x.dtype == torch.bfloat16 and x.dim() >= 2 and C % 8 == 0 and C % groups == 0
            and C <= MAX_CHANNELS and x.numel() < 1 << 31
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or weight.requires_grad or bias.requires_grad)))


def kernel_route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 groups: int) -> bool:
    """True where the call launches the kernel."""
    return (x.is_cuda and not build.dispatch_mode_active()
            and kernel_takes(x, weight, bias, groups))


def plan(B: int, S: int, C: int, sms: int) -> Tuple[int, int]:
    """(chunks a batch item, rows a chunk) of a launch on (B, S, C): about
    ``BLOCKS_PER_SM`` blocks a SM over the whole batch, each reading at least
    ``MIN_SWEEPS`` rows a thread, a chunk a whole number of the block's
    sweeps (THREADS / (C / 8) rows)."""
    sweep = THREADS // (C // 8)
    chunks = max(1, min(-(-BLOCKS_PER_SM * sms // B), S // (sweep * MIN_SWEEPS)))
    rows = -(-S // chunks)
    rows = -(-rows // sweep) * sweep
    return -(-S // rows), rows


def _merge(a, b):
    """Chan's merge of moments ``b`` into ``a`` ((count, mean, M2) tensors),
    as the kernel forms it; a part of count 0 leaves ``a`` as it is."""
    (na, ma, qa), (nb, mb, qb) = a, b
    n = na + nb
    r = nb / n.clamp_min(1)
    d = mb - ma
    keep = nb == 0
    return (n, torch.where(keep, ma, ma + d * r),
            torch.where(keep, qa, qa + qb + d * d * na * r))


def kernel_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                     eps: float, sms: int) -> torch.Tensor:
    """The kernel's arithmetic in stock float32 ops: each chunk's centred
    moments per group (what its threads' Welford sums merge to), merged in
    the apply pass's order (lane l of 32 the chunks l, l + 32, ..., then a
    tree over the lanes), rstd = 1 / sqrt(M2 / n + eps), and x * scale +
    shift with scale = w * rstd, shift = b - mean * scale, in ``x.dtype``."""
    B, C = x.shape[0], x.shape[-1]
    G = C // groups
    xf = x.float().reshape(B, -1, groups, G)
    S = xf.shape[1]
    chunks, rows = plan(B, S, C, sms)
    parts = []
    for k in range(chunks):
        xc = xf[:, k * rows:(k + 1) * rows]
        m = xc.mean(dim=(1, 3))
        parts.append((torch.full_like(m, xc.shape[1] * G), m,
                      (xc - m[:, None, :, None]).square().sum(dim=(1, 3))))
    zero = torch.zeros((B, groups))
    lanes = [(zero, zero, zero)] * 32
    for k, p in enumerate(parts):
        lanes[k % 32] = _merge(lanes[k % 32], p)
    for o in (16, 8, 4, 2, 1):
        lanes[:o] = [_merge(lanes[i], lanes[i + o]) for i in range(o)]
    n, mean, m2 = lanes[0]
    rstd = 1.0 / torch.sqrt(m2 / n + eps)
    scale = weight.float() * rstd.repeat_interleave(G, dim=1)          # (B, C)
    shift = bias.float() - mean.repeat_interleave(G, dim=1) * scale
    out = x.float().reshape(B, -1, C) * scale[:, None] + shift[:, None]
    return out.reshape(x.shape).to(x.dtype)


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
           eps: float) -> torch.Tensor:
    """GroupNorm of a call ``kernel_takes``, by the module's rule (custom op,
    plain version or kernel)."""
    if build.dispatch_mode_active():
        return torch.ops.rtpose.group_norm(x, weight, bias, groups, eps)
    if x.device.type == "cpu":
        return group_norm_reference(x, weight, bias, groups, eps)
    return _run(x, weight, bias, groups, eps)


def _run(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
         eps: float) -> torch.Tensor:
    """One kernel launch on a CUDA bf16 (B, ..., C) tensor (a copy of it
    where it is not contiguous or not 16-byte aligned)."""
    C = x.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() < 2 or C % 8 \
            or C % groups or C > MAX_CHANNELS:
        raise ValueError(f"group_norm: needs a CUDA (B, ..., C) bf16 input with C a multiple "
                         f"of 8 and of {groups} groups, at most {MAX_CHANNELS}; got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if weight.shape != (C,) or bias.shape != (C,) or weight.device != x.device \
            or bias.device != x.device:
        raise ValueError(f"group_norm: weight and bias must be ({C},) on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    B = x.shape[0]
    S = x.numel() // (B * C)
    chunks, rows = plan(B, S, C, build.sm_count(x.device))
    w, b = (t.detach().float().contiguous() for t in (weight, bias))
    part = torch.empty((B, chunks, groups, 3), dtype=torch.float32, device=x.device)
    build.launch("group_norm", "group_norm", x.device,
                 x.data_ptr(), w.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(),
                 B, S, C, groups, chunks, rows, float(eps))
    return out


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    """GroupNorm of (B, ..., C) ``x`` in ``groups`` groups, (C,) ``weight``
    and ``bias``: the kernel's route (``launch``) for what it takes, the
    plain version for the rest."""
    if kernel_takes(x, weight, bias, groups):
        return launch(x, weight, bias, groups, eps)
    return group_norm_reference(x, weight, bias, groups, eps)
