"""Building-block layers of the 3-D HRNet (PyTorch, channels-last).

Counterpart of ``rtpose_tpu/models/layers.py`` with its ``folded=False``
semantics (the X-folded layout is a TPU device and is not carried).

Layout: activations are (B, Z, Y, X, C) tensors, contiguous — the JAX
package's layout.  That is what the conv kernel (``ops/conv_k3.py``) reads
without a copy, what the sparse-patch code indexes, and what the parity
tests compare; ``F.conv3d`` receives the channels-last-strided
``permute(0, 4, 1, 2, 3)`` view.  Parameters keep torch layouts and the
reference's module names (``conv1``, ``conv2.groupnorm``, ``conv2.conv``),
so ``state_dict`` keys match ``rtpose_tpu/engine/torch_import.py``.

* ``TorchConv3d`` — torch padding (k // 2) and stride, optional compute
  dtype.  bf16 convs of kernel 3, stride 1, 32 -> 32 channels go to K3
  (``ops.conv_k3``, which picks the route: custom op, plain version or
  kernel); every other shape runs ``F.conv3d``.  With grad mode on, K3
  convs go through ``ops.conv_k3.Conv3dK3``, whose backward launches the
  kernel again for grad-input.  Under ``no_grad`` / ``inference_mode`` the
  cast (and, for K3, re-laid) weights are kept on the module between
  calls.
  Its ``site`` (the JAX package's flax path, set by
  ``engine.convert.bind_sites``) keys it in the int8 quant context
  (``ops/quant.py``): under ``calibrate`` it records its input statistic
  and runs float; under ``int8_mode``, with a scale for its site, it runs
  the int8 conv.  ``freeze`` turns the kept weights into buffers, so
  ``torch.export`` can trace the module (the serving export), and reaches
  the kernels through their ``torch.ops.rtpose`` custom ops.
* ``GroupNorm8`` — float32 statistics, eps 1e-5, one group when C < 8,
  output cast back to the input dtype; no-grad bf16 calls of C a multiple
  of 8 go to the GroupNorm kernel (``ops.group_norm``, which picks the
  route: custom op, plain version or kernel).
* ``SingleConv`` (order strings g/c/r/l/e), ``ResNetBlock``, ``GNConv``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv_k3, group_norm, quant


def canonical_dtype(dtype) -> Optional[torch.dtype]:
    """Accept 'bfloat16'/'float32' strings from config files."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(dtype)]


def conv3d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int = 1) -> torch.Tensor:
    """Channels-last ``F.conv3d`` with torch padding k // 2 (``conv3d_naive``
    semantics, ``rtpose_tpu/ops/fold_conv.py:264-274``)."""
    k = w.shape[-1]
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, bias, stride=stride, padding=k // 2)
    return out.permute(0, 2, 3, 4, 1).contiguous()


class TorchConv3d(nn.Module):
    """Conv3d with torch padding/stride semantics on (B, Z, Y, X, C)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, bias: bool = True, dtype=None):
        super().__init__()
        self.stride = stride
        self.dtype = canonical_dtype(dtype)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.site: Optional[str] = None
        self._prepared = None       # (key, parameter aliases, prepared tensors)
        self._prepared_int8 = {}    # activation scale -> the same, int8 weights
        self._frozen = None         # after ``freeze``: slot -> buffer names

    def _weights(self, x: torch.Tensor, prepare, scale: Optional[float] = None):
        """``prepare(weight, bias)`` (a tuple of tensors or None) for ``x``
        (and, int8, the activation ``scale``).  With grad mode off the result
        is kept and reused until a parameter is replaced or changed in place
        (``.to()``, ``load_state_dict``, an optimizer step): the key holds
        each parameter's address and version counter, and the kept
        ``detach()`` aliases keep those addresses from being reused.  A
        frozen module returns its buffers."""
        if self._frozen is not None:
            if scale not in self._frozen:
                raise RuntimeError(f"frozen TorchConv3d {self.site}: no weights kept for "
                                   f"{'float' if scale is None else f'int8 scale {scale}'}")
            return tuple(None if n is None else getattr(self, n) for n in self._frozen[scale])
        if torch.is_grad_enabled():
            return prepare(self.weight, self.bias)
        params = [p for p in (self.weight, self.bias) if p is not None]
        key = (x.dtype, x.device, *((p.data_ptr(), p._version) for p in params))
        kept = self._prepared if scale is None else self._prepared_int8.get(scale)
        if kept is None or kept[0] != key:
            kept = (key, [p.detach() for p in params], prepare(self.weight, self.bias))
            if scale is None:
                self._prepared = kept
            else:
                self._prepared_int8[scale] = kept
        return kept[2]

    def freeze(self) -> None:
        """Keep the weights prepared so far (by a forward under ``no_grad``)
        as non-persistent buffers and use nothing else: the module no longer
        follows its parameters: for tracing with ``torch.export``."""
        slots = dict(self._prepared_int8)
        if self._prepared is not None:
            slots[None] = self._prepared
        self._frozen = {}
        for i, (scale, (_, _, value)) in enumerate(slots.items()):
            names = []
            for j, t in enumerate(value):
                names.append(None if t is None else f"_kept{i}_{j}")
                if t is not None:
                    self.register_buffer(names[-1], t.detach().clone(), persistent=False)
            self._frozen[scale] = names

    def forward(self, x: torch.Tensor, quantize: bool = True) -> torch.Tensor:
        """``quantize=False``: the float conv, whatever the quant context."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        if quantize and quant.current() is not None:
            if self.site is None:
                raise RuntimeError("TorchConv3d under a quant context has no site: "
                                   "engine.convert.bind_sites(model) names them")
            scale = quant.consult(self.site, x)
            if scale is not None:
                prepared = self._weights(
                    x, lambda w, b: quant.prepare(w, b, scale, self.stride), scale)
                return quant.site_conv(self.site, x, scale, prepared, self.stride)
        if conv_k3.supports(x, self.weight, self.stride):
            if torch.is_grad_enabled():
                # the kernel with its backward: the parameters get gradients
                return conv_k3.Conv3dK3.apply(x, self.weight, self.bias)
            return conv_k3.launch(x, *self._weights(x, conv_k3.prepare))
        w, b = self._weights(x, lambda w, b: (
            w.to(x.dtype), None if b is None else b.to(x.dtype)))
        return conv3d(x, w, b, self.stride)


class GroupNorm8(nn.Module):
    """GroupNorm with float32 (float64 for a float64 input) statistics and the
    input dtype's output (``ops.group_norm``: the kernel for a no-grad bf16
    call it takes, the plain version for the rest)."""

    def __init__(self, channels: int, num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.groups = num_groups if channels >= num_groups else 1
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm.group_norm(x, self.weight, self.bias, self.groups, self.eps)


class SingleConv(nn.Sequential):
    """Order-string conv block; default 'gcr' (GN8 -> Conv3d -> ReLU).
    Submodule names follow the reference (``groupnorm``, ``conv``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, order: str = "gcr", num_groups: int = 8,
                 dtype=None):
        assert "c" in order
        has_norm = "g" in order or "b" in order
        mods = OrderedDict()
        ch = in_channels
        for c in order:
            if c == "g":
                mods["groupnorm"] = GroupNorm8(ch, num_groups)
            elif c == "c":
                mods["conv"] = TorchConv3d(in_channels, out_channels, kernel,
                                           stride, bias=not has_norm, dtype=dtype)
                ch = out_channels
            elif c == "r":
                mods["ReLU"] = nn.ReLU()
            elif c == "l":
                mods["LeakyReLU"] = nn.LeakyReLU(0.01)
            elif c == "e":
                mods["ELU"] = nn.ELU()
            else:
                raise ValueError(f"unsupported order char {c!r}")
        super().__init__(mods)


class ResNetBlock(nn.Module):
    """conv1 channel lift (identity when channels match), 'gcr' conv,
    'gc' conv, residual add, ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 order: str = "gcr", use_downsample: bool = False, dtype=None):
        super().__init__()
        self.conv1 = (TorchConv3d(in_channels, out_channels, kernel=1, dtype=dtype)
                      if in_channels != out_channels else None)
        self.conv2 = SingleConv(out_channels, out_channels, stride=stride,
                                order=order, dtype=dtype)
        n_order = order
        for c in "rel":
            n_order = n_order.replace(c, "")
        self.conv3 = SingleConv(out_channels, out_channels, order=n_order,
                                dtype=dtype)
        if use_downsample:
            self.down_gn = GroupNorm8(out_channels)
            self.down_conv = TorchConv3d(out_channels, out_channels, kernel=1,
                                         stride=stride, bias=False, dtype=dtype)
        else:
            self.down_gn = self.down_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.conv1 is None else self.conv1(x)
        out = self.conv3(self.conv2(residual))
        if self.down_conv is not None:
            residual = self.down_conv(self.down_gn(residual))
        return torch.relu(out + residual)


class GNConv(nn.Sequential):
    """GroupNorm(8) -> Conv3d(bias=False) [-> ReLU]: the reference's
    ``nn.Sequential`` transition/fuse primitive (keys ``.0`` GN, ``.1`` conv)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, relu: bool = False, dtype=None):
        mods = [GroupNorm8(in_channels),
                TorchConv3d(in_channels, out_channels, kernel, stride,
                            bias=False, dtype=dtype)]
        if relu:
            mods.append(nn.ReLU())
        super().__init__(*mods)
