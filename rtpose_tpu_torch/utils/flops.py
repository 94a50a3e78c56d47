"""Model complexity: parameter count and FLOP estimation.

Counterpart of ``rtpose_tpu/utils/flops.py`` (which replaces the
reference's hook-based MAC counter, ``det3d/utils/flops_counter.py``).  The
JAX package asks XLA's cost analysis of the compiled program; the port
counts the operations PyTorch dispatches in one call through
``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
convolutions, two operations per multiply-add).

The count is the model's, not the route's: every conv counts its full
window, whichever way it ran.  The hand kernels launch through their
``torch.ops.rtpose`` custom ops while the counter is active (``ops.conv_k3``),
and ``ops/library.py`` registers those ops' formulas and one for
``torch._int_mm`` (the int8 stock route), so a K3 conv counts the same as its
``F.conv3d`` plain version, and an int8 forward the same conv work as the
float one (the int8 trilinear resizes add their interpolation products).
One exception: an int8 stock-route product whose inner width is zero-padded
to a multiple of 8 (a 4-feature LiDAR reader) counts the padded width.

This is not XLA's number.  XLA counts only a conv's in-bounds taps, and the
JAX model's default X-folded layout issues the fold's structural zeros too:
at (1, 8, 16, 32, 32) the flagship's ``predict_sparse`` counts 3.444 GFLOP
here against 6.795 from JAX's ``estimate_flops`` on its float32 model.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Optional

import torch


def count_parameters(module_or_state_dict: Any) -> int:
    """Total element count: a module's parameters, or every tensor of a
    (nested) state dict."""
    if isinstance(module_or_state_dict, torch.nn.Module):
        return int(sum(p.numel() for p in module_or_state_dict.parameters()))
    if isinstance(module_or_state_dict, Mapping):
        return int(sum(count_parameters(v) for v in module_or_state_dict.values()))
    if isinstance(module_or_state_dict, torch.Tensor):
        return int(module_or_state_dict.numel())
    return 0


def estimate_flops(fn: Callable, *example_args) -> Optional[float]:
    """FLOPs of one call ``fn(*example_args)``, as PyTorch's flop counter
    sees them (a backward run inside the call counts too).  Returns None
    when nothing is counted (no counted operation ran, or the call failed),
    as the JAX package does without a cost analysis."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*example_args)
    except Exception:
        return None
    total = counter.get_total_flops()
    return float(total) if total else None
