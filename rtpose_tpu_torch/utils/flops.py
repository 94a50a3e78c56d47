"""Model complexity: parameter count and FLOP estimation.

Counterpart of ``rtpose_tpu/utils/flops.py`` (which replaces the
reference's hook-based MAC counter, ``det3d/utils/flops_counter.py``).  The
JAX package asks XLA's cost analysis of the compiled program; the port
counts the operations PyTorch dispatches in one call through
``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
convolutions, two operations per multiply-add).
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
    sees them.  Returns None when nothing is counted (no counted operation
    ran, or the call failed), as the JAX package does without a cost
    analysis."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*example_args)
    except Exception:
        return None
    total = counter.get_total_flops()
    return float(total) if total else None
