"""Step-indexed training schedules.

Counterpart of ``rtpose_tpu/solver/schedules.py:106-121``
(``piecewise_weight``); the augmentation schedules are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def piecewise_weight(base: float, early: Optional[float] = None,
                     early_steps: int = 0) -> Callable:
    """``step -> weight`` (a float32 tensor on the step's device): ``early``
    for the first ``early_steps`` optimizer steps, ``base`` afterwards
    (constant ``base`` when ``early`` is None).  The train step's
    ``loc_weight_fn``."""
    def fn(step):
        step = torch.as_tensor(step)
        if early is None:
            return torch.tensor(base, dtype=torch.float32, device=step.device)
        return torch.where(step < early_steps,
                           torch.tensor(early, dtype=torch.float32, device=step.device),
                           torch.tensor(base, dtype=torch.float32, device=step.device))

    return fn
