"""Step-indexed training schedules.

Counterpart of ``rtpose_tpu/solver/schedules.py:17-121`` (reference
``LrUpdaterHook``, ``hooks/lr_updater.py:10-175``, and the solver's
``ExponentialDecay`` / ``ManualStepping``): each is a function
``step -> value`` returning a float32 tensor on the step's device, ``step``
an int or an integer tensor, as ``one_cycle_values`` takes it.  They fit
``AdamOneCycle``'s ``lr_fn`` slot.  No schedule builds a tensor from host
numbers per call (constants enter as scalars), so a train step using one
copies nothing from the host.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def with_warmup(base_fn: Callable, warmup: Optional[str] = None,
                warmup_iters: int = 500, warmup_ratio: float = 1.0 / 3.0) -> Callable:
    """Wrap a schedule with the reference's warmup modes ('constant',
    'linear', 'exp')."""
    if warmup is None:
        return base_fn
    if warmup not in ("constant", "linear", "exp"):
        raise ValueError(warmup)

    def fn(step):
        step = torch.as_tensor(step)
        lr = base_fn(step)
        k = torch.clamp(step / max(warmup_iters, 1), 0.0, 1.0)
        if warmup == "constant":
            w = lr * warmup_ratio
        elif warmup == "linear":
            w = lr * (1 - (1 - k) * (1 - warmup_ratio))
        else:
            w = lr * warmup_ratio ** (1 - k)
        return torch.where(step < warmup_iters, w, lr)

    return fn


def fixed_lr(base_lr: float) -> Callable:
    return lambda step: torch.full((), base_lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def step_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1) -> Callable:
    def fn(step):
        step = torch.as_tensor(step)
        passed = sum((step >= m).to(torch.float32) for m in milestones)
        return base_lr * gamma ** passed

    return fn


def exp_lr(base_lr: float, gamma: float) -> Callable:
    return lambda step: base_lr * gamma ** _step_f32(step)


def poly_lr(base_lr: float, max_steps: int, power: float = 1.0,
            min_lr: float = 0.0) -> Callable:
    def fn(step):
        pct = torch.clamp(_step_f32(step) / max_steps, 0.0, 1.0)
        return (base_lr - min_lr) * (1 - pct) ** power + min_lr

    return fn


def inv_lr(base_lr: float, gamma: float, power: float = 1.0) -> Callable:
    return lambda step: base_lr * (1 + gamma * _step_f32(step)) ** (-power)


def cosine_lr(base_lr: float, max_steps: int, target_ratio: float = 0.0) -> Callable:
    target = base_lr * target_ratio

    def fn(step):
        pct = torch.clamp(_step_f32(step) / max_steps, 0.0, 1.0)
        return target + 0.5 * (base_lr - target) * (torch.cos(math.pi * pct) + 1)

    return fn


def exponential_decay_staircase(base_lr: float, total_steps: int, decay_length: float,
                                decay_factor: float) -> Callable:
    """solver/learning_schedules_fastai.py ExponentialDecay(staircase=True)."""
    def fn(step):
        stage = torch.floor(_step_f32(step) / (decay_length * total_steps))
        return base_lr * decay_factor ** stage

    return fn


def manual_stepping(total_steps: int, boundaries: Sequence[float],
                    rates: Sequence[float]) -> Callable:
    """solver ManualStepping: fractional boundaries, explicit rates; the
    rate is ``rates[number of boundaries passed]``."""
    bounds = [b * total_steps for b in boundaries]

    def fn(step):
        step = torch.as_tensor(step)
        passed = sum((step >= b).to(torch.int64) for b in bounds)
        out = torch.full((), rates[0], dtype=torch.float32, device=step.device)
        for j in range(1, len(rates)):
            out = torch.where(passed == j, rates[j], out)
        return out

    return fn


def piecewise_weight(base: float, early: Optional[float] = None,
                     early_steps: int = 0) -> Callable:
    """``step -> weight``: ``early`` for the first ``early_steps`` optimizer
    steps, ``base`` afterwards (constant ``base`` when ``early`` is None).
    The train step's ``loc_weight_fn``."""
    def fn(step):
        step = torch.as_tensor(step)
        out = torch.full((), base, dtype=torch.float32, device=step.device)
        if early is None:
            return out
        return torch.where(step < early_steps, early, out)

    return fn
