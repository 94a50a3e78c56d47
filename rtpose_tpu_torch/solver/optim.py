"""Optimizer and LR schedule: fastai one-cycle Adam with true weight decay.

Counterpart of ``rtpose_tpu/solver/optim.py`` (reference
``det3d/solver/learning_schedules_fastai.py:70-95`` and
``fastai_optim.py:158-174``):

* one-cycle: lr cosine-anneals from ``lr_max / div_factor`` up to
  ``lr_max`` over the first ``pct_start`` of training, then down to
  ``lr_max / div_factor / 1e4``; beta1 anneals ``moms[0] -> moms[1]`` and
  back; steps past the total hold the final values;
* Adam whose beta1 follows the schedule, with bias corrections from the
  *current* beta1 (``1 - beta1^t``), eps added after the square root;
* gradients clipped by the global norm (``min(1, max_norm / (norm + 1e-6))``)
  before the moments;
* ``fixed_wd``: the update is ``-lr * mhat / (sqrt(vhat) + eps) - wd * lr * p``
  with the old ``p``, on every parameter; otherwise the decay rides the
  gradient (``g + wd * p``).

Everything is a function of the optimizer's own step count, a tensor on
the parameters' device, so a step needs nothing from the host.  The state
lives in flat float32 buffers (one per moment) that a step updates in place
(a captured step replays on the same tensors), and one step is a handful
of elementwise passes over them; ``step(finite=...)`` keeps parameters,
moments and the step count where ``finite`` is False (the train step's
NaN/Inf guard) with ``torch.where``, on the device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def _annealing_cos(start, end, pct):
    return end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1.0)


def one_cycle_values(step, total_steps: int, lr_max: float, moms=(0.95, 0.85),
                     div_factor: float = 10.0, pct_start: float = 0.4
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lr, beta1) at ``step`` as float32 tensors (``step`` an int or a
    tensor).  Phase 1 on [0, a1), phase 2 on [a1, total], clamped past it."""
    a1 = max(int(total_steps * pct_start), 1)
    low_lr = lr_max / div_factor
    step = torch.as_tensor(step).to(torch.float32)
    pct1 = step / a1
    pct2 = torch.clamp((step - a1) / max(total_steps - a1, 1), 0.0, 1.0)
    in_phase1 = step < a1
    lr = torch.where(in_phase1, _annealing_cos(low_lr, lr_max, pct1),
                     _annealing_cos(lr_max, low_lr / 1e4, pct2))
    mom = torch.where(in_phase1, _annealing_cos(moms[0], moms[1], pct1),
                      _annealing_cos(moms[1], moms[0], pct2))
    return lr, mom


def make_one_cycle_fns(total_steps, lr_max, moms=(0.95, 0.85), div_factor=10.0,
                       pct_start=0.4) -> Tuple[Callable, Callable]:
    def lr_fn(step):
        return one_cycle_values(step, total_steps, lr_max, moms, div_factor, pct_start)[0]

    def mom_fn(step):
        return one_cycle_values(step, total_steps, lr_max, moms, div_factor, pct_start)[1]

    return lr_fn, mom_fn


class AdamOneCycle:
    """Adam with scheduled lr and beta1, decoupled true weight decay and
    global-norm gradient clipping, over a list of float32 parameters.

    ``step(finite=None)`` reads each parameter's ``.grad`` (None counts as
    zero), updates the parameters in place and returns the global gradient
    norm before clipping.  ``step(grad=g)`` takes the flat gradient instead:
    data parallelism sums ``flat_grad()`` over the ranks first, so the norm,
    the clip and the update see the global gradient.  ``state_dict`` / ``load_state_dict`` use the
    layout of a torch optimizer's state dict (per-parameter ``step``,
    ``exp_avg``, ``exp_avg_sq``), so the reference's checkpoints carry it.
    """

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable,
                 mom_fn: Optional[Callable] = None, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 grad_clip_norm: Optional[float] = 35.0, fixed_wd: bool = True):
        self.params: List[torch.Tensor] = list(params)
        if not self.params:
            raise ValueError("AdamOneCycle needs parameters")
        if any(p.dtype != torch.float32 for p in self.params):
            raise ValueError("AdamOneCycle keeps float32 parameters")
        dev = self.params[0].device
        self.lr_fn, self.mom_fn = lr_fn, mom_fn
        self.beta2, self.eps = beta2, eps
        self.weight_decay, self.grad_clip_norm, self.fixed_wd = \
            weight_decay, grad_clip_norm, fixed_wd
        self.sizes = [p.numel() for p in self.params]
        n = sum(self.sizes)
        self.mu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.step_count = torch.zeros((), dtype=torch.int64, device=dev)
        # constants of a step, on the device once
        self._beta1 = torch.tensor(0.9, dtype=torch.float32, device=dev)
        self._beta2 = torch.tensor(beta2, dtype=torch.float32, device=dev)

    def _flat(self, tensors) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for t in tensors])

    def flat_grad(self, *extra: torch.Tensor) -> torch.Tensor:
        """The parameters' gradients as one flat float32 vector (None counts
        as zero), with the 1-D ``extra`` tensors appended after them."""
        return self._flat([p.grad if p.grad is not None else torch.zeros_like(p)
                           for p in self.params] + list(extra)).float()

    @torch.no_grad()
    def step(self, finite: Optional[torch.Tensor] = None,
             grad: Optional[torch.Tensor] = None) -> torch.Tensor:
        params = self.params
        g = self.flat_grad() if grad is None else grad
        p = self._flat(params)
        gnorm = torch.linalg.vector_norm(g)
        step = self.step_count
        lr = self.lr_fn(step)
        b1 = self.mom_fn(step) if self.mom_fn is not None else self._beta1
        t = (step + 1).to(torch.float32)
        if self.grad_clip_norm is not None:
            g = g * torch.clamp(self.grad_clip_norm / (gnorm + 1e-6), max=1.0)
        if not self.fixed_wd and self.weight_decay:
            g = g + self.weight_decay * p
        mu = b1 * self.mu + (1.0 - b1) * g
        nu = self.beta2 * self.nu + (1.0 - self.beta2) * torch.square(g)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(self._beta2, t)
        upd = -lr * (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        if self.fixed_wd and self.weight_decay:
            upd = upd - (self.weight_decay * lr) * p
        new_p = p + upd
        if finite is None:
            finite = torch.ones((), dtype=torch.bool, device=p.device)
        self.mu.copy_(torch.where(finite, mu, self.mu))
        self.nu.copy_(torch.where(finite, nu, self.nu))
        self.step_count.copy_(torch.where(finite, step + 1, step))
        new_p = torch.where(finite, new_p, p)
        torch._foreach_copy_(params, [v.view_as(q) for v, q in
                                      zip(torch.split(new_p, self.sizes), params)])
        return gnorm

    def state_dict(self) -> Dict:
        mus = torch.split(self.mu, self.sizes)
        nus = torch.split(self.nu, self.sizes)
        state = {i: {"step": self.step_count.clone(), "exp_avg": m.view_as(q).clone(),
                     "exp_avg_sq": v.view_as(q).clone()}
                 for i, (m, v, q) in enumerate(zip(mus, nus, self.params))}
        group = dict(beta2=self.beta2, eps=self.eps, weight_decay=self.weight_decay,
                     grad_clip_norm=self.grad_clip_norm, fixed_wd=self.fixed_wd,
                     params=list(range(len(self.params))))
        return {"state": state, "param_groups": [group]}

    def load_state_dict(self, sd: Dict) -> None:
        state = sd["state"]
        if sorted(state) != list(range(len(self.params))):
            raise ValueError(f"optimizer state for {len(state)} parameters, "
                             f"this optimizer has {len(self.params)}")
        for i, q in enumerate(self.params):
            for k in ("exp_avg", "exp_avg_sq"):
                if tuple(state[i][k].shape) != tuple(q.shape):
                    raise ValueError(f"optimizer state {i}.{k}: shape "
                                     f"{tuple(state[i][k].shape)} != {tuple(q.shape)}")
        self.mu.copy_(self._flat([state[i]["exp_avg"] for i in state]))
        self.nu.copy_(self._flat([state[i]["exp_avg_sq"] for i in state]))
        self.step_count.copy_(torch.as_tensor(state[0]["step"]).reshape(()))


def build_optimizer_from_cfg(cfg, params: Sequence[torch.Tensor],
                             total_steps: int) -> AdamOneCycle:
    """From the reference config schema: ``optimizer`` (adam, wd,
    fixed_wd), ``lr_config`` (one_cycle: lr_max, moms, div_factor,
    pct_start) and ``optimizer_config.grad_clip.max_norm``.  The
    ``fixed_wd`` branch keeps beta2 at 0.99, the reference's
    ``build_one_cycle_optimizer`` quirk (apis/train.py:157-174); otherwise
    torch's 0.999."""
    opt_cfg = dict(cfg.optimizer)
    lr_cfg = dict(cfg.lr_config)
    clip = None
    oc = cfg.get("optimizer_config", None)
    if oc and oc.get("grad_clip"):
        clip = float(oc["grad_clip"]["max_norm"])
    if opt_cfg.get("type", "adam") != "adam":
        raise NotImplementedError("only adam is supported (reference parity)")
    if lr_cfg.get("type", "one_cycle") != "one_cycle":
        raise NotImplementedError("only the one_cycle schedule is supported")
    lr_fn, mom_fn = make_one_cycle_fns(
        total_steps=total_steps, lr_max=float(lr_cfg["lr_max"]),
        moms=tuple(lr_cfg.get("moms", (0.95, 0.85))),
        div_factor=float(lr_cfg.get("div_factor", 10.0)),
        pct_start=float(lr_cfg.get("pct_start", 0.4)))
    fixed_wd = bool(opt_cfg.get("fixed_wd", True))
    return AdamOneCycle(params, lr_fn, mom_fn, beta2=0.99 if fixed_wd else 0.999,
                        weight_decay=float(opt_cfg.get("wd", 0.01)),
                        fixed_wd=fixed_wd, grad_clip_norm=clip)
