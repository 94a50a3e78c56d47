"""Plain float32 training step of the reference: targets, loss, clipped Adam.

What the RT-Pose training step computes, stated again independently of
the program:

* targets: each pose's pelvis (joint 0) in continuous voxel coordinates
  ``(p - range_min) / voxel_size`` (x, y, z), its integer voxel truncated
  toward zero; a truncated gaussian of half-width ``min_radius`` and
  ``sigma = (2 r + 1) / 6`` with the reference's ``(2 sigma^2)^1.5``
  denominator around it; the 45 regression targets are the 15 joints'
  offsets from that integer voxel; a pose whose voxel falls outside the
  grid is dropped;
* loss: the CornerNet focal loss from logits (log-sigmoid form) over the
  heatmap, normalized by the positive count, plus ``weight`` times the
  code-weighted L1 of the regression at the target voxels;
* update: the global gradient norm clipped to ``max_norm`` (factor
  ``min(1, max_norm / (norm + 1e-6))``), Adam with the one-cycle lr and
  beta1 at the step, bias corrections with the current beta1, eps after
  the square root, and true weight decay ``- wd * lr * p``.

The loss of a batch is a sum over its samples divided by the batch's
positive count, so the reference runs one sample at a time and adds the
gradients: it fits on the card at any batch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

class Spec:
    """The geometry and loss settings a config states."""

    def __init__(self, cfg: dict):
        ds = cfg["DATASET"]
        roi = ds["ROI"][ds["RDR_CUBE"]["ROI_TYPE"]]
        self.vsize = [float(v) for v in ds["RDR_CUBE"]["GRID_SIZE"]]          # x, y, z
        self.rmin = [float(roi["x"][0]), float(roi["y"][0]), float(roi["z"][0])]
        self.grid = tuple(int(round((float(roi[a][1]) - float(roi[a][0])) / s))
                          for a, s in (("z", self.vsize[2]), ("y", self.vsize[1]),
                                       ("x", self.vsize[0])))
        ph = cfg["model"]["pose_head"]
        self.weight = float(ph["weight"])
        self.code_w = [float(v) for v in ph["code_weights"]]
        self.radius = int(cfg["train_cfg"]["assigner"].get("min_radius", 2))
        lr = cfg["lr_config"]
        self.lr_max, self.div, self.pct = (float(lr["lr_max"]), float(lr["div_factor"]),
                                           float(lr["pct_start"]))
        self.moms = [float(m) for m in lr["moms"]]
        self.wd = float(cfg["optimizer"]["wd"])
        self.beta2 = 0.99 if cfg["optimizer"].get("fixed_wd", True) else 0.999
        self.max_norm = float(cfg["optimizer_config"]["grad_clip"]["max_norm"])


def targets(pose: torch.Tensor, spec: Spec):
    """One sample's (15, 3) world pose -> (hm (Z, Y, X), flat index, valid,
    (45,) offsets)."""
    Z, Y, X = spec.grid
    dev = pose.device
    c = torch.stack([(pose[:, a] - spec.rmin[a]) / spec.vsize[a] for a in range(3)], dim=1)
    ci = c[0].to(torch.int64)                                  # truncation toward zero
    x, y, z = (int(v) for v in ci.tolist())
    valid = 0 <= x < X and 0 <= y < Y and 0 <= z < Z
    hm = torch.zeros((Z, Y, X), dtype=torch.float32, device=dev)
    if valid:
        r = spec.radius
        sigma = (2 * r + 1) / 6.0
        zz = torch.arange(Z, device=dev)[:, None, None] - z
        yy = torch.arange(Y, device=dev)[None, :, None] - y
        xx = torch.arange(X, device=dev)[None, None, :] - x
        d2 = (xx * xx + yy * yy + zz * zz).to(torch.float32)
        inside = (zz.abs() <= r) & (yy.abs() <= r) & (xx.abs() <= r)
        hm = torch.where(inside, torch.exp(-d2 / (2 * sigma * sigma) ** 1.5), hm)
    off = (c - ci[None].to(torch.float32)).reshape(-1)
    ind = (z * Y + y) * X + x if valid else 0
    return hm, ind, valid, off if valid else torch.zeros_like(off)


def sample_loss(model, cube: torch.Tensor, pose: torch.Tensor, spec: Spec, num_pos: float,
                sparse: bool = False) -> torch.Tensor:
    """One sample's additive share of the batch loss (``num_pos`` the
    batch's positive count)."""
    hm_t, ind, valid, off = targets(pose, spec)
    ind_t = torch.tensor([[ind]], device=cube.device)
    hm, reg = model.train_outputs(cube[None], ind_t, sparse=sparse)
    x = hm[0, 0].reshape(-1)
    t = hm_t.reshape(-1)
    p = torch.sigmoid(x)
    neg = torch.sum(F.logsigmoid(-x) * p * p * (1 - t) ** 4)
    pos = F.logsigmoid(x[ind]) * (1 - p[ind]) ** 2 if valid else x.new_zeros(())
    if num_pos == 0:
        focal = -neg
    else:
        focal = -(pos + neg) / max(num_pos, 1.0)
    code_w = torch.tensor(spec.code_w, device=cube.device)
    l1 = torch.abs(reg[0, 0] - off) if valid else torch.zeros_like(off)
    loc = torch.sum(l1 / (num_pos + 1e-4) * code_w)
    return focal + spec.weight * loc


def one_cycle(step: int, total: int, spec: Spec):
    """(lr, beta1) of the fastai one-cycle schedule at ``step``."""
    a1 = max(int(total * spec.pct), 1)
    low = spec.lr_max / spec.div

    def cos(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    if step < a1:
        pct = step / a1
        return cos(low, spec.lr_max, pct), cos(spec.moms[0], spec.moms[1], pct)
    pct = min(max((step - a1) / max(total - a1, 1), 0.0), 1.0)
    return cos(spec.lr_max, low / 1e4, pct), cos(spec.moms[1], spec.moms[0], pct)


class Adam:
    """The clipped one-cycle Adam with true weight decay, float32."""

    def __init__(self, params: Sequence[torch.Tensor], spec: Spec, total_steps: int):
        self.params = list(params)
        self.spec, self.total = spec, total_steps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Apply one update; returns the clipped gradient it used."""
        s = self.spec
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        factor = torch.clamp(s.max_norm / (norm + 1e-6), max=1.0)
        lr, b1 = one_cycle(self.t, self.total, s)
        t = self.t + 1
        clipped = []
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = g * factor
            clipped.append(g)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(s.beta2).add_((1 - s.beta2) * g * g)
            upd = -lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - s.beta2 ** t)) + 1e-8)
            p.add_(upd - s.wd * lr * p)
        self.t = t
        return clipped


def train_steps(model, batches: List[Dict[str, torch.Tensor]], spec: Spec, total_steps: int,
                preprocess: Optional[callable] = None, drop_half: bool = False):
    """Run the reference over ``batches`` (each: 'cube' (B, Z, Y, X, C) or
    raw, 'poses' (B, 15, 3)), one optimizer step each.  Returns (losses,
    the first step's clipped gradient per parameter, parameters after the
    last step).  ``drop_half``: the fault of a step that leaves half of
    the batch out and takes the mean over the rest."""
    params = [p for p in model.parameters()]
    opt = Adam(params, spec, total_steps)
    losses, first_grad = [], None
    for batch in batches:
        cubes, poses = batch["cube"], batch["poses"]
        n = cubes.shape[0]
        keep = range((n + 1) // 2) if drop_half else range(n)
        num_pos = float(sum(targets(poses[i], spec)[2] for i in keep))
        grads = [torch.zeros_like(p) for p in params]
        total = 0.0
        for i in keep:
            cube = cubes[i] if preprocess is None else preprocess(cubes[i])
            loss = sample_loss(model, cube, poses[i], spec, num_pos)
            gs = torch.autograd.grad(loss, params, allow_unused=True)
            for acc, g in zip(grads, gs):
                if g is not None:
                    acc.add_(g)
            total += float(loss.detach())
        losses.append(total)
        clipped = opt.step(grads)
        if first_grad is None:
            first_grad = [g.detach().clone() for g in clipped]
    return losses, first_grad, [p.detach().clone() for p in params]
