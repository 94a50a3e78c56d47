"""The numbers that decide ``correct``, each held to its limit.

Training (the first three steps of the object the window drives, against
the plain float32 reference following the same three batches from the
same weights):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as the optimizer got it (its
  first moment over ``1 - beta1``, clipped), by the worst leaf: the gap
  between the program's norm of the leaf and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``update_gap``: the same for the parameters' change over the three
  steps, leaves whose reference gradient is under a thousandth of the
  median leaf's left out (they move by round-off alone).

Eval (a sample of the window's answers, drawn from the seed, against the
reference's decode of the same frames; see ``reference/evaluate.py``):
``peak_gap`` (logits), ``kpt_gap`` (voxels) and ``score_gap``, each the worst
over the sample.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch


def _norms(leaves: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def leaf_gaps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
              keep: Sequence[bool] = None) -> List[float]:
    """Each kept leaf's gap of norms over the larger of its reference norm
    and the median leaf's."""
    pn, rn = _norms(prog), _norms(ref)
    idx = [i for i in range(len(rn)) if keep is None or keep[i]]
    med = statistics.median(rn[i] for i in idx)
    return [abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in idx]


def train_numbers(prog_losses, ref_losses, prog_grad, ref_grad, prog_change,
                  ref_change) -> Dict[str, float]:
    loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_losses, ref_losses))
    if not all(math.isfinite(p) for p in prog_losses):
        loss = math.inf
    gn = _norms(ref_grad)
    med = statistics.median(gn)
    keep = [g >= 1e-3 * med for g in gn]
    grad = leaf_gaps(prog_grad, ref_grad)
    change = leaf_gaps(prog_change, ref_change, keep)
    return {"loss_gap": loss, "grad_gap": max(grad), "update_gap": max(change)}


def eval_numbers(judged: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(j[k] for j in judged) for k in ("peak_gap", "kpt_gap", "score_gap")}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and at or under its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= lim for k, lim in limits.items())


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit (the result line's last key)."""
    return {k: {"value": numbers.get(k, math.nan), "limit": limits[k]} for k in limits}
