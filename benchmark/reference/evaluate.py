"""Plain float32 eval of the reference: preprocess, dense forward, decode.

A served frame's answer is the pelvis heatmap's peak, its score (the
sigmoid of the peak's logit) and 15 keypoints, each the peak's integer
voxel plus the regressed offset, taken to world coordinates
(``voxel * voxel_size + range_min``, x, y, z).  With random weights the
heatmap has near-ties that rounding may reorder, so the reference decodes
its ``TOP`` best voxels and keeps those whose logit lies within ``MARGIN``
of its best: the near-ties.  The program's answer is judged against the
one of them whose keypoints lie nearest to it, by the keypoints' and
score's distance from it and by how far its logit lies below the
reference's best (as a served token is judged by its logit).  An answer
at any other voxel (a peak that is not the maximum, in any slot of a
batch) lies far from every near-tie's keypoints.

``MARGIN`` is set from readings on the H100 at the cells' own sizes
(``limits/*.json``): the program's matched candidate lay at most 0.98
logits below the best over 24 seeds, the program's own int8 path (the
control) at least 2.38.
"""

from __future__ import annotations

from typing import Dict

import torch

TOP = 27
MARGIN = 2.0


def preprocess(raw: torch.Tensor, norm_start: float, norm_scale: float) -> torch.Tensor:
    """(D, Z, Y, X) raw cube -> (Z, Y, X, D) float32: ``(x - n0) / n1``,
    clamped at 0."""
    return ((raw.float() - norm_start) / norm_scale).clamp_min(0.0).permute(1, 2, 3, 0)


@torch.no_grad()
def candidates(model, cube: torch.Tensor, spec) -> Dict[str, torch.Tensor]:
    """The reference's ``TOP`` best voxels of one frame: their logits
    (descending), keypoints (TOP, 15, 3) in meters, and the best logit."""
    hm, reg = model.dense(cube[None])
    Z, Y, X = hm.shape[2:]
    logits = hm[0, 0].reshape(-1)
    top_v, top_i = torch.topk(logits, TOP)
    z, rem = top_i // (Y * X), top_i % (Y * X)
    base = torch.stack([rem % X, rem // X, z], dim=1).float()                 # x, y, z
    off = reg[0].reshape(reg.shape[1], -1)[:, top_i].T.reshape(TOP, -1, 3)
    vs = torch.tensor(spec.vsize, device=cube.device)
    rmin = torch.tensor(spec.rmin, device=cube.device)
    return dict(logits=top_v, kpts=(base[:, None, :] + off) * vs + rmin, best=top_v[0])


def judge(cand: Dict[str, torch.Tensor], kpts: torch.Tensor, score: float,
          vsize) -> Dict[str, float]:
    """One served answer (kpts (15, 3) in meters, score) against the
    near-ties (the candidates within ``MARGIN`` of the best): the gap of
    the matched one's logit below the best, the largest keypoint distance
    from it (in voxels of the axis) and the score's."""
    vs = torch.tensor(vsize, device=cand["kpts"].device)
    err = ((cand["kpts"] - kpts.to(cand["kpts"])[None]) / vs).abs().amax(dim=(1, 2))
    err = torch.where(cand["best"] - cand["logits"] <= MARGIN, err, torch.inf)
    j = int(torch.argmin(err))
    return dict(peak_gap=float(cand["best"] - cand["logits"][j]),
                kpt_gap=float(err[j]),
                score_gap=abs(score - float(torch.sigmoid(cand["logits"][j]))))
