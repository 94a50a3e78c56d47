"""CenterNet pose losses.

Counterpart of ``rtpose_tpu/models/losses.py:24-129`` (reference
``det3d/models/losses/centernet_loss.py``), channels-last: predictions are
(B, Z, Y, X, C) and gathers use the flat voxel index
``ind = z * (Y * X) + y * X + x``, the row order of ``reshape(B, -1, C)``.

* ``fast_focal_loss_logits`` — the shipped form: the CornerNet focal loss
  computed from logits with log-sigmoid (no gradient dead zone where the
  reference's clamp would cut it).
* ``fast_focal_loss`` — the reference's form on clamped probabilities.
* ``reg_loss`` — masked L1 at the gathered indices, normalized by the
  positive count, per output dimension;
* ``jde_embedding_loss`` — the batch-hard triplet loss of appearance
  embeddings (JDE).
All return float32; with no positive, the focal losses return the raw
negative sum (the reference's rule).  ``num_pos``: the positive count to
normalize by in place of the batch's own (data parallelism passes the
global batch's count, so each rank's loss is its additive share of the
global loss, and the no-positive rule follows the global count).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Rows of a (B, N, C) tensor at (B, M) flat indices -> (B, M, C)."""
    return torch.gather(feat, 1, ind.long()[:, :, None].expand(-1, -1, feat.shape[-1]))


def clamped_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped to [eps, 1 - eps] (center_head.py:240-242)."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


def _at_class(rows: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
    """(B, M, C) gathered rows -> (B, M) values at each object's class."""
    return torch.gather(rows, 2, cat.long()[:, :, None])[..., 0]


def _normalize(pos_loss, neg_loss, maskf, num_pos=None):
    if num_pos is None:
        num_pos = maskf.sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def fast_focal_loss_logits(logits: torch.Tensor, target: torch.Tensor,
                           ind: torch.Tensor, mask: torch.Tensor,
                           cat: torch.Tensor, num_pos=None) -> torch.Tensor:
    """CornerNet focal loss from logits (B, Z, Y, X, C); ``target`` the
    gaussian heatmap of the same shape; ``ind``/``mask``/``cat`` (B, M)."""
    B, C = logits.shape[0], logits.shape[-1]
    x = logits.float().reshape(B, -1, C)
    target_flat = target.reshape(B, -1, C)
    maskf = mask.float()
    p = torch.sigmoid(x)
    log_p = F.logsigmoid(x)
    log_not_p = F.logsigmoid(-x)
    neg_loss = torch.sum(log_not_p * torch.square(p) * torch.pow(1.0 - target_flat, 4))
    pos_log_p = _at_class(gather_feat(log_p, ind), cat)
    pos_p = _at_class(gather_feat(p, ind), cat)
    pos_loss = torch.sum(pos_log_p * torch.square(1.0 - pos_p) * maskf)
    return _normalize(pos_loss, neg_loss, maskf, num_pos)


def fast_focal_loss(out: torch.Tensor, target: torch.Tensor, ind: torch.Tensor,
                    mask: torch.Tensor, cat: torch.Tensor, num_pos=None) -> torch.Tensor:
    """CornerNet focal loss on heatmap probabilities ``out`` (already
    sigmoid-clamped, not logits), (B, Z, Y, X, C)."""
    B, C = out.shape[0], out.shape[-1]
    out_flat = out.reshape(B, -1, C)
    target_flat = target.reshape(B, -1, C)
    maskf = mask.float()
    neg_loss = torch.sum(torch.log(1.0 - out_flat) * torch.square(out_flat)
                         * torch.pow(1.0 - target_flat, 4))
    pos_pred = _at_class(gather_feat(out_flat, ind), cat)
    pos_loss = torch.sum(torch.log(pos_pred) * torch.square(1.0 - pos_pred) * maskf)
    return _normalize(pos_loss, neg_loss, maskf, num_pos)


def reg_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
             target: torch.Tensor, num_pos=None) -> torch.Tensor:
    """Masked L1 of a dense (B, Z, Y, X, D) regression at ``ind`` (B, M)
    against ``target`` (B, M, D); returns the (D,) per-dimension loss."""
    B, D = output.shape[0], output.shape[-1]
    pred = gather_feat(output.reshape(B, -1, D), ind)
    return masked_l1(pred, mask, target, num_pos)


def masked_l1(pred: torch.Tensor, mask: torch.Tensor,
              target: torch.Tensor, num_pos=None) -> torch.Tensor:
    """(B, M, D) predictions already at the objects -> the (D,) L1 loss,
    summed over batch and objects, normalized by the positive count."""
    maskf = mask.float()[:, :, None]
    l1 = torch.abs(pred * maskf - target * maskf)
    if num_pos is None:
        num_pos = maskf.sum()
    return torch.sum(l1 / (num_pos + 1e-4), dim=(0, 1))


def jde_embedding_loss(embeddings: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                       margin: float = 0.3) -> torch.Tensor:
    """Appearance-embedding metric loss (the reference's JDELoss,
    det3d/models/losses/jde_loss.py:7-54, which delegates to
    pytorch-metric-learning's TripletMarginLoss;
    ``rtpose_tpu/models/losses.py::jde_embedding_loss``).

    Batch-hard triplet margin loss over L2-normalized embeddings: each
    anchor's hardest positive (same id) and hardest negative (other id) form
    its triplet; anchors without both are left out.  Fixed shapes: padded
    entries carry mask 0.  embeddings: (N, D); ids: (N,); mask: (N,).
    """
    e = embeddings / torch.clamp(torch.linalg.norm(embeddings, dim=-1, keepdim=True), min=1e-6)
    d = torch.sum(torch.square(e[:, None, :] - e[None, :, :]), dim=-1)   # (N, N)
    same = ids[:, None] == ids[None, :]
    valid = (mask[:, None] > 0) & (mask[None, :] > 0)
    eye = torch.eye(ids.shape[0], dtype=torch.bool, device=ids.device)
    inf = torch.full_like(d, float("inf"))
    hardest_pos = torch.where(same & valid & ~eye, d, -inf).amax(dim=1)
    hardest_neg = torch.where(~same & valid, d, inf).amin(dim=1)
    has_triplet = torch.isfinite(hardest_pos) & torch.isfinite(hardest_neg)
    loss = torch.clamp(hardest_pos - hardest_neg + margin, min=0.0)
    loss = torch.where(has_triplet, loss, torch.zeros_like(loss))
    denom = torch.clamp(has_triplet.float().sum(), min=1.0)
    return loss.sum() / denom
