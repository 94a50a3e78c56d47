"""CenterNet pose decoding on the device.

Counterpart of ``rtpose_tpu/core/decode.py`` (reference
``CenterHead.predict`` + ``post_processing``,
``det3d/models/pose_heads/center_head.py:272-360``): take the heatmap
argmax first, evaluate the world-coordinate transform only at the winning
voxels, then format per-sample keypoint lists on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Static subset of the reference ``test_cfg`` used by decoding."""

    grid_zyx: Tuple[int, int, int]
    pc_range_min_xyz: Tuple[float, float, float]
    voxel_size_xyz: Tuple[float, float, float]
    out_size_factor_zyx: Tuple[int, int, int] = (1, 1, 1)
    score_threshold: float = 0.0


def flat_argmax(v: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """First-maximal-index argmax: a max, then a min over the matching
    positions (the tie rule of ``rtpose_tpu.core.decode.flat_argmax``)."""
    m = v.amax(dim=dim, keepdim=True)
    n = v.shape[dim]
    shape = [1] * v.dim()
    shape[dim] = n
    iota = torch.arange(n, device=v.device).view(shape).expand_as(v)
    return torch.where(v == m, iota, torch.full_like(iota, n)).amin(dim=dim)


def _voxel_to_world(vox_xyz: torch.Tensor, spec: DecodeSpec) -> torch.Tensor:
    """(..., 3) continuous voxel coords (x, y, z) -> world meters
    (center_head.py:308-310: ``x = vx * osf_x * sx + xmin``).  Scale and
    offset are Python floats, which a float32 operation rounds to float32
    as a float32 tensor of them would be: nothing is copied from the host,
    so the eval step can be captured in a CUDA graph."""
    xmin, ymin, zmin = spec.pc_range_min_xyz
    sx, sy, sz = spec.voxel_size_xyz
    fz, fy, fx = spec.out_size_factor_zyx
    return torch.stack([vox_xyz[..., 0] * (sx * fx) + xmin,
                        vox_xyz[..., 1] * (sy * fy) + ymin,
                        vox_xyz[..., 2] * (sz * fz) + zmin], dim=-1)


def _ind_to_vox_xyz(ind: torch.Tensor, Y: int, X: int) -> torch.Tensor:
    """Flat index z*(Y*X) + y*X + x -> (..., 3) float (x, y, z)."""
    z = ind // (Y * X)
    rem = ind % (Y * X)
    return torch.stack([rem % X, rem // X, z], dim=-1).float()


def decode_pose_preds(hm_logits: torch.Tensor, reg: torch.Tensor, spec: DecodeSpec):
    """Decode one task's dense predictions to world-space keypoints.

    hm_logits (B, Z, Y, X, C), reg (B, Z, Y, X, 3K).  Returns keypoints
    (B, J, 3) float32, scores (B, J) and labels (B, J) int32: per-joint peaks
    when K == 1, the pelvis peak's 15 regressed joints when C == 1.
    """
    B, Z, Y, X, C = hm_logits.shape
    K = reg.shape[-1] // 3
    logits = hm_logits.float().reshape(B, Z * Y * X, C)
    reg = reg.float().reshape(B, Z * Y * X, 3 * K)
    flat_ind = flat_argmax(logits, dim=1)                            # (B, C)
    scores_pk = torch.sigmoid(torch.gather(logits, 1, flat_ind[:, None, :])[:, 0, :])
    dev = hm_logits.device
    if K == 1:
        base = _ind_to_vox_xyz(flat_ind, Y, X)                         # (B, C, 3)
        off = torch.gather(reg, 1, flat_ind[:, :, None].expand(B, C, 3))
        kpts = _voxel_to_world(base + off, spec)
        labels = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C)
        return kpts, scores_pk, labels
    ind0 = flat_ind[:, 0]
    base = _ind_to_vox_xyz(ind0, Y, X)                                 # (B, 3)
    off = reg[torch.arange(B, device=dev), ind0].reshape(B, K, 3)
    kpts = _voxel_to_world(base[:, None, :] + off, spec)
    scores = scores_pk[:, :1].expand(B, K)
    labels = torch.arange(K, dtype=torch.int32, device=dev).expand(B, K)
    return kpts, scores, labels


def decode_pose_sparse(hm_logits: torch.Tensor, reg_at_peak: torch.Tensor,
                       peak_ind: torch.Tensor, spec: DecodeSpec):
    """Decode the sparse head outputs (hm dense, reg only at the peak); the
    same (kpts, scores, labels) as ``decode_pose_preds`` on dense outputs
    whose peak regression values match."""
    B, Z, Y, X, C = hm_logits.shape
    K = reg_at_peak.shape[-1] // 3
    logits = hm_logits.float().reshape(B, Z * Y * X, C)
    dev = hm_logits.device
    score = torch.sigmoid(logits[torch.arange(B, device=dev), peak_ind, 0])
    base = _ind_to_vox_xyz(peak_ind, Y, X)
    off = reg_at_peak.float().reshape(B, K, 3)
    kpts = _voxel_to_world(base[:, None, :] + off, spec)
    scores = score[:, None].expand(B, K)
    labels = torch.arange(K, dtype=torch.int32, device=dev).expand(B, K)
    return kpts, scores, labels


# the double-flip TTA's flipped voxel sets: (name, (flip x, flip y)); the
# pipeline writes ``{name}_*`` keys, the TTA eval step unflips each set
TTA_FLIPS = (("yflip", (False, True)), ("xflip", (True, False)),
             ("double_flip", (True, True)))


def unflip_pose_preds(hm: torch.Tensor, reg: torch.Tensor, flip_x: bool, flip_y: bool):
    """Dense head outputs computed on a flipped scene, back in the original
    frame (the double-flip TTA's unflip; CenterPoint semantics,
    ``rtpose_tpu/core/decode.py:119-150``).  hm (B, Z, Y, X, C), reg (B, Z,
    Y, X, 3K) of per-joint (x, y, z) voxel offsets from the peak's integer
    voxel.  A world flip maps continuous voxel coordinates c -> N - c but
    integer voxels k -> N - 1 - k, so the offset on a flipped axis becomes
    ``1 - off``, not ``-off``.  Valid for ranges symmetric about 0 on the
    flipped axes."""
    B = hm.shape[0]
    spatial = hm.shape[1:4]
    K = reg.shape[-1] // 3
    r = reg.reshape(B, *spatial, K, 3)
    if flip_y:
        hm = torch.flip(hm, dims=(2,))
        r = torch.flip(r, dims=(2,))
        r = torch.cat([r[..., :1], 1.0 - r[..., 1:2], r[..., 2:]], dim=-1)
    if flip_x:
        hm = torch.flip(hm, dims=(3,))
        r = torch.flip(r, dims=(3,))
        r = torch.cat([1.0 - r[..., :1], r[..., 1:]], dim=-1)
    return hm, r.reshape(B, *spatial, 3 * K)


def top_k_lowest_index(v: torch.Tensor, k: int):
    """The ``k`` largest values of each row of ``v`` (B, N) and their
    indices, equal values lowest index first: ``jax.lax.top_k``'s order,
    which ``torch.topk`` does not promise (a heatmap plateau, sigmoids that
    underflowed to 0.0).  A stable descending sort keeps the index order
    among equal values."""
    vals, idx = torch.sort(v, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def decode_pose_multi(hm_logits: torch.Tensor, reg: torch.Tensor, spec: DecodeSpec,
                      max_objects: int):
    """Multi-person decode for the one-heatmap head
    (``rtpose_tpu/core/decode.py:153-185``): CenterNet local maxima (a voxel
    equal to its 3^3 max, padding -inf) of the pelvis sigmoid, the top
    ``max_objects`` of them, each decoding its own 15 joints from the
    regression at its voxel.

    Returns kpts (B, P, K, 3) float32 world xyz and scores (B, P)."""
    B, Z, Y, X, C = hm_logits.shape
    K = reg.shape[-1] // 3
    hm = torch.sigmoid(hm_logits[..., 0].float())                     # (B, Z, Y, X)
    pooled = F.max_pool3d(hm[:, None], kernel_size=3, stride=1, padding=1)[:, 0]
    peaks = torch.where(hm == pooled, hm, torch.zeros_like(hm)).reshape(B, -1)
    scores, flat_ind = top_k_lowest_index(peaks, max_objects)          # (B, P)
    base = _ind_to_vox_xyz(flat_ind, Y, X)                             # (B, P, 3)
    regf = reg.float().reshape(B, Z * Y * X, 3 * K)
    off = torch.gather(regf, 1, flat_ind[..., None].expand(B, max_objects, 3 * K))
    kpts = _voxel_to_world(base[:, :, None, :] + off.reshape(B, max_objects, K, 3), spec)
    return kpts, scores


def post_process_pose_multi(kpts, scores, spec: DecodeSpec, metas=None):
    """``decode_pose_multi`` outputs -> per-sample keypoint lists: each pose's
    K joints tagged with its center score, poses in score order (groups of K,
    which the evaluation splits again).  A pose after the first whose score
    is at or below the threshold is dropped, also at threshold 0.0, where a
    score that underflowed to 0.0 drops its pose
    (``rtpose_tpu/core/decode.py:211-240``, kept as it is)."""
    kpts = np.asarray(kpts)
    scores = np.asarray(scores)
    B, P, K, _ = kpts.shape
    out = []
    for b in range(B):
        pts = []
        for p in range(P):
            sc = float(scores[b, p])
            if p > 0 and sc <= spec.score_threshold:
                continue
            for j in range(K):
                pts.append((j, float(kpts[b, p, j, 0]), float(kpts[b, p, j, 1]),
                            float(kpts[b, p, j, 2]), sc))
        ret = {"keypoints": pts}
        if metas is not None:
            ret["metadata"] = metas[b]
        out.append(ret)
    return out


def post_process_pose(kpts, scores, labels, spec: DecodeSpec, metas=None,
                      one_hm: bool = True):
    """Decoded arrays -> the reference's per-sample keypoint lists
    ``[(joint_id, x, y, z, score), ...]`` (center_head.py:333-360).

    One-heatmap head: joints 1..14 always, joint 0 only above the
    threshold; per-joint heads: each joint only above it.  A threshold
    <= 0 means no filtering (a sigmoid can underflow to exactly 0.0).
    """
    kpts = np.asarray(kpts)
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    B, J = scores.shape
    no_filter = spec.score_threshold <= 0.0
    out = []
    for b in range(B):
        pts = []
        for j in range(J):
            sc = float(scores[b, j])
            if no_filter or sc > spec.score_threshold or (one_hm and j > 0):
                pts.append((int(labels[b, j]), float(kpts[b, j, 0]),
                            float(kpts[b, j, 1]), float(kpts[b, j, 2]), sc))
        ret = {"keypoints": pts}
        if metas is not None:
            ret["metadata"] = metas[b]
        out.append(ret)
    return out
