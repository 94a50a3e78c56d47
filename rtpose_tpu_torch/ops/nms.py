"""NMS and rotated-box overlap on tensors, with fixed output shapes.

Counterpart of ``rtpose_tpu/ops/nms.py``, which replaces two reference
native components:

* ``circle_nms`` (numba, ``det3d/core/utils/circle_nms_jit.py:4-28``):
  greedy center-distance suppression over a precomputed pairwise distance
  matrix;
* the ``iou3d_nms`` CUDA extension (``det3d/ops/iou3d_nms``): rotated-box
  BEV overlap / IoU and greedy rotated NMS.  The polygon intersection is
  Sutherland–Hodgman with a static buffer of ``MAX_CLIP_VERTS`` vertices (a
  4-gon clipped by a 4-gon has at most 8), batched over all box pairs as
  tensors: four edge passes, each over every pair at once.

The JAX package computes these with XLA ops, not a Pallas kernel, so they
stay stock PyTorch here.  Orders follow the JAX package's: scores sort
stably (``jnp.argsort`` is stable: ties keep the lower index first), and the
greedy loops visit boxes in that order.  Outputs are (post_max_size,) int32
indices padded with -1, and the kept count.

Boxes follow the PCDet convention of the reference wrappers
(``iou3d_nms_utils.py:13-120``): (x, y, z, dx, dy, dz, heading), z the box
center.
"""

from __future__ import annotations

import torch

MAX_CLIP_VERTS = 8


def _compact(keep_sorted: torch.Tensor, ids: torch.Tensor, post_max_size: int):
    """Kept ids in visiting order into a (post_max_size,) int32 buffer padded
    with -1, and the kept count."""
    kept_rank = torch.cumsum(keep_sorted.to(torch.int64), 0) - 1
    dst = torch.where(keep_sorted & (kept_rank < post_max_size), kept_rank,
                      torch.full_like(kept_rank, post_max_size))
    out = torch.zeros(post_max_size + 1, dtype=torch.int32, device=ids.device)
    out = out.scatter(0, dst, ids.to(torch.int32))[:post_max_size]
    num = torch.clamp(keep_sorted.sum().to(torch.int32), max=post_max_size)
    pos = torch.arange(post_max_size, device=ids.device)
    return torch.where(pos < num, out, torch.full_like(out, -1)), num


def _greedy(over: torch.Tensor) -> torch.Tensor:
    """Greedy suppression over an (N, N) bool 'i suppresses j' matrix in
    visiting order; returns the kept mask."""
    N = over.shape[0]
    idx = torch.arange(N, device=over.device)
    suppressed = torch.zeros(N, dtype=torch.bool, device=over.device)
    for i in range(N):
        suppressed = suppressed | ((idx > i) & over[i] & ~suppressed[i])
    return ~suppressed


def circle_nms(dets: torch.Tensor, thresh: float, post_max_size: int = 83):
    """Greedy center-distance NMS.

    dets: (N, 3) x, y, score.  Suppresses when ``dist**2 <= thresh`` (the
    reference's semantics).  Returns (keep (post_max_size,) int32 padded
    with -1, num_kept).
    """
    order = torch.argsort(-dets[:, 2], stable=True)
    xs, ys = dets[order, 0], dets[order, 1]
    d2 = (xs[:, None] - xs[None, :]) ** 2 + (ys[:, None] - ys[None, :]) ** 2
    return _compact(_greedy(d2 <= thresh), order, post_max_size)


# ---------------------------------------------------------------------------
# rotated-box geometry


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 7) PCDet boxes -> (N, 4, 2) BEV corners (counterclockwise)."""
    x, y, dx, dy, rz = boxes[:, 0], boxes[:, 1], boxes[:, 3], boxes[:, 4], boxes[:, 6]
    cx = torch.stack([dx, dx, -dx, -dx], dim=1) / 2.0
    cy = torch.stack([-dy, dy, dy, -dy], dim=1) / 2.0
    c, s = torch.cos(rz)[:, None], torch.sin(rz)[:, None]
    rx = cx * c - cy * s + x[:, None]
    ry = cx * s + cy * c + y[:, None]
    return torch.stack([rx, ry], dim=-1)


def _next_index(nverts: torch.Tensor, M: int) -> torch.Tensor:
    """(P, M) index of each vertex's successor in a polygon of nverts."""
    idx = torch.arange(M, device=nverts.device)
    return torch.where(idx + 1 >= nverts[:, None], torch.zeros_like(idx), idx + 1)


def _clip_poly_by_edge(verts, nverts, p0, p1):
    """Sutherland–Hodgman: clip P polygons (static (P, M, 2) buffers with
    nverts (P,) live vertices) by the half-planes left of edges p0 -> p1
    (P, 2) each.  Returns the clipped buffers and their vertex counts."""
    P, M, _ = verts.shape
    edge = p1 - p0
    idx = torch.arange(M, device=verts.device)
    nxt = _next_index(nverts, M)
    cur = verts
    nxtv = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))

    def side(pt):
        return (edge[:, None, 0] * (pt[..., 1] - p0[:, None, 1])
                - edge[:, None, 1] * (pt[..., 0] - p0[:, None, 0]))

    s_cur, s_nxt = side(cur), side(nxtv)
    in_cur, in_nxt = s_cur >= 0, s_nxt >= 0
    denom = s_cur - s_nxt
    t = torch.where(denom.abs() > 1e-12,
                    s_cur / torch.where(denom == 0, torch.ones_like(denom), denom),
                    torch.zeros_like(denom))
    inter = cur + (nxtv - cur) * t[..., None]

    # each input edge emits up to 2 points, in edge order: cur_i (if inside),
    # then the crossing point (if the edge crosses)
    live = idx[None, :] < nverts[:, None]
    emits = torch.stack([in_cur & live, (in_cur ^ in_nxt) & live], dim=2).reshape(P, 2 * M)
    pts = torch.stack([cur, inter], dim=2).reshape(P, 2 * M, 2)
    rank = torch.cumsum(emits.to(torch.int64), 1) - 1
    dst = torch.where(emits & (rank < M), rank, torch.full_like(rank, M))
    src = torch.where(emits[..., None], pts, torch.zeros_like(pts))
    out = torch.zeros(P, M + 1, 2, dtype=verts.dtype, device=verts.device)
    out = out.scatter(1, dst[..., None].expand(-1, -1, 2), src)[:, :M]
    return out, torch.clamp(emits.sum(1), max=M)


def _poly_area(verts, nverts):
    P, M, _ = verts.shape
    nxt = _next_index(nverts, M)
    nv = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    mask = (torch.arange(M, device=verts.device)[None, :] < nverts[:, None]).to(verts.dtype)
    cross = verts[..., 0] * nv[..., 1] - nv[..., 0] * verts[..., 1]
    return 0.5 * (cross * mask).sum(1).abs()


def _pairs_overlap(corners_a, corners_b):
    """Intersection areas of P pairs of convex quads, (P, 4, 2) each."""
    P = corners_a.shape[0]
    verts = torch.zeros(P, MAX_CLIP_VERTS, 2, dtype=corners_a.dtype, device=corners_a.device)
    verts[:, :4] = corners_a
    n = torch.full((P,), 4, dtype=torch.int64, device=corners_a.device)
    for i in range(4):
        verts, n = _clip_poly_by_edge(verts, n, corners_b[:, i], corners_b[:, (i + 1) % 4])
    return torch.where(n >= 3, _poly_area(verts, n), torch.zeros_like(verts[:, 0, 0]))


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise BEV intersection area, (N, M)."""
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    ca = box_corners_bev(boxes_a)
    cb = box_corners_bev(boxes_b)
    pa = ca[:, None].expand(N, M, 4, 2).reshape(N * M, 4, 2)
    pb = cb[None].expand(N, M, 4, 2).reshape(N * M, 4, 2)
    return _pairs_overlap(pa, pb).reshape(N, M)


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV IoU (iou3d_nms_utils.boxes_iou_bev parity)."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise 3-D IoU with z-extent overlap (boxes_iou3d_gpu parity)."""
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b)
    za1 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za2 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    zo = torch.clamp(torch.minimum(za2[:, None], zb2[None, :])
                     - torch.maximum(za1[:, None], zb1[None, :]), min=0.0)
    inter = inter_bev * zo
    va = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vb = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / torch.clamp(va + vb - inter, min=1e-6)


def rotate_nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
               pre_max_size: int | None = None, post_max_size: int = 83):
    """Greedy rotated-BEV-IoU NMS (nms_gpu parity): suppresses when the IoU
    with a kept, higher-scored box exceeds ``thresh``.  Returns (keep
    (post_max_size,) int32 padded with -1, num_kept)."""
    N = boxes.shape[0]
    if pre_max_size is not None and pre_max_size < N:
        remap = torch.argsort(-scores, stable=True)[:pre_max_size]
        boxes, scores = boxes[remap], scores[remap]
    else:
        remap = torch.arange(N, device=boxes.device)
    order = torch.argsort(-scores, stable=True)
    iou = boxes_iou_bev(boxes[order], boxes[order])
    return _compact(_greedy(iou > thresh), remap[order], post_max_size)
