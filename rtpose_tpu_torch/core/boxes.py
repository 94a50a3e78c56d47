"""3-D box geometry: torch on tensors, and the numpy host half.

Counterpart of ``rtpose_tpu/core/boxes.py`` (the load-bearing subset of
``det3d/core/bbox/box_np_ops.py`` / ``box_torch_ops.py``): corner
computation, yaw rotation, point-in-box tests, axis-aligned IoU, range
masking and camera<->lidar frame changes on tensors (the JAX package's
``jnp`` half), and the numpy host functions used by augmentation, GT
sampling and the KITTI-style camera pipeline (a copy of its numpy half).
Rotated IoU and NMS live in ``ops/nms.py``.

Box convention: (x, y, z, dx, dy, dz, yaw), z the box center (PCDet, as
used by the reference's active wrappers in iou3d_nms_utils).
"""

from __future__ import annotations

import numpy as np
import torch


def rotation_matrix_z(yaw) -> torch.Tensor:
    """(...,) yaw -> (..., 3, 3) rotation about z."""
    yaw = torch.as_tensor(yaw)
    c, s = torch.cos(yaw), torch.sin(yaw)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zeros], -1),
                        torch.stack([s, c, zeros], -1),
                        torch.stack([zeros, zeros, ones], -1)], -2)


def box_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 8, 3) corners (box_np_ops.center_to_corner_box3d
    semantics, z-center origin)."""
    template = torch.tensor([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ], dtype=torch.float32, device=boxes.device) / 2.0
    corners = template[None] * boxes[:, None, 3:6]
    rot = rotation_matrix_z(boxes[:, 6])                  # (N, 3, 3)
    corners = torch.einsum("nij,nkj->nki", rot, corners)
    return corners + boxes[:, None, :3]


def rotate_points_z(points: torch.Tensor, yaw) -> torch.Tensor:
    """Rotate (..., 3) points around z by yaw (box_torch_ops.rotate_points_along_z)."""
    rot = rotation_matrix_z(torch.as_tensor(yaw, dtype=points.dtype, device=points.device))
    return torch.einsum("ij,...j->...i", rot, points)


def points_in_box(points: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """(N, 3) points inside one (7,) rotated box -> (N,) bool
    (box_np_ops.points_in_rbbox semantics)."""
    local = points - box[:3]
    c, s = torch.cos(-box[6]), torch.sin(-box[6])
    lx = local[:, 0] * c - local[:, 1] * s
    ly = local[:, 0] * s + local[:, 1] * c
    lz = local[:, 2]
    return ((lx.abs() <= box[3] / 2) & (ly.abs() <= box[4] / 2)
            & (lz.abs() <= box[5] / 2))


def iou_aligned(boxes_a: torch.Tensor, boxes_b: torch.Tensor, eps: float = 0.0
                ) -> torch.Tensor:
    """Axis-aligned 2-D IoU for (N, 4)/(M, 4) [x1, y1, x2, y2] boxes
    (box_np_ops.iou_jit parity, including the +eps area convention)."""
    area_a = ((boxes_a[:, 2] - boxes_a[:, 0] + eps)
              * (boxes_a[:, 3] - boxes_a[:, 1] + eps))[:, None]
    area_b = ((boxes_b[:, 2] - boxes_b[:, 0] + eps)
              * (boxes_b[:, 3] - boxes_b[:, 1] + eps))[None, :]
    iw = torch.clamp(torch.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2])
                     - torch.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0]) + eps, min=0)
    ih = torch.clamp(torch.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3])
                     - torch.maximum(boxes_a[:, None, 1], boxes_b[None, :, 1]) + eps, min=0)
    inter = iw * ih
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def mask_boxes_outside_range(boxes: torch.Tensor, limit_range) -> torch.Tensor:
    """(N, 7) -> (N,) bool: center within [xmin, ymin, zmin, xmax, ymax, zmax]
    (box_np_ops.limit_period-range masking / post_center_limit_range)."""
    lim = torch.as_tensor(limit_range, dtype=boxes.dtype, device=boxes.device)
    return ((boxes[:, :3] >= lim[:3]) & (boxes[:, :3] <= lim[3:])).all(dim=1)


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Wrap angles into [-offset*period, (1-offset)*period) (box_np_ops)."""
    return val - torch.floor(val / period + offset) * period


def camera_to_lidar(points: torch.Tensor, r_rect: torch.Tensor,
                    velo2cam: torch.Tensor) -> torch.Tensor:
    """(N, 3) camera-frame -> lidar-frame (box_np_ops.camera_to_lidar)."""
    pts = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    inv = torch.linalg.inv(r_rect @ velo2cam)
    return (pts @ inv.T)[:, :3]


def lidar_to_camera(points: torch.Tensor, r_rect: torch.Tensor,
                    velo2cam: torch.Tensor) -> torch.Tensor:
    pts = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    return (pts @ (r_rect @ velo2cam).T)[:, :3]


# ---------------------------------------------------------------------------
# Host-side (numpy) geometry: the det3d box_np_ops / geometry surface used by
# augmentation, GT sampling and the KITTI-style camera pipeline, a copy of
# the JAX package's numpy half.
# ---------------------------------------------------------------------------


def corners_nd(dims: np.ndarray, origin=0.5) -> np.ndarray:
    """(N, ndim) dims -> (N, 2^ndim, ndim) corners relative to the origin
    fraction (box_np_ops.corners_nd:55-87, incl. its 2d/3d corner order)."""
    dims = np.asarray(dims)
    ndim = int(dims.shape[1])
    corners_norm = np.stack(
        np.unravel_index(np.arange(2 ** ndim), [2] * ndim), axis=1
    ).astype(dims.dtype)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dtype=dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(1, 2 ** ndim, ndim)


def corner_to_standup_nd(boxes_corner: np.ndarray) -> np.ndarray:
    """(N, K, ndim) corners -> (N, 2*ndim) axis-aligned envelope
    (box_np_ops:123-129)."""
    return np.concatenate([boxes_corner.min(axis=1), boxes_corner.max(axis=1)], -1)


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate (N, K, 2) point sets clockwise-positive (box_np_ops:207-221)."""
    rot_sin, rot_cos = np.sin(angles), np.cos(angles)
    rot_mat_T = np.stack([[rot_cos, -rot_sin], [rot_sin, rot_cos]])
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def rotation_3d_in_axis(points: np.ndarray, angles: np.ndarray,
                        axis: int = 0) -> np.ndarray:
    """Rotate (N, K, 3) point sets about one axis (box_np_ops:146-180)."""
    rot_sin, rot_cos = np.sin(angles), np.cos(angles)
    ones, zeros = np.ones_like(rot_cos), np.zeros_like(rot_cos)
    if axis == 1:
        rot_mat_T = np.stack([[rot_cos, zeros, -rot_sin],
                              [zeros, ones, zeros],
                              [rot_sin, zeros, rot_cos]])
    elif axis in (2, -1):
        rot_mat_T = np.stack([[rot_cos, -rot_sin, zeros],
                              [rot_sin, rot_cos, zeros],
                              [zeros, zeros, ones]])
    elif axis == 0:
        rot_mat_T = np.stack([[zeros, rot_cos, -rot_sin],
                              [zeros, rot_sin, rot_cos],
                              [ones, zeros, zeros]])
    else:
        raise ValueError("axis should be in range")
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def rotation_points_single_angle(points: np.ndarray, angle: float,
                                 axis: int = 0) -> np.ndarray:
    """Rotate (N, 3) points by one angle (box_np_ops:182-205)."""
    rot_sin, rot_cos = np.sin(angle), np.cos(angle)
    if axis == 1:
        rot_mat_T = np.array([[rot_cos, 0, -rot_sin], [0, 1, 0],
                              [rot_sin, 0, rot_cos]], dtype=points.dtype)
    elif axis in (2, -1):
        rot_mat_T = np.array([[rot_cos, -rot_sin, 0], [rot_sin, rot_cos, 0],
                              [0, 0, 1]], dtype=points.dtype)
    elif axis == 0:
        rot_mat_T = np.array([[1, 0, 0], [0, rot_cos, -rot_sin],
                              [0, rot_sin, rot_cos]], dtype=points.dtype)
    else:
        raise ValueError("axis should be in range")
    return points @ rot_mat_T


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5) -> np.ndarray:
    """(N, 2)+(N, 2)[+(N,)] -> (N, 4, 2) corners (box_np_ops:265-287)."""
    corners = corners_nd(np.asarray(dims), origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, np.asarray(angles))
    return corners + np.asarray(centers).reshape(-1, 1, 2)


def center_to_corner_box3d(centers, dims, angles=None,
                           origin=(0.5, 0.5, 0.5), axis: int = 2) -> np.ndarray:
    """(N, 3)+(N, 3)[+(N,)] -> (N, 8, 3) corners (box_np_ops:241-263)."""
    corners = corners_nd(np.asarray(dims), origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, np.asarray(angles), axis=axis)
    return corners + np.asarray(centers).reshape(-1, 1, 3)


def center_to_minmax_2d(centers, dims, origin=0.5) -> np.ndarray:
    """(box_np_ops:349-358)."""
    centers, dims = np.asarray(centers), np.asarray(dims)
    if origin == 0.5:
        return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)
    corners = center_to_corner_box2d(centers, dims, origin=origin)
    return corners[:, [0, 2]].reshape(-1, 4)


def minmax_to_corner_2d(minmax_box: np.ndarray) -> np.ndarray:
    """(N, 4) [x1,y1,x2,y2] -> (N, 4, 2) corners (box_np_ops:322-327)."""
    minmax_box = np.asarray(minmax_box)
    ndim = minmax_box.shape[-1] // 2
    center = minmax_box[..., :ndim]
    dims = minmax_box[..., ndim:] - center
    return center_to_corner_box2d(center, dims, origin=0.0)


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """(N, 5) rotated bbox -> (N, 4) nearest axis-aligned bbox
    (box_np_ops:131-144)."""
    rbboxes = np.asarray(rbboxes)
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = np.abs(rots - np.floor(rots / np.pi + 0.5) * np.pi)
    cond = (rots_0_pi_div_2 > np.pi / 4)[..., np.newaxis]
    bboxes_center = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    return center_to_minmax_2d(bboxes_center[:, :2], bboxes_center[:, 2:])


def iou_jit(boxes: np.ndarray, query_boxes: np.ndarray,
            eps: float = 1.0) -> np.ndarray:
    """(N, 4)x(K, 4) axis-aligned 2-D IoU with the +eps pixel-area convention
    (box_np_ops.iou_jit:496-536), vectorized."""
    boxes, query_boxes = np.asarray(boxes), np.asarray(query_boxes)
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0] + eps)
              * (query_boxes[:, 3] - query_boxes[:, 1] + eps))[None, :]
    area_b = ((boxes[:, 2] - boxes[:, 0] + eps)
              * (boxes[:, 3] - boxes[:, 1] + eps))[:, None]
    iw = np.clip(np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
                 - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]) + eps,
                 0, None)
    ih = np.clip(np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
                 - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]) + eps,
                 0, None)
    inter = iw * ih
    out = np.zeros((boxes.shape[0], query_boxes.shape[0]), boxes.dtype)
    pos = inter > 0
    ua = area_b + area_q - inter
    np.divide(inter, ua, out=out, where=pos)
    return out


def iou_3d_jit(boxes: np.ndarray, query_boxes: np.ndarray,
               add1: bool = True) -> np.ndarray:
    """(N, 6)x(K, 6) axis-aligned 3-D IoU, [x1,y1,z1,x2,y2,z2]
    (box_np_ops.iou_3d_jit:538-590), vectorized."""
    boxes, query_boxes = np.asarray(boxes), np.asarray(query_boxes)
    a = 1.0 if add1 else 0.0
    vol_q = np.prod(query_boxes[:, 3:6] - query_boxes[:, 0:3] + a, axis=1)[None, :]
    vol_b = np.prod(boxes[:, 3:6] - boxes[:, 0:3] + a, axis=1)[:, None]
    lo = np.maximum(boxes[:, None, 0:3], query_boxes[None, :, 0:3])
    hi = np.minimum(boxes[:, None, 3:6], query_boxes[None, :, 3:6])
    whl = hi - lo + a
    pos = np.all(whl > 0, axis=-1)
    inter = np.prod(whl, axis=-1)
    out = np.zeros((boxes.shape[0], query_boxes.shape[0]), boxes.dtype)
    np.divide(inter, vol_b + vol_q - inter, out=out, where=pos)
    return out


def projection_matrix_to_CRT_kitti(proj: np.ndarray):
    """P = C @ [R|T] decomposition via QR (box_np_ops:364-376)."""
    CR = proj[0:3, 0:3]
    CT = proj[0:3, 3]
    RinvCinv = np.linalg.inv(CR)
    Rinv, Cinv = np.linalg.qr(RinvCinv)
    C = np.linalg.inv(Cinv)
    R = np.linalg.inv(Rinv)
    T = Cinv @ CT
    return C, R, T


def get_frustum(bbox_image, C: np.ndarray, near_clip: float = 0.001,
                far_clip: float = 100.0) -> np.ndarray:
    """Image bbox -> (8, 3) camera-frame frustum corners (box_np_ops:378-396)."""
    fku = C[0, 0]
    fkv = -C[1, 1]
    u0v0 = C[0:2, 2]
    z_points = np.array([near_clip] * 4 + [far_clip] * 4, dtype=C.dtype)[:, None]
    b = bbox_image
    box_corners = np.array(
        [[b[0], b[1]], [b[0], b[3]], [b[2], b[3]], [b[2], b[1]]], dtype=C.dtype)
    near_box_corners = (box_corners - u0v0) / np.array(
        [fku / near_clip, -fkv / near_clip], dtype=C.dtype)
    far_box_corners = (box_corners - u0v0) / np.array(
        [fku / far_clip, -fkv / far_clip], dtype=C.dtype)
    ret_xy = np.concatenate([near_box_corners, far_box_corners], axis=0)
    return np.concatenate([ret_xy, z_points], axis=1)


def project_to_image(points_3d: np.ndarray, proj_mat: np.ndarray) -> np.ndarray:
    """(..., 3) camera points -> (..., 2) pixels (box_np_ops:441-448)."""
    points_shape = list(points_3d.shape)
    points_shape[-1] = 1
    points_4 = np.concatenate([points_3d, np.ones(points_shape)], axis=-1)
    point_2d = points_4 @ proj_mat.T
    return point_2d[..., :2] / point_2d[..., 2:3]


def camera_to_lidar_np(points: np.ndarray, r_rect: np.ndarray,
                       velo2cam: np.ndarray) -> np.ndarray:
    """Numpy dual of camera_to_lidar (box_np_ops:450-457)."""
    points_shape = list(points.shape[:-1])
    if points.shape[-1] == 3:
        points = np.concatenate([points, np.ones(points_shape + [1])], axis=-1)
    lidar_points = points @ np.linalg.inv((r_rect @ velo2cam).T)
    return lidar_points[..., :3]


def lidar_to_camera_np(points: np.ndarray, r_rect: np.ndarray,
                       velo2cam: np.ndarray) -> np.ndarray:
    points_shape = list(points.shape[:-1])
    if points.shape[-1] == 3:
        points = np.concatenate([points, np.ones(points_shape + [1])], axis=-1)
    return (points @ (r_rect @ velo2cam).T)[..., :3]


def box_camera_to_lidar(data: np.ndarray, r_rect: np.ndarray,
                        velo2cam: np.ndarray) -> np.ndarray:
    """(N, 7) camera boxes (x,y,z,l,h,w,r) -> lidar boxes (x,y,z,w,l,h,r)
    (box_np_ops:466-473)."""
    xyz = data[:, 0:3]
    l, h, w = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    r = data[:, 6:7]
    xyz_lidar = camera_to_lidar_np(xyz, r_rect, velo2cam)
    return np.concatenate([xyz_lidar, w, l, h, r], axis=1)


def box_lidar_to_camera(data: np.ndarray, r_rect: np.ndarray,
                        velo2cam: np.ndarray) -> np.ndarray:
    """(box_np_ops:474-481)."""
    xyz_lidar = data[:, 0:3]
    w, l, h = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    r = data[:, 6:7]
    xyz = lidar_to_camera_np(xyz_lidar, r_rect, velo2cam)
    return np.concatenate([xyz, l, h, w, r], axis=1)


def corner_to_surfaces_3d(corners: np.ndarray) -> np.ndarray:
    """(N, 8, 3) corners -> (N, 6, 4, 3) surfaces with inward normals
    (box_np_ops:650-672)."""
    surfaces = np.array([
        [corners[:, 0], corners[:, 1], corners[:, 2], corners[:, 3]],
        [corners[:, 7], corners[:, 6], corners[:, 5], corners[:, 4]],
        [corners[:, 0], corners[:, 3], corners[:, 7], corners[:, 4]],
        [corners[:, 1], corners[:, 5], corners[:, 6], corners[:, 2]],
        [corners[:, 0], corners[:, 4], corners[:, 5], corners[:, 1]],
        [corners[:, 3], corners[:, 2], corners[:, 6], corners[:, 7]],
    ]).transpose([2, 0, 1, 3])
    return surfaces


def surface_equ_3d(polygon_surfaces: np.ndarray):
    """Surface planes ax+by+cz+d=0 from first three points of each surface
    (geometry.py:203-213)."""
    surface_v = polygon_surfaces[:, :, :2, :] - polygon_surfaces[:, :, 1:3, :]
    normal_v = np.cross(surface_v[:, :, 0, :], surface_v[:, :, 1, :])
    d = np.einsum("aij, aij->ai", normal_v, polygon_surfaces[:, :, 0, :])
    return normal_v, -d


def points_in_convex_polygon_3d(points: np.ndarray,
                                polygon_surfaces: np.ndarray,
                                num_surfaces=None) -> np.ndarray:
    """(P, 3) x (N, S, K, 3) -> (P, N) bool; surfaces' normals point inward
    (geometry.points_in_convex_polygon_3d_jit:215-239), vectorized."""
    num_polygons = polygon_surfaces.shape[0]
    max_num_surfaces = polygon_surfaces.shape[1]
    if num_surfaces is None:
        num_surfaces = np.full((num_polygons,), 9999999, dtype=np.int64)
    normal_vec, d = surface_equ_3d(polygon_surfaces[:, :, :3, :])
    # sign[p, n, s] = points[p] . normal[n, s] + d[n, s]
    sign = np.einsum("pk,nsk->pns", points[:, :3], normal_vec) + d[None]
    active = (np.arange(max_num_surfaces)[None, :] < num_surfaces[:, None])[None]
    return ~np.any((sign >= 0) & active, axis=2)


def points_in_convex_polygon(points: np.ndarray, polygon: np.ndarray,
                             clockwise: bool = True) -> np.ndarray:
    """(P, 2) x (N, K, 2) -> (P, N) bool (geometry.py:328-350)."""
    num_lines = polygon.shape[1]
    polygon_next = polygon[:, [num_lines - 1] + list(range(num_lines - 1)), :]
    if clockwise:
        vec1 = (polygon - polygon_next)[np.newaxis, ...]
    else:
        vec1 = (polygon_next - polygon)[np.newaxis, ...]
    vec2 = polygon[np.newaxis, ...] - points[:, np.newaxis, np.newaxis, :]
    cross = np.cross(vec1, vec2)
    return np.all(cross > 0, axis=2)


def points_in_rbbox(points: np.ndarray, rbbox: np.ndarray, z_axis: int = 2,
                    origin=(0.5, 0.5, 0.5)) -> np.ndarray:
    """(P, 3+) x (N, 7) -> (P, N) bool (box_np_ops:641-649)."""
    rbbox_corners = center_to_corner_box3d(
        rbbox[:, :3], rbbox[:, 3:6], rbbox[:, -1], origin=origin, axis=z_axis)
    surfaces = corner_to_surfaces_3d(rbbox_corners)
    return points_in_convex_polygon_3d(points[:, :3], surfaces)


def remove_outside_points(points: np.ndarray, rect: np.ndarray,
                          Trv2c: np.ndarray, P2: np.ndarray,
                          image_shape) -> np.ndarray:
    """Keep lidar points inside the camera frustum (box_np_ops:482-494)."""
    C, R, T = projection_matrix_to_CRT_kitti(P2)
    image_bbox = [0, 0, image_shape[1], image_shape[0]]
    frustum = get_frustum(image_bbox, C)
    frustum -= T
    frustum = np.linalg.inv(R) @ frustum.T
    frustum = camera_to_lidar_np(frustum.T, rect, Trv2c)
    frustum_surfaces = corner_to_surfaces_3d(frustum[np.newaxis, ...])
    indices = points_in_convex_polygon_3d(points[:, :3], frustum_surfaces)
    return points[indices.reshape(-1)]


def change_box3d_center(box3d: np.ndarray, src, dst) -> np.ndarray:
    """Shift the box origin convention (box_np_ops.change_box3d_center_
    :800-803, non-mutating)."""
    box3d = np.array(box3d, copy=True)
    dst = np.array(dst, dtype=box3d.dtype)
    src = np.array(src, dtype=box3d.dtype)
    box3d[..., :3] += box3d[..., 3:6] * (dst - src)
    return box3d
