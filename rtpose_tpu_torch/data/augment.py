"""Point-cloud / pose augmentations (host-side numpy).

A copy of ``rtpose_tpu/data/augment.py`` (numpy only): the same seeds give
the same draws.  Parity surface for the reference's dormant augmentation
kernels
(``det3d/core/sampler/preprocess.py:19-976``): global rotation / scaling /
translation / flip of points+boxes and per-object pose noise.  The radar
path cannot be spatially augmented (the cube is a fixed sensor-frame
measurement), so these apply to the LiDAR companion modality and to pose
labels used with synthetic/aug pipelines.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def global_rotation(points: np.ndarray, boxes: Optional[np.ndarray] = None,
                    rotation: float = np.pi / 4, rng=None):
    """Rotate scene around z by U(-rotation, rotation) (prep.global_rotation)."""
    rng = rng or np.random.default_rng()
    noise = rng.uniform(-rotation, rotation)
    rot = _rot_z(noise)
    points = points.copy()
    points[:, :3] = points[:, :3] @ rot.T
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :3] = boxes[:, :3] @ rot.T
        boxes[:, 6] += noise
    return points, boxes, noise


def global_scaling(points: np.ndarray, boxes: Optional[np.ndarray] = None,
                   min_scale: float = 0.95, max_scale: float = 1.05, rng=None):
    rng = rng or np.random.default_rng()
    s = rng.uniform(min_scale, max_scale)
    points = points.copy()
    points[:, :3] *= s
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :6] *= s
    return points, boxes, s


def global_translate(points: np.ndarray, boxes: Optional[np.ndarray] = None,
                     noise_std: Tuple[float, float, float] = (0.2, 0.2, 0.2),
                     rng=None):
    rng = rng or np.random.default_rng()
    t = rng.normal(scale=noise_std, size=3).astype(np.float32)
    points = points.copy()
    points[:, :3] += t
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :3] += t
    return points, boxes, t


def random_flip_y(points: np.ndarray, boxes: Optional[np.ndarray] = None,
                  probability: float = 0.5, rng=None):
    """Flip across the x-axis (y -> -y), the reference's y-flip TODO
    (pipelines/pose.py:41)."""
    rng = rng or np.random.default_rng()
    flipped = bool(rng.random() < probability)
    if not flipped:
        return points.copy(), None if boxes is None else boxes.copy(), False
    points = points.copy()
    points[:, 1] *= -1
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, 1] *= -1
        boxes[:, 6] = -boxes[:, 6]
    return points, boxes, True


def noise_per_object(boxes: np.ndarray, points: Optional[np.ndarray] = None,
                     rotation_perturb: float = np.pi / 9,
                     center_noise_std: Tuple[float, float, float] = (1.0, 1.0, 0.5),
                     rng=None):
    """Independent per-box jitter (prep.noise_per_object_v3_ simplified):
    each box (and the points inside it) gets its own translation+yaw noise;
    a candidate perturbation is rejected when it would collide with another
    box (conservative center-distance test)."""
    from .gt_sampler import points_in_box_np

    rng = rng or np.random.default_rng()
    boxes = boxes.copy()
    points = None if points is None else points.copy()
    for i in range(len(boxes)):
        t = rng.normal(scale=center_noise_std, size=3).astype(np.float32)
        yaw = rng.uniform(-rotation_perturb, rotation_perturb)
        cand = boxes[i].copy()
        cand[:3] += t
        cand[6] += yaw
        others = np.delete(boxes, i, axis=0)
        if len(others):
            min_sep = 0.5 * (np.hypot(cand[3], cand[4])
                             + np.hypot(others[:, 3], others[:, 4]).max())
            if np.min(np.linalg.norm(others[:, :2] - cand[:2], axis=1)) < min_sep:
                continue  # would collide: keep the original box
        if points is not None:
            mask = points_in_box_np(points, boxes[i])
            local = points[mask, :3] - boxes[i][:3]
            points[mask, :3] = local @ _rot_z(yaw).T + cand[:3]
        boxes[i] = cand
    return boxes, points


def flip_pose_y(poses: np.ndarray, left_right_pairs=None) -> np.ndarray:
    """Mirror 15-joint poses across y (keypoint-aware: swaps L/R joints).

    Default pairing follows the RT-Pose joint order (pelvis, R-leg 1-3,
    L-leg 4-6, torso/neck/head 7-9, L-arm 10-12, R-arm 13-14+...).
    """
    pairs = left_right_pairs or [(1, 4), (2, 5), (3, 6), (10, 13), (11, 14)]
    out = poses.copy()
    out[..., 1] *= -1
    for a, b in pairs:
        tmp = out[..., a, :].copy()
        out[..., a, :] = out[..., b, :]
        out[..., b, :] = tmp
    return out
