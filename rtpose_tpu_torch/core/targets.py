"""CenterNet-style 3-D pose target assignment.

Counterpart of ``rtpose_tpu/core/targets.py`` (the reference assigners
``det3d/datasets/pipelines/pose.py:145-541``).  ``assign_pose_targets``
runs on the device, batched over B with no vmap;
``assign_pose_targets_np`` is the host form for one sample (numpy, the
gaussians splatted in place), behind batches that carry precomputed
targets (``BatchLoader.LIST_KEYS``).  Both modes:

* ``mode='one_hm'`` (the flagship): one "Pelvis" heatmap; each pose gives a
  gaussian peak at its pelvis voxel and a 45-dim target, all 15 keypoints'
  continuous-voxel offsets from the pelvis *integer* voxel;
* ``mode='per_joint'``: 15 heatmap classes, one peak and a 3-dim offset per
  keypoint.

Conventions (the JAX package's): world -> voxel is
``(x - xmin) / voxel_size_x / osf_x`` with ``voxel_size`` indexed (x, y, z)
and ``out_size_factor`` indexed (z, y, x); the heatmap is (Z, Y, X); the
flat index is ``z * (Y * X) + y * X + x``; integer voxels truncate toward
zero; an object whose integer voxel falls outside the grid is dropped
(``ind``/``anno_pose`` zero, ``mask`` 0).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .gaussian import dense_pose_heatmap, draw_gaussian3d

NUM_JOINTS = 15


@dataclasses.dataclass(frozen=True)
class PoseTargetSpec:
    """Static assigner configuration (mirrors the reference ``assigner`` cfg)."""

    grid_zyx: Tuple[int, int, int]                  # feature-map (Z, Y, X)
    pc_range_min_xyz: Tuple[float, float, float]    # (xmin, ymin, zmin) of the ROI
    voxel_size_xyz: Tuple[float, float, float]      # (sx, sy, sz) meters/voxel
    out_size_factor_zyx: Tuple[int, int, int] = (1, 1, 1)
    max_poses: int = 1
    min_radius: int = 2
    mode: str = "one_hm"                            # 'one_hm' | 'per_joint'
    num_classes: int = 1

    @property
    def reg_dim(self) -> int:
        return 3 * NUM_JOINTS if self.mode == "one_hm" else 3

    @property
    def max_objects(self) -> int:
        return self.max_poses if self.mode == "one_hm" else self.max_poses * NUM_JOINTS


def world_to_voxel(xyz: torch.Tensor, spec: PoseTargetSpec) -> torch.Tensor:
    """(..., 3) world xyz -> continuous voxel coords (cx, cy, cz), float32."""
    xmin, ymin, zmin = spec.pc_range_min_xyz
    sx, sy, sz = spec.voxel_size_xyz
    fz, fy, fx = spec.out_size_factor_zyx
    # scalars, not tensors built from them: a train step copies nothing from
    # the host (a CUDA graph capture would refuse the copy)
    xyz = xyz.to(torch.float32)
    return torch.stack([(xyz[..., 0] - xmin) * (1.0 / (sx * fx)),
                        (xyz[..., 1] - ymin) * (1.0 / (sy * fy)),
                        (xyz[..., 2] - zmin) * (1.0 / (sz * fz))], dim=-1)


def _world_to_voxel_np(xyz: np.ndarray, spec: PoseTargetSpec) -> np.ndarray:
    """(..., 3) world xyz -> continuous voxel coords (cx, cy, cz), float32."""
    xmin, ymin, zmin = spec.pc_range_min_xyz
    sx, sy, sz = spec.voxel_size_xyz
    fz, fy, fx = spec.out_size_factor_zyx
    out = np.empty_like(xyz, dtype=np.float32)
    out[..., 0] = (xyz[..., 0] - xmin) / sx / fx
    out[..., 1] = (xyz[..., 1] - ymin) / sy / fy
    out[..., 2] = (xyz[..., 2] - zmin) / sz / fz
    return out


def assign_pose_targets_np(poses: np.ndarray, num_poses: int,
                           spec: PoseTargetSpec) -> Dict[str, np.ndarray]:
    """Host (numpy) target assignment for one sample.

    Args:
      poses: (max_poses, 15, 3) float world keypoints (padded).
      num_poses: number of valid poses in ``poses``.

    Returns dict of numpy arrays:
      hm:        (num_classes, Z, Y, X) float32
      anno_pose: (max_objects, reg_dim) float32
      ind:       (max_objects,) int64
      mask:      (max_objects,) uint8
      cat:       (max_objects,) int64
    """
    nz, ny, nx = spec.grid_zyx
    n_obj = spec.max_objects
    hm = np.zeros((spec.num_classes, nz, ny, nx), dtype=np.float32)
    anno_pose = np.zeros((n_obj, spec.reg_dim), dtype=np.float32)
    ind = np.zeros((n_obj,), dtype=np.int64)
    mask = np.zeros((n_obj,), dtype=np.uint8)
    cat = np.zeros((n_obj,), dtype=np.int64)

    def place(slot, ct_int, radius, cls, anno):
        x, y, z = int(ct_int[0]), int(ct_int[1]), int(ct_int[2])
        if not (0 <= x < nx and 0 <= y < ny and 0 <= z < nz):
            return
        draw_gaussian3d(hm[cls], ct_int, radius)
        cat[slot] = cls
        ind[slot] = z * ny * nx + y * nx + x
        mask[slot] = 1
        anno_pose[slot] = anno

    if spec.mode == "one_hm":
        for k in range(min(num_poses, n_obj)):
            ct = _world_to_voxel_np(poses[k], spec)          # (15, 3) voxel coords
            ct_int = ct[0].astype(np.int32)                   # pelvis voxel
            place(k, ct_int, spec.min_radius, 0,
                  (ct - ct_int[None].astype(np.float32)).reshape(-1))
    else:   # per_joint: (pose, joint) flattened into object slots
        for slot in range(min(num_poses * NUM_JOINTS, n_obj)):
            p, j = divmod(slot, NUM_JOINTS)
            ct = _world_to_voxel_np(poses[p, j], spec)        # (3,)
            ct_int = ct.astype(np.int32)
            place(slot, ct_int, max(spec.min_radius, 1), j, ct - ct_int.astype(np.float32))
    return dict(hm=hm, anno_pose=anno_pose, ind=ind, mask=mask, cat=cat)


def _in_grid(ct_int: torch.Tensor, spec: PoseTargetSpec) -> torch.Tensor:
    nz, ny, nx = spec.grid_zyx
    x, y, z = ct_int[..., 0], ct_int[..., 1], ct_int[..., 2]
    return (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)


def _flat_index(ct_int: torch.Tensor, ok: torch.Tensor, spec: PoseTargetSpec):
    nz, ny, nx = spec.grid_zyx
    ind = ct_int[..., 2].long() * (ny * nx) + ct_int[..., 1].long() * nx + ct_int[..., 0].long()
    return torch.where(ok, ind, 0)


def assign_pose_targets(poses: torch.Tensor, num_poses: torch.Tensor,
                        spec: PoseTargetSpec) -> Dict[str, torch.Tensor]:
    """Targets for a batch, on the poses' device.

    Args:
      poses: (B, max_poses, 15, 3) world keypoints (padding arbitrary).
      num_poses: (B,) count of valid poses per sample.

    Returns dict:
      hm:        (B, num_classes, Z, Y, X) float32
      anno_pose: (B, max_objects, reg_dim) float32
      ind:       (B, max_objects) int64
      mask:      (B, max_objects) uint8
      cat:       (B, max_objects) int64
    """
    B = poses.shape[0]
    dev = poses.device
    n_obj = spec.max_objects
    slot = torch.arange(n_obj, device=dev)
    ct = world_to_voxel(poses, spec)                          # (B, M, 15, 3)

    if spec.mode == "one_hm":
        ct_int = ct[:, :, 0, :].to(torch.int32)               # (B, M, 3) pelvis
        ok = (slot[None] < num_poses.to(dev)[:, None]) & _in_grid(ct_int, spec)
        hm = dense_pose_heatmap(ct_int.flip(-1), ok, spec.grid_zyx,
                                spec.min_radius)[:, None]
        anno = (ct - ct_int[:, :, None, :].to(torch.float32)).reshape(B, n_obj, -1)
        return dict(hm=hm, anno_pose=torch.where(ok[..., None], anno, 0.0),
                    ind=_flat_index(ct_int, ok, spec), mask=ok.to(torch.uint8),
                    cat=torch.zeros((B, n_obj), dtype=torch.int64, device=dev))

    # per_joint: (pose, joint) flattened into object slots; class = joint
    ct = ct.reshape(B, -1, 3)[:, :n_obj]                      # (B, M*15, 3)
    ct_int = ct.to(torch.int32)
    joint = slot % NUM_JOINTS
    ok = ((slot // NUM_JOINTS)[None] < num_poses.to(dev)[:, None]) & _in_grid(ct_int, spec)
    radius = max(spec.min_radius, 1)
    zyx = ct_int.flip(-1)
    # class c's objects are the slots c, c + 15, ...
    hm = torch.stack([dense_pose_heatmap(zyx[:, c::NUM_JOINTS], ok[:, c::NUM_JOINTS],
                                         spec.grid_zyx, radius)
                      for c in range(spec.num_classes)], dim=1)
    anno = ct - ct_int.to(torch.float32)
    return dict(hm=hm, anno_pose=torch.where(ok[..., None], anno, 0.0),
                ind=_flat_index(ct_int, ok, spec), mask=ok.to(torch.uint8),
                cat=torch.where(ok, joint[None], 0))
