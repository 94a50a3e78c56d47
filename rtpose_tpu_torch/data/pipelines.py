"""Host-side data pipelines.

Counterpart of ``rtpose_tpu/data/pipelines.py`` (reference pipeline registry
``det3d/datasets/pipelines/``): ``Compose`` applies transforms in order
(compose.py:7-36); ``Preprocess`` and ``Voxelization`` are the LiDAR stages
(pose.py:15-142); ``AssignLabelPose`` / ``AssignLabelPose2`` are the
CenterNet target assigners (pose.py:145-541) over ``core.targets``.

Every stage runs in the loader on the host: the voxelizer in torch on the
CPU, as the JAX package runs it in ``jnp`` on the host.  No stage touches
CUDA (a forked loader worker cannot).
"""

from __future__ import annotations

import threading
from typing import Any, Dict

import numpy as np
import torch

from ..core.decode import TTA_FLIPS
from ..core.targets import PoseTargetSpec, assign_pose_targets_np
from ..ops.voxelize import VoxelizerSpec, voxelize
from ..registry import PIPELINES, build_from_cfg

# pipeline stages run from BatchLoader's worker threads (num_workers > 1);
# global-RNG sections take this lock so concurrent samples do not corrupt
# the generator state (the order across threads stays nondeterministic, the
# reference's worker processes' contract)
_rng_lock = threading.Lock()


class Compose:
    """Sequential transform application; a None output short-circuits."""

    def __init__(self, transforms):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(build_from_cfg(t, PIPELINES))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(f"transform must be dict or callable, got {t!r}")

    def __call__(self, item, info=None):
        for t in self.transforms:
            item = t(item, info)
            if item is None:
                return None
        return item


def _spec_from_cfg(cfg: Dict[str, Any], info: Dict[str, Any], mode: str) -> PoseTargetSpec:
    """A PoseTargetSpec from the reference assigner-config schema."""
    from .cruw_pose import CubeGeometry

    ds = info["DATASET"]
    roi = ds["ROI"][ds["LABEL"]["ROI_TYPE"]]
    voxel = tuple(float(v) for v in ds["RDR_CUBE"]["GRID_SIZE"])   # (x, y, z) meters
    geom = CubeGeometry.from_roi({k: list(v) for k, v in roi.items()})
    osf = tuple(int(f) for f in cfg.get("out_size_factor", (1, 1, 1)))
    return PoseTargetSpec(
        grid_zyx=tuple(g // f for g, f in zip(geom.grid_zyx, osf)),
        pc_range_min_xyz=(float(roi["x"][0]), float(roi["y"][0]), float(roi["z"][0])),
        voxel_size_xyz=voxel,
        out_size_factor_zyx=osf,
        max_poses=int(cfg.get("max_poses", 1)),
        min_radius=int(cfg.get("min_radius", 2)),
        mode=mode,
        num_classes=(1 if mode == "one_hm"
                     else len(cfg["target_assigner"]["tasks"][0]["class_names"])),
    )


class _AssignBase:
    mode: str = "one_hm"

    def __init__(self, cfg=None, **kwargs):
        self.cfg = dict(cfg) if cfg is not None else {}

    def __call__(self, item: Dict[str, Any], info=None) -> Dict[str, Any]:
        if item.get("mode") != "train":
            return item
        spec = _spec_from_cfg(self.cfg, info, self.mode)
        t = assign_pose_targets_np(item["poses"], int(item["num_poses"]), spec)
        # channels-last heatmap, per-task lists
        item["hm"] = [np.transpose(t["hm"], (1, 2, 3, 0))]
        item["ind"] = [t["ind"].astype(np.int32)]
        item["mask"] = [t["mask"]]
        item["cat"] = [t["cat"].astype(np.int32)]
        item["anno_pose"] = [t["anno_pose"]]
        return item


@PIPELINES.register_module
class AssignLabelPose(_AssignBase):
    """Per-joint heatmaps (15 classes), 3-dim offsets (pose.py:145-344)."""

    mode = "per_joint"


@PIPELINES.register_module
class AssignLabelPose2(_AssignBase):
    """Single pelvis heatmap, 45-dim regression (pose.py:346-541)."""

    mode = "one_hm"


@PIPELINES.register_module
class Preprocess:
    """LiDAR preprocessing (pose.py:15-49): transform the points into the
    radar frame with the L2R extrinsic; ``shuffle_points`` shuffles them
    with numpy's global generator (as the JAX package does, so the draws
    match it under one ``np.random.seed``)."""

    def __init__(self, cfg=None, **kwargs):
        cfg = cfg or {}
        self.shuffle_points = cfg.get("shuffle_points", False)
        self.mode = cfg.get("mode", "train")

    def __call__(self, item, info=None):
        if "lidar_pc" not in item:
            return item
        points = np.asarray(item["lidar_pc"], np.float32)
        p_l2r = np.asarray(item.get("P_L2R", np.eye(4)), np.float32)
        homo = np.concatenate([points[:, :3], np.ones((len(points), 1), np.float32)], 1)
        points = points.copy()
        points[:, :3] = (p_l2r @ homo.T).T[:, :3]
        if self.shuffle_points:
            with _rng_lock:
                np.random.shuffle(points)
        item["points"] = points
        item["num_points"] = np.int32(len(points))
        return item


@PIPELINES.register_module
class Voxelization:
    """Voxelize the points (pose.py:52-142) with ``ops.voxelize`` after a
    pad / truncate to ``max_num_points`` rows.

    * ``max_voxel_num``: an int, or [train, test]; train items voxelize
      under the first cap, every other item under the second.
    * ``double_flip``: at test time also voxelize the y-flipped, x-flipped
      and double-flipped points into ``{yflip,xflip,double_flip}_*`` keys
      (CenterPoint's semantics: a flip negates the coordinate);
      ``tta_flips`` picks which of the three sets are made.
    """

    def __init__(self, cfg=None, **kwargs):
        cfg = cfg or {}
        max_voxels = cfg.get("max_voxel_num", 20000)
        if not isinstance(max_voxels, (list, tuple)):
            max_voxels = [max_voxels, max_voxels]
        self.double_flip = bool(cfg.get("double_flip", False))
        allowed = tuple(cfg.get("tta_flips", ("yflip", "xflip", "double_flip")))
        self.tta_flips = tuple(f for f in TTA_FLIPS if f[0] in allowed)

        def spec(cap):
            return VoxelizerSpec(pc_range=tuple(cfg["range"]),
                                 voxel_size=tuple(cfg["voxel_size"]),
                                 max_points=int(cfg.get("max_points_in_voxel", 35)),
                                 max_voxels=int(cap))

        self.train_spec = spec(max_voxels[0])
        self.test_spec = spec(max_voxels[1])
        self.max_num_points = int(cfg.get("max_num_points", 65536))

    def _voxelize(self, pts: np.ndarray, spec: VoxelizerSpec) -> Dict[str, np.ndarray]:
        n = min(len(pts), self.max_num_points)
        padded = np.zeros((self.max_num_points, pts.shape[1]), np.float32)
        padded[:n] = pts[:n]
        out = voxelize(torch.from_numpy(padded), n, spec)
        return dict(voxels=out["voxels"].numpy(), coordinates=out["coors"].numpy(),
                    num_points_per_voxel=out["num_points_per_voxel"].numpy(),
                    num_voxels=out["num_voxels"].numpy())

    def __call__(self, item, info=None):
        if "points" not in item:
            return item
        train = item.get("mode") == "train"
        spec = self.train_spec if train else self.test_spec
        pts = np.asarray(item["points"], np.float32)
        item.update(self._voxelize(pts, spec))
        item["grid_zyx"] = spec.grid_size_zyx
        if self.double_flip and not train:
            for prefix, (flip_x, flip_y) in self.tta_flips:
                fp = pts.copy()
                if flip_x:
                    fp[:, 0] = -fp[:, 0]
                if flip_y:
                    fp[:, 1] = -fp[:, 1]
                for k, v in self._voxelize(fp, spec).items():
                    item[f"{prefix}_{k}"] = v
        return item
