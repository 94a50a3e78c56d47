"""CRUW-Pose dataset: 4-D radar cubes + 15-joint 3-D pose labels.

Counterpart of ``rtpose_tpu/data/cruw_pose.py`` (reference
``det3d/datasets/cruw_pose/cruw_pose.py:18-311``), radar path:

* label files ``Train.json`` / ``Test.json`` keyed seq -> frame -> objects;
  ``file_meta.txt`` mapping seq id -> seq directory name; the same four
  curation-excluded sequences;
* the full cube (Z32, Y128, X256) over fixed world axes, cropped to an ROI
  by nearest-index search, min-max normalized and clamped at zero
  (``get_cube``, numpy), or shipped raw and ROI-cropped in its on-disk
  dtype for the card's preprocess kernel (``get_cube_raw``);
* ``evaluation()``: MPJPE / ABS_MPJPE in millimeters, averaged per joint,
  per sequence, then overall;
* the base class's uniform aspect-group ``flag`` and ``max_poses``-padded
  ``poses`` with ``num_poses``, so a training loader batches as the JAX one
  does; ``group_by_frame`` makes one sample per frame carrying all of its
  people (the multi-person configs) where the reference makes one per
  person;
* complex cubes (``RDR_TYPE`` ``*_complex``, (2, D, Z, Y, X) pre-normalized
  real/imaginary parts, ``get_cube_phase``): ROI crop only, shipped as
  (Z, Y, X, 2D) channels-last, and never preprocessed on the card.

* ``CRUWPoseLidarDataset`` (``CRUW_POSE_Lidar_Dataset``): the LiDAR
  branch's per-frame point clouds through the ``Preprocess`` /
  ``Voxelization`` pipeline into fixed-shape voxel items;
* a config's ``pipeline`` runs on every item (``data/pipelines.py``);
* ``use_native`` (default True): a Doppler cube on a local path whose
  header reads f2/f4 loads through the native C++ loader (``native/``:
  decode, crop, normalize, clamp and transpose in one pass), as in the JAX
  package; complex cubes, cubes without Doppler, object-store paths and
  files the loader cannot read take the numpy path;
* labels, the meta file, cubes and point files are read through
  ``utils.oss`` (``open_path`` / ``load_npy``), so an ``s3://`` /
  ``oss://`` ``ROOT_DIR`` works once a client is installed;
* ``DATASET.EVAL_BOX_AP`` (``True`` or ``{min_overlap, metrics}``) adds the
  KITTI box AP of person boxes made from the joints to ``evaluation()``
  (``results["box_ap"]``, ``core/kitti_eval.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.metrics import abs_pjpe, pjpe
from ..registry import DATASETS
from ..utils.oss import is_oss_path, load_npy, open_path
from .pipelines import Compose
from .point_cloud import PointCloudDataset

EXCLUDED_SEQS = ("2023_0718_1642", "2023_0726_1602", "2023_0726_1619", "2023_0726_1620")


@dataclasses.dataclass
class CubeGeometry:
    """Static world-axis geometry of the radar cube and its ROI crop."""

    arr_z: np.ndarray
    arr_y: np.ndarray
    arr_x: np.ndarray
    roi_idx: Tuple[int, int, int, int, int, int]  # (z0, z1, y0, y1, x0, x1) inclusive

    @staticmethod
    def full_axes() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Default cube axes (cruw_pose.py:38-40)."""
        return (np.arange(-5.8, 5.8, 11.6 / 32),
                np.arange(-10.05, 10.05, 20.1 / 128),
                np.arange(0, 11.6, 11.6 / 256))

    @classmethod
    def from_roi(cls, roi: Optional[Dict[str, List[float]]]) -> "CubeGeometry":
        arr_z, arr_y, arr_x = cls.full_axes()
        if roi is None:
            return cls(arr_z, arr_y, arr_x,
                       (0, len(arr_z) - 1, 0, len(arr_y) - 1, 0, len(arr_x) - 1))
        idx = [0, len(arr_z) - 1, 0, len(arr_y) - 1, 0, len(arr_x) - 1]
        arrs = {"z": arr_z, "y": arr_y, "x": arr_x}
        for attr_i, k in enumerate(("z", "y", "x")):
            v = roi.get(k)
            if v is None:
                continue
            arr, i_min, i_max = _arr_in_roi(arrs[k], v)
            arrs[k] = arr
            idx[attr_i * 2] = i_min
            idx[attr_i * 2 + 1] = i_max
        return cls(arrs["z"], arrs["y"], arrs["x"], tuple(idx))

    @property
    def grid_zyx(self) -> Tuple[int, int, int]:
        return (len(self.arr_z), len(self.arr_y), len(self.arr_x))


def _arr_in_roi(arr: np.ndarray, min_max) -> Tuple[np.ndarray, int, int]:
    """Nearest-index ROI crop (get_arr_in_roi, cruw_pose.py:140-146)."""
    min_val, max_val = min_max
    idx_min = int(np.argmin(np.abs(arr - min_val)))
    idx_max = int(np.argmin(np.abs(arr - max_val)))
    if max_val > arr[-1]:
        return arr[idx_min : idx_max + 1], idx_min, idx_max
    return arr[idx_min:idx_max], idx_min, idx_max - 1


@DATASETS.register_module(name="CRUW_POSE_Dataset")
class CRUWPoseDataset(PointCloudDataset):
    """Map-style dataset yielding fixed-shape numpy samples; the base class
    gives the uniform aspect-group ``flag`` (reference custom.py:160-168),
    through which a shuffled training loader batches as the JAX one does."""

    NUM_JOINTS = 15
    CLASSES = ("Pedestrian",)

    def __init__(self, cfg: Dict[str, Any], label_file: str, class_names=None,
                 pipeline=None, split: str = "train", max_poses: int = 1,
                 use_native: bool = True, device_preprocess: bool = False,
                 group_by_frame: bool = False):
        ds = cfg["DATASET"]
        self.use_native = bool(use_native)
        self.rdr_type = ds.get("RDR_TYPE", "zyx_real")
        self.with_doppler = "d" in self.rdr_type
        self.is_complex = "complex" in self.rdr_type
        # device_preprocess: items carry the ROI-cropped RAW cube in the
        # on-disk dtype ('rdr_raw', (D, Z', Y', X')); cast + normalize +
        # clamp + channels-last run on the card (ops/preprocess.py).  Complex
        # cubes are pre-normalized and only cropped: they opt out
        self.device_preprocess = bool(device_preprocess) and not self.is_complex
        self.group_by_frame = bool(group_by_frame)
        self.cfg = cfg
        self.split = split
        self.class_names = class_names
        self.max_poses = int(max_poses)
        self.root_dir = ds["DIR"]["ROOT_DIR"]
        default_dir = ("DZYX_npy_f16_complex" if self.is_complex
                       else "DZYX_npy_f16" if self.with_doppler else "npy")
        self.rdr_dirname = ds["DIR"].get("RDR_DIR", default_dir)

        roi = None
        if ds["RDR_CUBE"].get("IS_CONSIDER_ROI", False):
            roi_type = ds["RDR_CUBE"].get("ROI_TYPE", ds["LABEL"].get("ROI_TYPE"))
            roi = {k: list(v) for k, v in ds["ROI"][roi_type].items()}
        self.geom = CubeGeometry.from_roi(roi)
        # DIR.CUBES_ARE_ROI: the on-disk cubes hold only the ROI region, so
        # the load-time crop is the identity
        if ds["DIR"].get("CUBES_ARE_ROI", False):
            gz, gy, gx = self.geom.grid_zyx
            self.cube_roi_idx = (0, gz - 1, 0, gy - 1, 0, gx - 1)
        else:
            self.cube_roi_idx = self.geom.roi_idx

        nv_key = "DZYX" if self.with_doppler else "RDR_CUBE"
        n0, n1 = [float(v) for v in ds[nv_key]["NORMALIZING_VALUE"]]
        self.norm_start, self.norm_scale = n0, n1 - n0

        self.seq_id_to_name = self._read_meta(
            os.path.join(self.root_dir, ds["DIR"]["META_FILE"]))
        self.label_file = os.path.join(self.root_dir, label_file)
        self.samples = self._load_samples(self.label_file)
        super().__init__(root_path=self.root_dir, info_path=self.label_file, pipeline=None,
                         test_mode=(split != "train"), class_names=class_names)
        # an empty list keeps meaning "no pipeline"
        self.pipeline = Compose(pipeline) if pipeline else None

    @staticmethod
    def _read_meta(path: str) -> Dict[str, str]:
        out = {}
        with open_path(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    seq_id, seq_name = line.split(",")
                    out[seq_id] = seq_name
        return out

    def _load_samples(self, label_file: str) -> List[dict]:
        with open_path(label_file) as f:
            by_seq = json.load(f)
        samples = []
        for seq, frames in by_seq.items():
            if self.seq_id_to_name.get(seq) in EXCLUDED_SEQS:
                continue
            for frame, objs in frames.items():
                if self.group_by_frame and objs:
                    samples.append(dict(seq=seq, frame=frame,
                                        rdr_frame=objs[0]["Radar_frameID"],
                                        lidar_frame=objs[0].get("Lidar_frameID"),
                                        poses=[o["pose"] for o in objs]))
                    continue
                for obj in objs:
                    samples.append(dict(seq=seq, frame=frame,
                                        rdr_frame=obj["Radar_frameID"],
                                        lidar_frame=obj.get("Lidar_frameID"),
                                        poses=[obj["pose"]]))
        return samples

    def __len__(self):
        return len(self.samples)

    def _cube_path(self, seq: str, rdr_frame: str) -> str:
        return os.path.join(self.root_dir, self.seq_id_to_name[seq],
                            self.rdr_dirname, f"{rdr_frame}.npy")

    def get_cube(self, seq: str, rdr_frame: str) -> np.ndarray:
        """Load, ROI-crop, normalize: channels-last (Z, Y, X, D) float32.
        The native loader takes Doppler cubes on local paths (``use_native``,
        the JAX package's dispatch, ``rtpose_tpu/data/cruw_pose.py:
        209-243``); otherwise the reference's three-pass numpy math
        (cruw_pose.py:167-185).  Complex cubes: crop only, (Z, Y, X, 2D)
        (``get_cube_phase``, cruw_pose.py:188-194)."""
        path = self._cube_path(seq, rdr_frame)
        if (self.use_native and self.with_doppler and not self.is_complex
                and not is_oss_path(path)):
            from .. import native
            probe = native.probe(path)
            if probe is not None and probe[0][0] > 0:
                out = native.load_cube(path, self.cube_roi_idx, self.norm_start,
                                       self.norm_scale, probe[0][0], self.geom.grid_zyx)
                if out is not None:
                    return out
        arr = load_npy(path).astype(np.float32)
        z0, z1, y0, y1, x0, x1 = self.cube_roi_idx
        if self.is_complex:
            arr = arr[:, :, z0 : z1 + 1, y0 : y1 + 1, x0 : x1 + 1]
            arr = arr.reshape(-1, *arr.shape[2:])           # (2D, Z, Y, X)
            return np.ascontiguousarray(np.transpose(arr, (1, 2, 3, 0)))
        if self.with_doppler:
            arr = arr[:, z0 : z1 + 1, y0 : y1 + 1, x0 : x1 + 1]
            arr = np.transpose(arr, (1, 2, 3, 0))
        else:
            arr = arr[z0 : z1 + 1, y0 : y1 + 1, x0 : x1 + 1][..., None]
        arr = (arr - self.norm_start) / self.norm_scale
        np.maximum(arr, 0.0, out=arr)
        return arr

    def get_cube_raw(self, seq: str, rdr_frame: str) -> np.ndarray:
        """ROI-cropped cube in the on-disk dtype, (D, Z', Y', X'): no cast,
        no normalize, no transpose — those run on the card."""
        arr = load_npy(self._cube_path(seq, rdr_frame))
        z0, z1, y0, y1, x0, x1 = self.cube_roi_idx
        if self.with_doppler:
            arr = arr[:, z0 : z1 + 1, y0 : y1 + 1, x0 : x1 + 1]
        else:
            arr = arr[None, z0 : z1 + 1, y0 : y1 + 1, x0 : x1 + 1]
        return np.ascontiguousarray(arr)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        s = self.samples[idx]
        poses = np.zeros((self.max_poses, self.NUM_JOINTS, 3), np.float32)
        n = min(len(s["poses"]), self.max_poses)
        for i in range(n):
            poses[i] = np.asarray(s["poses"][i], np.float32)
        item = {
            "meta": dict(seq=s["seq"], frame=s["frame"], rdr_frame=s["rdr_frame"]),
            "poses": poses,                                  # (max_poses, 15, 3)
            "num_poses": np.int32(n),
            "mode": self.split,
        }
        if self.device_preprocess:
            item["rdr_raw"] = self.get_cube_raw(s["seq"], s["rdr_frame"])
        else:
            item["rdr_tensor"] = self.get_cube(s["seq"], s["rdr_frame"])
        if self.pipeline is not None:
            item = self.pipeline(item, info=self.cfg)
        return item

    def evaluation(self, detections: Dict[str, dict], output_dir=None,
                   testset: bool = False):
        """MPJPE report, parity with cruw_pose.py:277-311.

        ``detections``: {'seq/frame/rdr_frame': {'keypoints':
        [(id, x, y, z, score), ...]}} — joint order 0..14.
        """
        with open_path(self.label_file) as f:
            gt = json.load(f)
        seq_mpjpe = defaultdict(list)
        seq_abs = defaultdict(list)
        for key, val in detections.items():
            seq, frame, _ = key.split("/")
            objs = gt[seq][frame]
            kp = np.asarray([p[1:4] for p in val["keypoints"]], np.float64)
            if len(objs) == 1 and kp.shape[0] <= self.NUM_JOINTS:
                # single-person path (cruw_pose.py:288-295 reads objects[0])
                gt_points = np.asarray(objs[0]["pose"], np.float64)
                seq_mpjpe[seq].append(pjpe(kp, gt_points))
                seq_abs[seq].append(abs_pjpe(kp, gt_points))
                continue
            # several people: greedily match each GT object to the nearest
            # unused predicted pelvis, score every matched pair
            preds = kp[: (kp.shape[0] // self.NUM_JOINTS) * self.NUM_JOINTS]
            preds = preds.reshape(-1, self.NUM_JOINTS, 3)
            used = set()
            for g in (np.asarray(o["pose"], np.float64) for o in objs):
                cands = [(np.linalg.norm(p[0] - g[0]), i)
                         for i, p in enumerate(preds) if i not in used]
                if not cands:
                    break
                _, i = min(cands)
                used.add(i)
                seq_mpjpe[seq].append(pjpe(preds[i], g))
                seq_abs[seq].append(abs_pjpe(preds[i], g))

        seq_res = {}
        for seq, vals in seq_mpjpe.items():
            name = self.seq_id_to_name[seq]
            m = np.mean(np.asarray(vals), axis=0) * 1000.0
            a = np.mean(np.asarray(seq_abs[seq]), axis=0) * 1000.0
            entry = {"MPJPE": float(np.mean(m)), "ABS_MPJPE": float(np.mean(a))}
            for j in range(m.shape[0]):
                entry[f"PJPE_{j}"] = float(m[j])
                entry[f"ABS_PJPE_{j}"] = float(a[j])
            seq_res[name] = entry

        total = {"MPJPE": float(np.mean([v["MPJPE"] for v in seq_res.values()])),
                 "ABS_MPJPE": float(np.mean([v["ABS_MPJPE"] for v in seq_res.values()]))}
        for j in range(self.NUM_JOINTS):
            total[f"PJPE_{j}"] = float(np.mean([v[f"PJPE_{j}"] for v in seq_res.values()]))
            total[f"ABS_PJPE_{j}"] = float(np.mean([v[f"ABS_PJPE_{j}"] for v in seq_res.values()]))
        res = {"results": total, "seq_results": {**seq_res, "ALL": total}}
        # DATASET.EVAL_BOX_AP: true, or {min_overlap, metrics}
        box_ap_cfg = self.cfg["DATASET"].get("EVAL_BOX_AP", False)
        if box_ap_cfg:
            opts = box_ap_cfg if isinstance(box_ap_cfg, dict) else {}
            res["results"]["box_ap"] = self._box_ap_report(
                detections, gt, min_overlap=float(opts.get("min_overlap", 0.25)),
                metrics=tuple(opts.get("metrics", ("bev", "3d"))))
        return res, None

    def get_sensor_data(self, query: int) -> Dict[str, Any]:
        """Raw sensor tensors, metadata and annotations of one sample, no
        pipeline (the ``PointCloudDataset`` contract, custom.py:44-142)."""
        s = self.samples[query]
        return {
            "radar": {"cube": self.get_cube(s["seq"], s["rdr_frame"])},
            "metadata": dict(seq=s["seq"], frame=s["frame"], rdr_frame=s["rdr_frame"]),
            "annotations": {"poses": np.asarray(s["poses"], np.float32)},
        }

    @staticmethod
    def _poses_to_kitti_anno(poses, scores=None) -> Dict[str, Any]:
        """15x3 keypoint sets -> a KITTI annotation dict: a person's box is
        the axis-aligned extent of their joints (PCDet (x, y, z, dx, dy, dz,
        heading), heading 0), floored at a 0.3 m footprint so degenerate
        poses still form a matchable box; the class is ``"Pedestrian"``."""
        poses = np.asarray(poses, np.float32).reshape(-1, 15, 3)
        lo, hi = poses.min(axis=1), poses.max(axis=1)
        n = poses.shape[0]
        anno = {
            "name": np.asarray(["Pedestrian"] * n),
            "location": (lo + hi) / 2.0,
            "dimensions": np.maximum(hi - lo, np.float32(0.3)),
            "rotation_y": np.zeros(n, np.float32),
        }
        if scores is not None:
            anno["score"] = np.asarray(scores, np.float32).reshape(-1)
        return anno

    @property
    def ground_truth_annotations(self) -> List[Dict[str, Any]]:
        """Per-sample KITTI-format GT annotations (``PointCloudDataset``
        contract, custom.py:122-142)."""
        return [self._poses_to_kitti_anno(s["poses"]) for s in self.samples]

    def _box_ap_report(self, detections: Dict[str, dict], gt: Dict,
                       min_overlap: float = 0.25, metrics=("bev", "3d")) -> Dict:
        """KITTI AP over person boxes made from the keypoints, frame by
        frame: a detection's score is the mean of its joints' scores."""
        from ..core.kitti_eval import get_official_eval_result
        gt_annos, dt_annos = [], []
        for key, val in detections.items():
            seq, frame, _ = key.split("/")
            gt_annos.append(self._poses_to_kitti_anno([o["pose"] for o in gt[seq][frame]]))
            kp = np.asarray([p[1:4] for p in val["keypoints"]], np.float32)
            sc = np.asarray([p[4] for p in val["keypoints"]], np.float32)
            n_full = (kp.shape[0] // self.NUM_JOINTS) * self.NUM_JOINTS
            if n_full == 0:
                dt_annos.append(self._poses_to_kitti_anno(
                    np.zeros((0, 15, 3), np.float32), np.zeros(0, np.float32)))
                continue
            poses = kp[:n_full].reshape(-1, self.NUM_JOINTS, 3)
            scores = sc[:n_full].reshape(-1, self.NUM_JOINTS).mean(axis=1)
            dt_annos.append(self._poses_to_kitti_anno(poses, scores))
        return get_official_eval_result(gt_annos, dt_annos, list(self.CLASSES),
                                        min_overlaps=min_overlap, metrics=metrics)


@DATASETS.register_module(name="CRUW_POSE_Lidar_Dataset")
class CRUWPoseLidarDataset(CRUWPoseDataset):
    """The LiDAR branch of the CRUW-Pose stack (``rtpose_tpu/data/
    cruw_pose.py:418-471``): per-frame point clouds through the pipeline's
    Preprocess (L2R transform, optional shuffle) and Voxelization stages
    into fixed-shape voxel items for ``VoxelNet``.  Labels, metadata, the
    excluded sequences and the MPJPE evaluation are the radar dataset's.
    Point files: ``ROOT_DIR/<seq_name>/<LIDAR_DIR>/<Lidar_frameID>.npy``,
    rows (x, y, z, intensity).  Items carry the voxel keys (``*coors``, the
    pipeline's ``*coordinates`` renamed) and no ragged point arrays."""

    def __init__(self, cfg: Dict[str, Any], label_file: str, class_names=None,
                 pipeline=None, split: str = "train", max_poses: int = 1,
                 use_native: bool = True):
        super().__init__(cfg, label_file, class_names=class_names, pipeline=pipeline,
                         split=split, max_poses=max_poses, use_native=use_native)
        ds = cfg["DATASET"]
        self.lidar_dirname = ds["DIR"].get("LIDAR_DIR", "os2-64")
        self.p_l2r = np.asarray(ds.get("P_L2R", np.eye(4)), np.float32)

    def get_points(self, seq: str, lidar_frame: str) -> np.ndarray:
        path = os.path.join(self.root_dir, self.seq_id_to_name[seq], self.lidar_dirname,
                            f"{lidar_frame}.npy")
        return load_npy(path).astype(np.float32)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        s = self.samples[idx]
        poses = np.zeros((self.max_poses, self.NUM_JOINTS, 3), np.float32)
        n = min(len(s["poses"]), self.max_poses)
        for i in range(n):
            poses[i] = np.asarray(s["poses"][i], np.float32)
        item = {
            "meta": dict(seq=s["seq"], frame=s["frame"], rdr_frame=s["rdr_frame"]),
            "lidar_pc": self.get_points(s["seq"], s.get("lidar_frame") or s["rdr_frame"]),
            "P_L2R": self.p_l2r,
            "poses": poses,
            "num_poses": np.int32(n),
            "mode": self.split,
        }
        if self.pipeline is not None:
            item = self.pipeline(item, info=self.cfg)
        # the voxel layout only: rename, and drop the ragged point arrays
        for key in [k for k in item if k.endswith("coordinates")]:
            item[key[: -len("coordinates")] + "coors"] = item.pop(key)
        for k in ("lidar_pc", "points", "num_points", "P_L2R", "grid_zyx"):
            item.pop(k, None)
        return item
