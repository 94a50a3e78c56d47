"""Synthetic CRUW-format dataset generator.

Counterpart of ``rtpose_tpu/data/synthetic.py``: the same seed writes the
same files (the random draws happen in the same order), so the port's
checks need no JAX package.  Writes ``file_meta.txt``,
``Train.json``/``Test.json``, ``<seq>/<rdr_dir>/<frame>.npy`` cubes
(cruw_pose.py:61-106, 167-185: an intensity blob at each keypoint over a
noise floor, so models can fit them) and, with ``with_lidar``, per-frame
point clouds ``<seq>/os2-64/<frame>.npy`` sampled from the skeletons.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

ROI1 = {"z": [-1.0875000000000021, 4.7125],
        "y": [-5.0250000000000234, 5.024999999999931],
        "x": [0.7703125, 8.0203125]}

DEFAULT_PELVIS_RANGE = {"x": (2.0, 7.0), "y": (-3.5, 3.5), "z": (0.8, 1.2)}

# bone segments of the 15-joint skeleton (index pairs into the template)
SKELETON_EDGES = ((0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6),
                  (0, 7), (7, 8), (8, 9), (8, 10), (10, 11), (11, 12),
                  (8, 13), (13, 14))

# Upright 15-joint skeleton, meters relative to the pelvis (x range,
# y lateral, z up), CRUW keypoint order.
SKELETON_TEMPLATE = np.array([
    [0.00,  0.00,  0.00],   # Pelvis
    [0.00, -0.12, -0.05],   # RHip
    [0.02, -0.14, -0.45],   # RKnee
    [0.03, -0.15, -0.85],   # RAnkle
    [0.00,  0.12, -0.05],   # LHip
    [0.02,  0.14, -0.45],   # LKnee
    [0.03,  0.15, -0.85],   # LAnkle
    [0.00,  0.00,  0.25],   # Torso
    [0.00,  0.00,  0.50],   # Neck
    [0.01,  0.00,  0.68],   # Head
    [0.00,  0.20,  0.45],   # LShoulder
    [0.06,  0.30,  0.20],   # LElbow
    [0.10,  0.32, -0.02],   # LWrist
    [0.00, -0.20,  0.45],   # RShoulder
    [0.06, -0.30,  0.20],   # RElbow
], dtype=np.float64)


def _random_pose(rng: np.random.Generator, pelvis_range=None,
                 offset_scale=(0.25, 0.25, 0.35), z_clip=(-0.9, 2.0),
                 pose_mode: str = "gaussian") -> np.ndarray:
    """A 15-joint pose inside the ROI (meters, xyz): i.i.d. normal offsets
    around the pelvis ('gaussian') or a jittered skeleton ('skeleton')."""
    pr = pelvis_range or DEFAULT_PELVIS_RANGE
    pelvis = np.array([rng.uniform(*pr["x"]), rng.uniform(*pr["y"]),
                       rng.uniform(*pr["z"])])
    if pose_mode == "skeleton":
        yaw = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        scale = rng.uniform(0.85, 1.15)
        offsets = (scale * SKELETON_TEMPLATE) @ rot.T
        offsets += rng.normal(scale=0.03, size=(15, 3))
    else:
        offsets = rng.normal(scale=offset_scale, size=(15, 3))
    offsets[0] = 0.0
    pose = pelvis[None] + offsets
    pose[:, 2] = np.clip(pose[:, 2], *z_clip)
    return pose


def _pose_point_cloud(rng: np.random.Generator, pose: np.ndarray,
                      points_per_bone: int = 18, clutter: int = 160) -> np.ndarray:
    """A LiDAR return set (N, 4) xyz + intensity from a skeleton pose: points
    along each bone with surface jitter, extra returns at the joints, ground
    and uniform clutter at low intensity.  Each joint region has its own
    intensity level, so joints are told apart by geometry and intensity."""
    pts = []
    for a, b in SKELETON_EDGES:
        t = rng.random(points_per_bone)[:, None]
        seg = pose[a][None] * (1 - t) + pose[b][None] * t
        seg = seg + rng.normal(scale=0.03, size=seg.shape)
        lvl = (0.95 - 0.04 * a) * (1 - t[:, 0]) + (0.95 - 0.04 * b) * t[:, 0]
        pts.append(np.concatenate([seg, lvl[:, None]], 1))
    for j in range(15):
        jp = pose[j][None] + rng.normal(scale=0.02, size=(6, 3))
        pts.append(np.concatenate([jp, np.full((6, 1), 0.95 - 0.04 * j)], 1))
    half = clutter // 2
    g = np.stack([rng.uniform(0.5, 8.0, half), rng.uniform(-5.0, 5.0, half),
                  np.full(half, -0.9) + rng.normal(scale=0.02, size=half)], 1)
    u = np.stack([rng.uniform(0.5, 8.0, half), rng.uniform(-5.0, 5.0, half),
                  rng.uniform(-0.9, 2.0, half)], 1)
    lvl = rng.uniform(0.02, 0.12, (clutter, 1))
    pts.append(np.concatenate([np.concatenate([g, u], 0), lvl], 1))
    return np.concatenate(pts, 0).astype(np.float32)


def generate_synthetic_dataset(root: str, num_seqs: int = 2,
                               frames_per_seq: int = 8, doppler_bins: int = 32,
                               rdr_type: str = "dzyx_real", seed: int = 0,
                               pelvis_range=None,
                               offset_scale=(0.25, 0.25, 0.35),
                               z_clip=(-0.9, 2.0),
                               pose_mode: str = "gaussian",
                               test_frames_per_seq: int = None,
                               with_lidar: bool = False,
                               radar_cubes: bool = True,
                               persons_per_frame: int = 1,
                               seq_offset: int = 0,
                               roi_only: bool = False) -> Dict[str, list]:
    """Create the dataset under ``root``; returns {split: [sample keys]}.

    ``with_lidar=True`` also writes each frame's LiDAR point cloud
    (``<seq>/os2-64/<frame>.npy``, (N, 4) xyz + intensity in the radar
    frame, so P_L2R = I) and records ``Lidar_frameID`` in the labels;
    ``radar_cubes=False`` writes no radar cube (a LiDAR-only root, whose
    labels carry ``Lidar_frameID`` always).

    ``persons_per_frame`` > 1 puts several people in a frame, their pelvis
    centers at least 1.2 m apart (fewer when 64 draws do not find room).
    ``seq_offset`` shifts the sequence ids and names, so roots generated
    for concatenation (``ConcatDataset``) do not collide.  A complex
    ``rdr_type`` (``dzyx_complex``) writes (2, D, Z, Y, X) pre-normalized
    real and imaginary parts with a uniform random phase.
    ``roi_only=True`` writes each cube pre-cropped to the ROI1 region
    (10.5 MB instead of 67 MB per f16 Doppler frame); pair it with
    ``DIR.CUBES_ARE_ROI=True`` in the dataset config."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    with_doppler = "d" in rdr_type
    is_complex = "complex" in rdr_type
    rdr_dir = ("DZYX_npy_f16_complex" if is_complex
               else "DZYX_npy_f16" if with_doppler else "npy")
    # the on-disk dtypes: f16 Doppler cubes; zyx_real magnitudes (~2e5)
    # overflow f16 and stay f32
    dtype = np.float16 if with_doppler else np.float32

    # normalization window the loader will apply (config NORMALIZING_VALUE)
    n0, n1 = (0.0, 10.0) if with_doppler else (150000.0, 200000.0)

    Z, Y, X = 32, 128, 256                       # the full cube
    arr_z = np.arange(-5.8, 5.8, 11.6 / 32)
    arr_y = np.arange(-10.05, 10.05, 20.1 / 128)
    arr_x = np.arange(0, 11.6, 11.6 / 256)

    roi_slice = None
    if roi_only:
        from .cruw_pose import CubeGeometry
        z0, z1, y0, y1, x0, x1 = CubeGeometry.from_roi(
            {k: list(v) for k, v in ROI1.items()}).roi_idx
        roi_slice = (slice(z0, z1 + 1), slice(y0, y1 + 1), slice(x0, x1 + 1))

    meta_lines = []
    splits = {"Train": {}, "Test": {}}
    keys = {"Train": [], "Test": []}
    for s in range(seq_offset, seq_offset + num_seqs):
        seq_id = str(s)
        seq_name = f"2024_0101_{1000 + s}"
        meta_lines.append(f"{seq_id},{seq_name}")
        cube_dir = os.path.join(root, seq_name, rdr_dir)
        os.makedirs(cube_dir, exist_ok=True)
        if with_lidar:
            lidar_dir = os.path.join(root, seq_name, "os2-64")
            os.makedirs(lidar_dir, exist_ok=True)
        frame_counter = 0
        for split in ("Train", "Test"):
            splits[split].setdefault(seq_id, {})
            n_frames = (frames_per_seq if split == "Train" or
                        test_frames_per_seq is None else test_frames_per_seq)
            for fi in range(n_frames):
                frame = f"{split.lower()}_{fi:04d}"
                rdr_frame = f"{frame_counter:06d}"
                frame_counter += 1
                poses = []
                for _ in range(64):
                    cand = _random_pose(rng, pelvis_range, offset_scale, z_clip,
                                        pose_mode=pose_mode)
                    if all(np.linalg.norm(cand[0, :2] - q[0, :2]) >= 1.2 for q in poses):
                        poses.append(cand)
                    if len(poses) == persons_per_frame:
                        break
                # the point clouds draw from rng before the cube does
                if with_lidar:
                    np.save(os.path.join(lidar_dir, f"{rdr_frame}.npy"),
                            np.concatenate([_pose_point_cloud(rng, q) for q in poses], 0))
                if not radar_cubes:
                    splits[split][seq_id][frame] = [
                        {"Radar_frameID": rdr_frame, "Lidar_frameID": rdr_frame,
                         "pose": q.tolist()} for q in poses]
                    keys[split].append(f"{seq_id}/{frame}/{rdr_frame}")
                    continue

                cube = rng.uniform(n0, n0 + 0.1 * (n1 - n0),
                                   size=(Z, Y, X)).astype(np.float32)
                # continuous fractional voxel coords (sub-voxel position)
                all_pose = np.concatenate(poses, 0)               # (P * 15, 3)
                fz = (all_pose[:, 2] - arr_z[0]) / (11.6 / 32)
                fy = (all_pose[:, 1] - arr_y[0]) / (20.1 / 128)
                fx = (all_pose[:, 0] - arr_x[0]) / (11.6 / 256)
                zi = np.clip(np.round(fz).astype(int), 1, Z - 2)
                yi = np.clip(np.round(fy).astype(int), 1, Y - 2)
                xi = np.clip(np.round(fx).astype(int), 1, X - 2)
                for j in range(15 * len(poses)):
                    # per-joint intensity level (the pelvis brightest) and a
                    # gaussian splat at the continuous position
                    level = 0.95 - 0.04 * (j % 15) - 0.05 * rng.random()
                    zz, yy, xx2 = np.meshgrid(
                        np.arange(zi[j] - 1, zi[j] + 2),
                        np.arange(yi[j] - 1, yi[j] + 2),
                        np.arange(xi[j] - 1, xi[j] + 2), indexing="ij")
                    d2 = ((zz - fz[j]) ** 2 + (yy - fy[j]) ** 2
                          + (xx2 - fx[j]) ** 2)
                    blob = n0 + level * (n1 - n0) * np.exp(-d2 / (2 * 0.6 ** 2))
                    win = cube[zi[j]-1:zi[j]+2, yi[j]-1:yi[j]+2, xi[j]-1:xi[j]+2]
                    np.maximum(win, blob, out=win)
                if roi_slice is not None:
                    # crop first: what follows is elementwise, so the values
                    # are those of the cropped full cube
                    cube = cube[roi_slice]
                if with_doppler:
                    dop = rng.dirichlet(np.ones(doppler_bins)).astype(np.float32)
                    full = cube[None] * (dop[:, None, None, None] * doppler_bins)
                    if is_complex:
                        # pre-normalized (real, imag); the phase is drawn over
                        # the full cube, so a cropped root keeps its values
                        full = (full - n0) / (n1 - n0)
                        phase = rng.uniform(0, 2 * np.pi,
                                            size=(doppler_bins, Z, Y, X)).astype(np.float32)
                        if roi_slice is not None:
                            phase = phase[(slice(None),) + roi_slice]
                        full = np.stack([full * np.cos(phase), full * np.sin(phase)])
                else:
                    full = cube
                np.save(os.path.join(cube_dir, f"{rdr_frame}.npy"),
                        np.ascontiguousarray(full.astype(dtype)))
                splits[split][seq_id][frame] = [
                    dict({"Radar_frameID": rdr_frame, "pose": q.tolist()},
                         **({"Lidar_frameID": rdr_frame} if with_lidar else {}))
                    for q in poses]
                keys[split].append(f"{seq_id}/{frame}/{rdr_frame}")

    with open(os.path.join(root, "file_meta.txt"), "w") as f:
        f.write("\n".join(meta_lines) + "\n")
    for split in ("Train", "Test"):
        with open(os.path.join(root, f"{split}.json"), "w") as f:
            json.dump(splits[split], f)
    return keys
