"""Generate a synthetic skeleton-mode CRUW-format dataset with the port.

The CLI of ``tools/gen_skel_data.py`` (same flags, byte-identical files for
the same seed) without JAX, so the roots of the skeleton configs can be made
where only the port is installed::

    # 480 train + 96 test frames (hr3d_one_hm_doppler_skel480.py, ...)
    python -m rtpose_tpu_torch.tools.gen_skel_data /tmp/skel_data3 \
        --num_seqs 48 --seed 3
    # the second root of the concatenated configs (train-only, seq ids 48+)
    python -m rtpose_tpu_torch.tools.gen_skel_data /tmp/skel_data4 \
        --num_seqs 48 --seed 4 --seq_offset 48 --test_frames 0
    # two people per frame (hr3d_one_hm_doppler_skel_mp2.py)
    python -m rtpose_tpu_torch.tools.gen_skel_data /tmp/skel_mp2 \
        --num_seqs 12 --seed 5 --persons_per_frame 2
    # complex cubes (hr3d_one_hm_doppler_phase.py)
    python -m rtpose_tpu_torch.tools.gen_skel_data /tmp/phase \
        --rdr_type dzyx_complex --roi_only
    # LiDAR point clouds beside the cubes (configs/lidar/voxelnet_pose.py)
    python -m rtpose_tpu_torch.tools.gen_skel_data /tmp/lidar --with_lidar --roi_only

Each full f16 Doppler frame is ~67 MB (10.5 MB with ``--roi_only``, which
pairs with ``DIR.CUBES_ARE_ROI=True`` in the config); complex frames are
twice that.  ``--with_lidar`` also writes each frame's point cloud
(``<seq>/os2-64/<frame>.npy``, ~8 KB) and its ``Lidar_frameID``; a root
without cubes comes from ``data.generate_synthetic_dataset(...,
with_lidar=True, radar_cubes=False)``, as the JAX package's.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate a synthetic CRUW-format dataset")
    p.add_argument("root", help="output directory")
    p.add_argument("--num_seqs", type=int, default=48)
    p.add_argument("--frames_per_seq", type=int, default=10, help="TRAIN frames per sequence")
    p.add_argument("--test_frames", type=int, default=2,
                   help="TEST frames per sequence (0 = no test split)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq_offset", type=int, default=0,
                   help="first sequence id (avoid collisions when concatenating two roots)")
    p.add_argument("--pose_mode", default="skeleton", choices=["skeleton", "gaussian"])
    p.add_argument("--rdr_type", default="dzyx_real")
    p.add_argument("--persons_per_frame", type=int, default=1)
    p.add_argument("--with_lidar", action="store_true",
                   help="also write per-frame LiDAR point clouds")
    p.add_argument("--roi_only", action="store_true",
                   help="write cubes pre-cropped to ROI1 (~6x less disk); pair with "
                        "DIR.CUBES_ARE_ROI=True in the config")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Write the root; returns {split: [sample keys]}."""
    args = parse_args(argv)
    from rtpose_tpu_torch.data import generate_synthetic_dataset

    keys = generate_synthetic_dataset(
        args.root, num_seqs=args.num_seqs, frames_per_seq=args.frames_per_seq,
        test_frames_per_seq=args.test_frames, rdr_type=args.rdr_type, seed=args.seed,
        pose_mode=args.pose_mode, persons_per_frame=args.persons_per_frame,
        with_lidar=args.with_lidar, seq_offset=args.seq_offset, roi_only=args.roi_only)
    print(f"wrote {args.root}: {len(keys['Train'])} train / {len(keys['Test'])} test frames")
    return keys


if __name__ == "__main__":
    main()
