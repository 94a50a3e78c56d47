"""The port's box geometry, rotated NMS and KITTI box AP against
rtpose_tpu's, on the CPU, with boxes seeded through numpy: ``core.boxes``
(the torch half against the ``jnp`` one, the numpy half against its
original), ``ops.nms`` (overlaps, IoUs, ``rotate_nms`` / ``circle_nms``
keep lists, ties included), ``core.kitti_eval``, and ``DATASET.EVAL_BOX_AP``
through ``evaluation()`` (single- and multi-person detections, the LiDAR
dataset) and through ``python -m rtpose_tpu_torch.tools.test`` (tiny
radar configs with one and two people a frame, a tiny LiDAR config).

Tolerances: IoUs, overlaps and the torch geometry within ATOL = 1e-5
absolute (float32; XLA and PyTorch order a few sums differently); keep
lists, counts, the numpy half and AP values exactly equal.
"""

import os
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rtpose_tpu.core import boxes as jboxes
from rtpose_tpu.core import kitti_eval as jke
from rtpose_tpu.ops import nms as jnms

from rtpose_tpu_torch.core import boxes as tboxes
from rtpose_tpu_torch.core import kitti_eval as tke
from rtpose_tpu_torch.ops import nms as tnms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def _boxes(rng, n, spread=3.0):
    return np.concatenate([rng.uniform(-spread, spread, (n, 3)), rng.uniform(0.4, 2.0, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_torch_geometry_matches_jax():
    rng = np.random.default_rng(0)
    b = _boxes(rng, 9)
    pts = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
    pairs = [
        (jboxes.rotation_matrix_z(jnp.asarray(b[:, 6])), tboxes.rotation_matrix_z(_t(b[:, 6]))),
        (jboxes.box_corners_3d(jnp.asarray(b)), tboxes.box_corners_3d(_t(b))),
        (jboxes.rotate_points_z(jnp.asarray(pts), 0.7),
         tboxes.rotate_points_z(_t(pts), 0.7)),
        (jboxes.limit_period(jnp.asarray(b[:, 6] * 3)), tboxes.limit_period(_t(b[:, 6] * 3))),
    ]
    aa = np.sort(rng.uniform(-2, 2, (6, 2, 2)), axis=1).reshape(6, 4)[:, [0, 2, 1, 3]]
    aa = aa.astype(np.float32)
    for eps in (0.0, 1.0):
        pairs.append((jboxes.iou_aligned(jnp.asarray(aa), jnp.asarray(aa[::-1]), eps),
                      tboxes.iou_aligned(_t(aa), _t(aa[::-1].copy()), eps)))
    r = np.eye(4, dtype=np.float32)
    v = np.eye(4, dtype=np.float32)
    v[:3, :3] = np.asarray(jboxes.rotation_matrix_z(0.3))
    v[:3, 3] = (1.5, -0.2, 0.4)
    pairs += [(jboxes.lidar_to_camera(jnp.asarray(pts), jnp.asarray(r), jnp.asarray(v)),
               tboxes.lidar_to_camera(_t(pts), _t(r), _t(v))),
              (jboxes.camera_to_lidar(jnp.asarray(pts), jnp.asarray(r), jnp.asarray(v)),
               tboxes.camera_to_lidar(_t(pts), _t(r), _t(v)))]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for box in b[:4]:
        np.testing.assert_array_equal(tboxes.points_in_box(_t(pts), _t(box)).numpy(),
                                      np.asarray(jboxes.points_in_box(jnp.asarray(pts),
                                                                      jnp.asarray(box))))
    lim = [-1, -1, -1, 2, 2, 2]
    np.testing.assert_array_equal(tboxes.mask_boxes_outside_range(_t(b), lim).numpy(),
                                  np.asarray(jboxes.mask_boxes_outside_range(jnp.asarray(b), lim)))


def test_numpy_geometry_matches_jax():
    rng = np.random.default_rng(1)
    b = _boxes(rng, 6)
    dims2, dims3 = b[:, 3:5], b[:, 3:6]
    pts = rng.uniform(-3, 3, (30, 4)).astype(np.float32)
    calls = [
        ("corners_nd", (dims2,), {}), ("corners_nd", (dims3,), {"origin": (0.5, 0.5, 0)}),
        ("center_to_corner_box2d", (b[:, :2], dims2, b[:, 6]), {}),
        ("center_to_corner_box3d", (b[:, :3], dims3, b[:, 6]), {}),
        ("center_to_minmax_2d", (b[:, :2], dims2), {}),
        ("rbbox2d_to_near_bbox", (b[:, [0, 1, 3, 4, 6]],), {}),
        ("rotation_points_single_angle", (pts[:, :3], 0.4), {"axis": 2}),
        ("rotation_3d_in_axis", (jboxes.corners_nd(dims3), b[:, 6]), {"axis": 1}),
        ("points_in_rbbox", (pts, b), {}),
        ("change_box3d_center", (b, (0.5, 0.5, 0.5), (0.5, 0.5, 0.0)), {}),
        ("iou_jit", (jboxes.center_to_minmax_2d(b[:, :2], dims2),) * 2, {}),
        ("iou_3d_jit", (np.concatenate([b[:, :3] - dims3 / 2, b[:, :3] + dims3 / 2], 1),) * 2,
         {"add1": False}),
        ("minmax_to_corner_2d", (jboxes.center_to_minmax_2d(b[:, :2], dims2),), {}),
        ("corner_to_standup_nd", (jboxes.center_to_corner_box2d(b[:, :2], dims2),), {}),
        ("camera_to_lidar_np", (pts[:, :3], np.eye(4), np.eye(4) * 2), {}),
        ("box_camera_to_lidar", (b, np.eye(4), np.eye(4)), {}),
        ("box_lidar_to_camera", (b, np.eye(4), np.eye(4)), {}),
    ]
    for name, args, kw in calls:
        want, got = getattr(jboxes, name)(*args, **kw), getattr(tboxes, name)(*args, **kw)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)
    proj = np.array([[700.0, 0, 600, 40], [0, 700, 180, 0.3], [0, 0, 1, 0.005]])
    for a, c in zip(jboxes.projection_matrix_to_CRT_kitti(proj),
                    tboxes.projection_matrix_to_CRT_kitti(proj)):
        np.testing.assert_array_equal(a, c)
    cam = np.abs(pts[:, :3]) + 1.0
    np.testing.assert_array_equal(tboxes.project_to_image(cam, proj),
                                  jboxes.project_to_image(cam, proj))
    rect, trv2c = np.eye(4), np.eye(4)
    trv2c[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    lidar = rng.uniform([1, -5, -1, 0], [30, 5, 1, 1], (50, 4))
    np.testing.assert_array_equal(
        tboxes.remove_outside_points(lidar, rect, trv2c, np.vstack([proj, [0, 0, 0, 1]])[:3],
                                     (375, 1242)),
        jboxes.remove_outside_points(lidar, rect, trv2c, np.vstack([proj, [0, 0, 0, 1]])[:3],
                                     (375, 1242)))


@pytest.mark.parametrize("fn", ["box_corners_bev", "boxes_overlap_bev", "boxes_iou_bev",
                                "boxes_iou3d"])
def test_rotated_overlaps_match_jax(fn):
    rng = np.random.default_rng(2)
    a, b = _boxes(rng, 24, 2.0), _boxes(rng, 17, 2.0)
    b[:3] = a[:3]                                            # identical pairs
    b[3, :6], b[3, 6] = a[3, :6], a[3, 6] + np.pi / 2        # same center, rotated
    args = (a,) if fn == "box_corners_bev" else (a, b)
    want = np.asarray(getattr(jnms, fn)(*(jnp.asarray(x) for x in args)))
    got = getattr(tnms, fn)(*(_t(x) for x in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if fn == "boxes_iou3d":
        np.testing.assert_allclose(np.diag(got[:3, :3]), 1.0, atol=ATOL)


@pytest.mark.parametrize("pre_max_size", [None, 40])
@pytest.mark.parametrize("thresh", [0.05, 0.3])
def test_rotate_nms_matches_jax(pre_max_size, thresh):
    rng = np.random.default_rng(3)
    b = _boxes(rng, 64, 2.5)
    s = rng.random(64).astype(np.float32)
    s[[5, 9, 17]] = s[2]                         # ties: the lower index goes first
    b[9] = b[2]
    want = jnms.rotate_nms(jnp.asarray(b), jnp.asarray(s), thresh, pre_max_size=pre_max_size,
                           post_max_size=30)
    got = tnms.rotate_nms(_t(b), _t(s), thresh, pre_max_size=pre_max_size, post_max_size=30)
    assert got[0].dtype == torch.int32 and got[0].shape == (30,)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    assert int(got[1]) == int(want[1])
    kept = got[0][: int(got[1])]
    assert (got[0][int(got[1]):] == -1).all() and len(set(kept.tolist())) == len(kept)


@pytest.mark.parametrize("post_max_size", [5, 83])
def test_circle_nms_matches_jax(post_max_size):
    rng = np.random.default_rng(4)
    d = np.concatenate([rng.uniform(-3, 3, (50, 2)), rng.random((50, 1))], 1).astype(np.float32)
    d[7, 2] = d[3, 2]
    want = jnms.circle_nms(jnp.asarray(d), 0.5, post_max_size=post_max_size)
    got = tnms.circle_nms(_t(d), 0.5, post_max_size=post_max_size)
    assert got[0].tolist() == np.asarray(want[0]).tolist() and int(got[1]) == int(want[1])


def _anno(locs, dims, rots, names, scores=None):
    a = {"name": np.asarray(names), "location": np.asarray(locs, np.float32),
         "dimensions": np.asarray(dims, np.float32),
         "rotation_y": np.asarray(rots, np.float32)}
    if scores is not None:
        a["score"] = np.asarray(scores, np.float32)
    return a


def _frames(seed, n_frames=6):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for _ in range(n_frames):
        ng = int(rng.integers(0, 4))
        b = _boxes(rng, ng, 3.0)
        names = rng.choice(["Pedestrian", "Cyclist"], ng)
        gts.append(_anno(b[:, :3], b[:, 3:6], b[:, 6], names))
        jitter = b + rng.normal(scale=0.25, size=b.shape).astype(np.float32)
        extra = _boxes(rng, int(rng.integers(0, 3)), 3.0)
        d = np.concatenate([jitter, extra])
        dn = np.concatenate([names, rng.choice(["Pedestrian", "Cyclist"], len(extra))])
        sc = rng.random(len(d)).astype(np.float32)
        if len(sc) > 1:
            sc[-1] = sc[0]
        dts.append(_anno(d[:, :3], d[:, 3:6], d[:, 6], dn, sc))
    return gts, dts


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_kitti_overlaps_match_jax(criterion):
    rng = np.random.default_rng(5)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    for fn in ("bev_box_overlap", "box3d_overlap"):
        np.testing.assert_allclose(getattr(tke, fn)(a, b, criterion),
                                   getattr(jke, fn)(a, b, criterion), rtol=0, atol=ATOL)
    img = np.sort(rng.uniform(0, 50, (7, 2, 2)), axis=1).reshape(7, 4)[:, [0, 2, 1, 3]]
    np.testing.assert_array_equal(tke.image_box_overlap(img, img[::-1], criterion),
                                  jke.image_box_overlap(img, img[::-1], criterion))
    assert tke.bev_box_overlap(a[:0], b).shape == (0, 5)


def test_kitti_ap_matches_jax():
    gts, dts = _frames(6)
    for metric, mo, cls, n_pts in (("bev", 0.1, "Cyclist", 40), ("3d", 0.5, "Pedestrian", 40),
                                   ("3d", 0.1, "Cyclist", None)):
        assert tke.eval_class(gts, dts, cls, metric, mo, n_pts) == \
            jke.eval_class(gts, dts, cls, metric, mo, n_pts)
    got = tke.get_official_eval_result(gts, dts, ["Pedestrian", "Cyclist"],
                                       min_overlaps={"Pedestrian": 0.3})
    assert got == jke.get_official_eval_result(gts, dts, ["Pedestrian", "Cyclist"],
                                               min_overlaps={"Pedestrian": 0.3})
    assert 0 < got["bev"]["Pedestrian"] <= 1
    ov = jke.box3d_overlap(tke.annos_to_boxes(gts[1]), tke.annos_to_boxes(dts[1]))
    assert tke.compute_statistics(ov, dts[1]["score"], 0.3) == \
        jke.compute_statistics(ov, dts[1]["score"], 0.3)


# ---- EVAL_BOX_AP through the datasets' evaluation() and tools.test


def _detections(ds, rng, persons, missing_every=0):
    """Noisy keypoints around each frame's people, joints scored at random;
    every ``missing_every``-th frame decodes fewer joints than a person."""
    det = {}
    for n, s in enumerate(ds.samples):
        kps = []
        for p in s["poses"][:persons]:
            pose = np.asarray(p) + rng.normal(scale=0.08, size=(15, 3))
            kps += [(j, *pose[j], float(rng.random())) for j in range(15)]
        if missing_every and n % missing_every == 0:
            kps = kps[:7]
        det[f"{s['seq']}/{s['frame']}/{s['rdr_frame']}"] = {"keypoints": kps}
    return det


@pytest.mark.parametrize("persons", [1, 2])
@pytest.mark.parametrize("box_ap", [True, {"min_overlap": 0.1, "metrics": ["bev"]}])
def test_evaluation_box_ap_matches_jax(tmp_path, persons, box_ap):
    from rtpose_tpu.data import CRUWPoseDataset as JaxDataset
    from rtpose_tpu.data.synthetic import dataset_cfg
    from rtpose_tpu_torch.data import CRUWPoseDataset, generate_synthetic_dataset
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, num_seqs=2, frames_per_seq=1, test_frames_per_seq=4,
                               doppler_bins=1, persons_per_frame=persons, seed=8)
    cfg = dict(DATASET=dict(dataset_cfg(root), EVAL_BOX_AP=box_ap))
    kw = dict(split="test", max_poses=persons, group_by_frame=persons > 1)
    pd, jd = CRUWPoseDataset(cfg, "Test.json", **kw), JaxDataset(cfg, "Test.json", **kw)
    # a frame with fewer joints than a person: multi-person only (the
    # single-person MPJPE of both packages needs all 15)
    det = _detections(pd, np.random.default_rng(9), persons,
                      missing_every=3 if persons > 1 else 0)
    got, want = pd.evaluation(det)[0], jd.evaluation(det)[0]
    assert got == want
    assert set(got["results"]["box_ap"]) == set(["bev", "3d"] if box_ap is True else ["bev"]) \
        | {"summary"}
    assert 0 <= got["results"]["box_ap"]["bev"]["Pedestrian"] <= 1
    assert [pd._poses_to_kitti_anno(s["poses"])["dimensions"].tolist() for s in pd.samples] == \
        [a["dimensions"].tolist() for a in jd.ground_truth_annotations]
    assert "box_ap" not in CRUWPoseDataset(dict(DATASET=dataset_cfg(root)), "Test.json",
                                           split="test").evaluation(det)[0]["results"]


def test_lidar_evaluation_box_ap_matches_jax(tmp_path):
    from rtpose_tpu.data.cruw_pose import CRUWPoseLidarDataset as JaxLidar
    from rtpose_tpu.data.synthetic import dataset_cfg
    from rtpose_tpu_torch.data import generate_synthetic_dataset
    from rtpose_tpu_torch.data.cruw_pose import CRUWPoseLidarDataset
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, num_seqs=1, frames_per_seq=1, test_frames_per_seq=5,
                               with_lidar=True, radar_cubes=False, seed=10)
    cfg = dict(DATASET=dict(dataset_cfg(root, rdr_type="zyx_real"), EVAL_BOX_AP=True,
                            ENABLE_SENSOR=["LIDAR"]))
    pd = CRUWPoseLidarDataset(cfg, "Test.json", split="test")
    jd = JaxLidar(cfg, "Test.json", split="test", use_native=False)
    det = _detections(pd, np.random.default_rng(11), 1)
    assert pd.evaluation(det)[0] == jd.evaluation(det)[0]


TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}  # -> grid (8, 16, 32)


@pytest.mark.parametrize("kind", ["single", "multi", "lidar"])
def test_tools_test_reports_box_ap_as_jax(tmp_path, kind):
    """``python -m rtpose_tpu_torch.tools.test`` with ``EVAL_BOX_AP`` on tiny
    radar configs (one and two people a frame) and a tiny LiDAR config,
    with seeded weights: ``box_ap`` equal to the JAX dataset's evaluation of
    the same detections."""
    from rtpose_tpu.api import build_dataset_from_cfg as jax_dataset
    from rtpose_tpu.config import Config as JaxConfig
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import generate_synthetic_dataset
    from rtpose_tpu_torch.engine import save_checkpoint
    from rtpose_tpu_torch.models import init_weights
    from rtpose_tpu_torch.tools import test as port_test

    persons, lidar = (2 if kind == "multi" else 1), kind == "lidar"
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        root = str(tmp_path / "data")
        generate_synthetic_dataset(
            root, num_seqs=2, frames_per_seq=1, test_frames_per_seq=2, rdr_type="zyx_real",
            seed=12, persons_per_frame=persons,
            pelvis_range={"x": (0.9, 2.1), "y": (-1.1, 1.1), "z": (-0.5, 1.2)},
            offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7), with_lidar=lidar,
            radar_cubes=not lidar)
        template = "test_lidar_e2e.py" if lidar else "test_e2e_cli.py"
        src = open(os.path.join(REPO, "tests", template)).read()
        name = "LIDAR_CONFIG_TEMPLATE" if lidar else "CONFIG_TEMPLATE"
        text = re.search(rf"\b{name} = '''(.*?)'''", src, re.S).group(1).format(
            root=root, roi=TINY_ROI)
        if persons > 1:
            text = text.replace("max_poses=1", f"max_poses={persons}")
        cfg_path = str(tmp_path / "tiny_box_ap.py")
        with open(cfg_path, "w") as f:
            f.write(text + 'DATASET["EVAL_BOX_AP"] = {"min_overlap": 0.1}\n')
        cfg = Config.fromfile(cfg_path)
        model = init_weights(assemble(cfg).model, torch.Generator().manual_seed(0))
        ckpt = save_checkpoint(str(tmp_path / "seed0.pth"), model.state_dict())
        out = port_test.main([cfg_path, "--checkpoint", ckpt, "--work_dir",
                              str(tmp_path / "work"), "--testset", "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    box_ap = out["results"]["box_ap"]
    jd = jax_dataset(JaxConfig.fromfile(cfg_path).data, "test", max_poses=persons)
    want = jd.evaluation(out["detections"])[0]["results"]
    assert len(out["detections"]) == 4
    assert box_ap == want["box_ap"] and out["results"]["MPJPE"] == want["MPJPE"]
    assert set(box_ap) == {"bev", "3d", "summary"}
