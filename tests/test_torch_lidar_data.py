"""The port's LiDAR data path and CLIs against rtpose_tpu's, on the CPU:
the generator's point clouds, the ``Preprocess`` / ``Voxelization``
items of ``CRUW_POSE_Lidar_Dataset`` in train and test mode (with and
without the flipped sets and the point shuffle), ``augment`` and
``gt_sampler``, the shipped LiDAR config's assembly, and ``tools.train`` /
``tools.test`` (plain and double-flip TTA) / ``tools.export`` on a tiny
LiDAR config, against the JAX eval on the same weights.

Tolerances: the data path moves and counts points, so items, files and
augmentations are held exactly.  The eval runs two models whose convs sum
in different orders (``tests/test_torch_slice.py``): keypoints to ATOL_M =
1e-4 m, MPJPE to MPJPE_TOL_MM = 0.01 mm.
"""

import os
import re

import numpy as np
import pytest
import jax
import torch

from rtpose_tpu.api import assemble as jax_assemble
from rtpose_tpu.api import build_dataset_from_cfg as jax_dataset
from rtpose_tpu.config import Config as JaxConfig
from rtpose_tpu.data import BatchLoader as JaxLoader
from rtpose_tpu.data import augment as jaug
from rtpose_tpu.data import gt_sampler as jgts
from rtpose_tpu.data.cruw_pose import CRUWPoseLidarDataset as JaxLidarDataset
from rtpose_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from rtpose_tpu.engine import make_eval_step as jax_eval_step
from rtpose_tpu.engine import run_eval as jax_run_eval

from rtpose_tpu_torch.api import assemble
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.data import augment as taug
from rtpose_tpu_torch.data import generate_synthetic_dataset
from rtpose_tpu_torch.data import gt_sampler as tgts
from rtpose_tpu_torch.data.cruw_pose import CRUWPoseLidarDataset
from rtpose_tpu_torch.engine import load_checkpoint, save_checkpoint, state_dict_from_jax
from rtpose_tpu_torch.tools import export as port_export
from rtpose_tpu_torch.tools import int8_diag as port_int8_diag
from rtpose_tpu_torch.tools import test as port_test
from rtpose_tpu_torch.tools import train as port_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}  # -> grid (8, 16, 32)
ATOL_M = 1e-4
MPJPE_TOL_MM = 0.01
# the flip TTA needs a range symmetric about 0 on the flipped axis: TINY_ROI's
# y is (tests/test_lidar_e2e.py)
TTA_LINES = ('voxelization["cfg"]["double_flip"] = True\n'
             'voxelization["cfg"]["tta_flips"] = ["yflip"]\n'
             'test_cfg["double_flip"] = True\n')


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the cores: cap torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _template():
    src = open(os.path.join(REPO, "tests", "test_lidar_e2e.py")).read()
    return re.search(r"LIDAR_CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A LiDAR-only root of the port's generator (the e2e test's poses), the
    e2e test's tiny config and its TTA twin."""
    root = str(tmp_path_factory.mktemp("lidar_data"))
    generate_synthetic_dataset(
        root, num_seqs=2, frames_per_seq=4, test_frames_per_seq=3, rdr_type="zyx_real",
        seed=9, pelvis_range={"x": (1.0, 2.0), "y": (-1.0, 1.0), "z": (-0.5, 1.2)},
        offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7), pose_mode="skeleton",
        with_lidar=True, radar_cubes=False)
    work = tmp_path_factory.mktemp("lidar_work")
    text = _template().format(root=root, roi=TINY_ROI)
    paths = {}
    for name, extra in (("base", ""), ("tta", TTA_LINES)):
        paths[name] = str(work / f"tiny_lidar_{name}.py")
        with open(paths[name], "w") as f:
            f.write(text + extra)
    return dict(root=root, work=work, cfg_path=paths["base"], tta_path=paths["tta"])


# ---- generator


GENERATOR_KINDS = {
    "with_cubes": dict(radar_cubes=True),
    "lidar_only": dict(radar_cubes=False),
    "two_persons": dict(radar_cubes=False, persons_per_frame=2),
}


@pytest.mark.parametrize("kind", list(GENERATOR_KINDS))
def test_generator_with_lidar_matches_jax(tmp_path, kind):
    """The port's generator writes byte-identical roots (labels, cubes and
    point clouds) for the same seed: the clouds draw before the cubes."""
    kw = dict(num_seqs=1, frames_per_seq=1, test_frames_per_seq=1, seed=7,
              rdr_type="zyx_real", pose_mode="skeleton", with_lidar=True,
              **GENERATOR_KINDS[kind])
    a, b = tmp_path / "jax", tmp_path / "port"
    assert jax_generate(str(a), **kw) == generate_synthetic_dataset(str(b), **kw)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert sum(1 for p in files if "os2-64" in str(p)) == 2
    assert len(files) == (7 if kw["radar_cubes"] else 5)
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


# ---- dataset items through Preprocess + Voxelization


def _dataset_cfg(root):
    text = _template().format(root=root, roi=TINY_ROI)
    scope = {}
    exec(compile(text, "tiny_lidar", "exec"), scope)
    return dict(DATASET=scope["DATASET"]), scope["voxelization"]


ITEM_KINDS = {
    # (split, Preprocess cfg, Voxelization cfg additions)
    "train": ("train", dict(shuffle_points=False, mode="train"), {}),
    "test": ("test", dict(shuffle_points=False, mode="test"), {}),
    "train_caps": ("train", dict(), dict(max_voxel_num=[128, 256])),
    "test_caps": ("test", dict(), dict(max_voxel_num=[128, 256])),
    "test_double_flip": ("test", dict(), dict(double_flip=True)),
    "test_yflip": ("test", dict(), dict(double_flip=True, tta_flips=["yflip"])),
    "train_double_flip": ("train", dict(), dict(double_flip=True)),
    "train_shuffle": ("train", dict(shuffle_points=True), dict(max_num_points=300)),
}


@pytest.mark.parametrize("kind", list(ITEM_KINDS))
def test_lidar_items_match_jax(env, kind):
    """Every item of both datasets: the same keys, voxel arrays bit for bit,
    the same poses and metadata.  With ``shuffle_points`` both draw from
    numpy's global generator, seeded alike before each item."""
    split, pre, vox_extra = ITEM_KINDS[kind]
    ds_cfg, vox = _dataset_cfg(env["root"])
    vox = dict(vox, cfg=dict(vox["cfg"], **vox_extra))
    pipeline = [dict(type="Preprocess", cfg=pre), vox]
    label = "Train.json" if split == "train" else "Test.json"
    jd = JaxLidarDataset(ds_cfg, label, pipeline=pipeline, split=split, use_native=True)
    pd = CRUWPoseLidarDataset(ds_cfg, label, pipeline=pipeline, split=split, use_native=True)
    assert len(pd) == len(jd) == (8 if split == "train" else 6)
    np.testing.assert_array_equal(pd.flag, jd.flag)
    for i in range(len(jd)):
        np.random.seed(100 + i)
        a = jd[i]
        np.random.seed(100 + i)
        b = pd[i]
        assert sorted(a) == sorted(b), i
        for k in a:
            if isinstance(a[k], (np.ndarray, np.generic)):
                x, y = np.asarray(a[k]), np.asarray(b[k])
                assert x.dtype == y.dtype and x.shape == y.shape, (i, k)
                assert x.tobytes() == y.tobytes(), (i, k)
            else:
                assert a[k] == b[k], (i, k)
        flips = [k for k in b if k.endswith("flip_voxels")]
        want = {"test_double_flip": 3, "test_yflip": 1}.get(kind, 0)
        assert len(flips) == want
        cap = 128 if kind == "train_caps" else 256
        assert b["voxels"].shape == (cap, 4, 4) and int(b["num_voxels"]) > 0


# ---- the loaders over voxel items


@pytest.mark.parametrize("cache_dtype", [None, "bfloat16"])
def test_loaders_carry_voxel_batches(env, cache_dtype):
    """The voxel keys, int32 kept, through ``BatchLoader`` and the two
    device-resident loaders (on the CPU), in the same order; a bf16 cache
    rounds the voxels (a float key of >= 1 KB a sample) and nothing else;
    and the fused epoch's gather gives the loader's first batch."""
    from rtpose_tpu.data import DeviceCachedLoader as JaxCached
    from rtpose_tpu_torch.data import BatchLoader, DeviceCachedLoader, StreamingDeviceLoader
    from rtpose_tpu_torch.data.loader import gather_batch

    ds_cfg, vox = _dataset_cfg(env["root"])
    pipeline = [dict(type="Preprocess", cfg={}), vox]
    pds = CRUWPoseLidarDataset(ds_cfg, "Train.json", pipeline=pipeline, split="train",
                               use_native=True)
    cpu = torch.device("cpu")
    kw = dict(batch_size=4, shuffle=True, seed=3)
    host = BatchLoader(pds, **kw)
    cached = DeviceCachedLoader(pds, device=cpu, cache_dtype=cache_dtype, **kw)
    stream = StreamingDeviceLoader(pds, chunk_bytes=10 ** 9, device=cpu,
                                   cache_dtype=cache_dtype, **kw)
    jds = JaxLidarDataset(ds_cfg, "Train.json", pipeline=pipeline, split="train",
                          use_native=True)
    assert cached.nbytes == JaxCached(jds, cache_dtype=cache_dtype, **kw).nbytes
    assert cached._orig_dtype == ({} if cache_dtype is None else {"voxels": torch.float32})
    items = {(it["meta"]["seq"], it["meta"]["frame"]): it for it in (pds[i] for i in
                                                                     range(len(pds)))}

    def cast(a):
        t = torch.from_numpy(np.asarray(a))
        return t if cache_dtype is None else t.to(torch.bfloat16).float()

    for epoch in (0, 1):
        for ld in (host, cached, stream):
            ld.set_epoch(epoch)
        for h, c in zip(list(host), list(cached)):
            assert c["meta"] == h["meta"]
            for k in ("coors", "num_points_per_voxel", "num_voxels", "poses", "num_poses"):
                assert c[k].dtype == torch.from_numpy(h[k]).dtype, k
                np.testing.assert_array_equal(c[k].numpy(), h[k])
            assert h["coors"].dtype == h["num_voxels"].dtype == np.int32
            assert torch.equal(c["voxels"], cast(h["voxels"]))
        # the streaming loader shuffles by blocks: every sample once, as stored
        seen = []
        for st in stream:
            for j, m in enumerate(st["meta"]):
                it = items[(m["seq"], m["frame"])]
                seen.append((m["seq"], m["frame"]))
                assert st["coors"].dtype == torch.int32
                assert torch.equal(st["coors"][j], torch.from_numpy(it["coors"]))
                assert torch.equal(st["voxels"][j], cast(it["voxels"]))
        assert sorted(seen) == sorted(items)
    idx, shapes, orig = cached.fused_epoch()
    first = next(iter(cached))
    again = gather_batch(cached.data, torch.from_numpy(idx[:4].astype(np.int64)), 4, shapes,
                         orig)
    for k, v in again.items():
        assert torch.equal(v, first[k]), k


def test_cli_fused_epochs_on_voxel_batches(env):
    """``tools.train --device_cache --fuse_epochs`` on the LiDAR config (a
    plain loop on the CPU): the fused path taken, every step finite."""
    trainer = port_train.main([env["cfg_path"], "--work_dir", str(env["work"] / "fused"),
                               "--seed", "0", "--device_cache", "--fuse_epochs",
                               "--device", "cpu"])
    losses = trainer.log_buffer.val_history["loss"]
    assert trainer.epoch_step is not None and len(losses) == 4
    assert all(np.isfinite(v) for v in losses)


# ---- augment / gt_sampler (numpy copies)


def _scene(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(200, 4)).astype(np.float32)
    boxes = np.array([[0.0, 0.0, 0.0, 1.0, 1.0, 1.8, 0.3],
                      [2.5, -2.0, 0.0, 0.8, 0.9, 1.7, -0.4],
                      [-2.5, 2.5, 0.0, 1.2, 0.8, 1.6, 1.0]], np.float32)
    poses = rng.normal(size=(2, 15, 3)).astype(np.float32)
    return pts, boxes, poses


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_matches_jax(seed):
    pts, boxes, poses = _scene(seed)
    for name, kw in (("global_rotation", {}), ("global_scaling", {}),
                     ("global_translate", {}), ("random_flip_y", dict(probability=0.7))):
        a = getattr(jaug, name)(pts, boxes, rng=np.random.default_rng(seed), **kw)
        b = getattr(taug, name)(pts, boxes, rng=np.random.default_rng(seed), **kw)
        _equal(a, b)
    _equal(jaug.noise_per_object(boxes, pts, rng=np.random.default_rng(seed)),
           taug.noise_per_object(boxes, pts, rng=np.random.default_rng(seed)))
    _equal(jaug.flip_pose_y(poses), taug.flip_pose_y(poses))


def test_gt_sampler_matches_jax(tmp_path):
    pts, boxes, _ = _scene(2)
    samples = [dict(points=pts, gt_boxes=boxes, gt_names=["Pedestrian"] * 3)]
    jdb = jgts.create_gt_database(samples, str(tmp_path / "j.pkl"))
    tdb = tgts.create_gt_database(samples, str(tmp_path / "t.pkl"))
    assert (tmp_path / "j.pkl").read_bytes() == (tmp_path / "t.pkl").read_bytes()
    for a, b in zip(jdb["Pedestrian"], tdb["Pedestrian"]):
        _equal((a["points"], a["box"]), (b["points"], b["box"]))
    scene_pts, scene_boxes, _ = _scene(3)
    far = scene_boxes[:1] + np.array([[9, 9, 0, 0, 0, 0, 0]], np.float32)
    out = []
    for mod, db in ((jgts, str(tmp_path / "j.pkl")), (tgts, str(tmp_path / "t.pkl"))):
        sampler = mod.DataBaseSampler(db, {"Pedestrian": 3}, rng=np.random.default_rng(4))
        out.append(sampler.sample_all(scene_pts, far, ["Pedestrian"]))
    _equal(out[0][:2], out[1][:2])
    assert out[0][2] == out[1][2] and len(out[1][2]) > 1
    np.testing.assert_array_equal(taug.noise_per_object(boxes)[0].shape, boxes.shape)
    assert tgts.points_in_box_np(pts, boxes[0]).dtype == bool


# ---- the shipped config and the CLIs


def test_shipped_lidar_config_assembles_as_in_jax():
    path = os.path.join(REPO, "configs", "lidar", "voxelnet_pose.py")
    ja, pa = jax_assemble(JaxConfig.fromfile(path)), assemble(Config.fromfile(path))
    assert pa.sensor == ja.sensor == "lidar"
    assert pa.voxel_shape == tuple(ja.voxel_shape) == (1024, 8, 4)
    assert pa.input_key is ja.input_key is None
    assert pa.sparse_head is ja.sparse_head is False
    assert pa.multi_poses == ja.multi_poses == 0
    assert pa.tta_double_flip is ja.tta_double_flip is False
    assert pa.model.grid_zyx == (16, 64, 160)
    assert pa.model.backbone.backbone.layer1.conv1.weight.shape[:2] == (16, 4)
    ex = pa.example_input(2)
    jex = ja.example_input(2)
    for k, v in jex.items():
        assert tuple(ex[k].shape) == v.shape and str(ex[k].dtype)[6:] == str(v.dtype), k


def _jax_eval(cfg_path, ckpt_params):
    cfg = JaxConfig.fromfile(cfg_path)
    asm = jax_assemble(cfg)
    ds = jax_dataset(cfg.data, "test", max_poses=1)
    loader = JaxLoader(ds, batch_size=int(cfg.data["samples_per_gpu"]), shuffle=False,
                       drop_last=False)
    step = jax_eval_step(asm.model, asm.head, asm.decode_spec, input_key=asm.input_key,
                         tta_double_flip=asm.tta_double_flip)
    det, _ = jax_run_eval(step, ckpt_params, loader, asm.decode_spec)
    res, _ = ds.evaluation(det, testset=True)
    return det, res["results"]


@pytest.fixture(scope="module")
def shared_weights(env):
    """flax VoxelNet weights of the tiny config (the regression output scaled
    to sub-voxel offsets, as ``tests/test_torch_slice.py`` does), carried
    into a port checkpoint."""
    asm = jax_assemble(JaxConfig.fromfile(env["cfg_path"]))
    params = jax.tree.map(np.array, asm.model.init(jax.random.PRNGKey(3),
                                                   asm.example_input()))
    params["params"]["head_m"]["task0"]["reg_out"]["kernel"] *= 0.01
    ckpt = save_checkpoint(str(env["work"] / "epoch_1.pth"), state_dict_from_jax(params),
                           meta={"epoch": 1})
    return params, ckpt


@pytest.mark.parametrize("tta", [False, True])
def test_cli_test_matches_jax(env, shared_weights, tta, capsys):
    """``tools.test`` on the shared weights against the JAX eval (what
    ``tools/test.py`` runs): every frame's keypoints and the MPJPE; with
    ``test_cfg.double_flip`` both run the TTA over the original and the
    y-flipped voxel sets."""
    params, ckpt = shared_weights
    cfg_path = env["tta_path" if tta else "cfg_path"]
    jdet, jres = _jax_eval(cfg_path, params)
    out = port_test.main([cfg_path, "--checkpoint", ckpt, "--work_dir",
                          str(env["work"] / f"eval_tta{int(tta)}"), "--testset",
                          "--device", "cpu"])
    assert "Evaluation MPJPE" in capsys.readouterr().out
    pdet = out["detections"]
    assert sorted(pdet) == sorted(jdet) and len(pdet) == 6
    for key in jdet:
        a = np.asarray([p[1:4] for p in jdet[key]["keypoints"]])
        b = np.asarray([p[1:4] for p in pdet[key]["keypoints"]])
        assert a.shape == b.shape == (15, 3)
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL_M)
    for k in ("MPJPE", "ABS_MPJPE"):
        assert abs(out["results"][k] - jres[k]) <= MPJPE_TOL_MM, k


def test_cli_train_test_export(env, shared_weights):
    """``tools.train`` two epochs (finite losses, every step), ``tools.test``
    with and without the TTA on its checkpoint, a float ``tools.export``
    artifact whose ``tools.test --exported`` MPJPE equals the live model's,
    an int8 one (52 sites at this grid: X = 32 folds), and the flags the
    JAX CLIs fail on with this config refused with a message."""
    work = str(env["work"] / "train")
    trainer = port_train.main([env["cfg_path"], "--work_dir", work, "--seed", "0",
                               "--device", "cpu"])
    losses = trainer.log_buffer.val_history["loss"]
    assert len(trainer.iter_seconds) == len(losses) == 4
    assert all(np.isfinite(v) for v in losses)
    assert not any(trainer.log_buffer.val_history["skipped"])
    ckpt = os.path.join(work, "checkpoints", "epoch_2.pth")
    assert load_checkpoint(ckpt)["meta"]["epoch"] == 2
    runs = {}
    for name in ("cfg_path", "tta_path"):
        runs[name] = port_test.main([env[name], "--checkpoint", work, "--work_dir",
                                     os.path.join(work, name), "--testset", "--device", "cpu"])
        assert len(runs[name]["detections"]) == 6
        assert np.isfinite(runs[name]["results"]["MPJPE"])
    art = os.path.join(work, "a.pt2")
    port_export.main([env["cfg_path"], "--checkpoint", work, "--out", art, "--batch_size",
                      "4", "--device", "cpu"])
    exp = port_test.main([env["cfg_path"], "--exported", art, "--work_dir",
                          os.path.join(work, "exp"), "--testset", "--device", "cpu"])
    assert exp["results"]["MPJPE"] == runs["cfg_path"]["results"]["MPJPE"]
    res = port_export.main([env["cfg_path"], "--checkpoint", work, "--out",
                            os.path.join(work, "i.pt2"), "--batch_size", "4", "--int8",
                            "--calib_batches", "1", "--device", "cpu"])
    assert len(res["int8_scales"]) == 52
    assert res["meta"]["input_shape"]["voxels"] == [4, 256, 4, 4]
    for argv, mod in (([env["cfg_path"], "--work_dir", work, "--device_preprocess"], port_train),
                      ([env["cfg_path"], "--checkpoint", work, "--device_preprocess"],
                       port_test),
                      ([env["cfg_path"], "--checkpoint", work], port_int8_diag)):
        with pytest.raises(SystemExit, match="LiDAR config"):
            mod.main([*argv, "--device", "cpu"])
