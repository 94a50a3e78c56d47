"""Every shipped radar config through the port's assembly and data, against
rtpose_tpu on the CPU: the ten ``configs/cruw_pose/*.py`` assemble with the
JAX package's input shape, ``sparse_head`` and ``multi_poses``; their train
and test datasets build the same samples and flags; ``ConcatDataset`` /
``RepeatDataset`` give the same items, and the port's three loaders the same
epoch order over them as the JAX loaders; complex cubes and frame-grouped
(multi-person) samples equal the JAX package's, item for item.

The roots are tiny synthetic ones (one Doppler bin, so a full cube is 2 MB)
made with the port's generator, which writes the JAX generator's bytes
(``tests/test_torch_slice.py::test_generator_matches_jax``).  Everything
compared here is copied or indexed, not computed: equality is exact.
"""

import dataclasses
import glob
import os
import time

import numpy as np
import pytest
import torch

from rtpose_tpu.api import assemble as jax_assemble
from rtpose_tpu.api import build_dataset_from_cfg as jax_dataset
from rtpose_tpu.config import Config as JaxConfig
from rtpose_tpu.data import BatchLoader as JaxLoader
from rtpose_tpu.data import StreamingDeviceLoader as JaxStreaming
from rtpose_tpu.data import generate_synthetic_dataset as jax_generate

from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg, input_channels
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.data import (BatchLoader, ConcatDataset, DeviceCachedLoader,
                                   RepeatDataset, StreamingDeviceLoader,
                                   generate_synthetic_dataset)
from rtpose_tpu_torch.tools import gen_skel_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "cruw_pose", "*.py")))
CPU = torch.device("cpu")
ROOT_VARS = ("RTPOSE_DATA_ROOT", "RTPOSE_DATA_ROOT2", "RTPOSE_DATA_ROOT3",
             "RTPOSE_DATA_ROOT4")


def _name(path):
    return os.path.basename(path)[:-3]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Four Doppler roots (seq ids disjoint, the first with a test split), a
    zyx root, a two-person root and a complex root."""
    base = tmp_path_factory.mktemp("config_roots")
    kw = dict(frames_per_seq=3, doppler_bins=1, pose_mode="skeleton")
    out = {}
    for i, var in enumerate(ROOT_VARS):
        out[var] = str(base / f"dzyx{i}")
        generate_synthetic_dataset(out[var], num_seqs=2, seed=10 + i, seq_offset=2 * i,
                                   test_frames_per_seq=2 if i == 0 else 0, **kw)
    out["zyx"] = str(base / "zyx")
    generate_synthetic_dataset(out["zyx"], num_seqs=2, seed=20, rdr_type="zyx_real",
                               test_frames_per_seq=1, **kw)
    out["mp2"] = str(base / "mp2")
    generate_synthetic_dataset(out["mp2"], num_seqs=2, seed=21, persons_per_frame=2,
                               test_frames_per_seq=2, **kw)
    out["phase"] = str(base / "phase")
    generate_synthetic_dataset(out["phase"], num_seqs=1, seed=22, rdr_type="dzyx_complex",
                               test_frames_per_seq=2, **kw)
    return out


def _load(path, roots, monkeypatch):
    """Both packages' Config of ``path``, its roots pointed at the tiny ones."""
    name = _name(path)
    first = ("zyx" if name in ("hr3d", "hr3d_one_hm") else "mp2" if name.endswith("mp2")
             else "phase" if name.endswith("phase") else "RTPOSE_DATA_ROOT")
    monkeypatch.setenv("RTPOSE_DATA_ROOT", roots[first])
    for var in ROOT_VARS[1:]:
        monkeypatch.setenv(var, roots[var])
    return JaxConfig.fromfile(path), Config.fromfile(path)


@pytest.mark.parametrize("path", CONFIGS, ids=_name)
def test_config_assembles_as_in_jax(path, roots, monkeypatch):
    jcfg, cfg = _load(path, roots, monkeypatch)
    ja, pa = jax_assemble(jcfg), assemble(cfg)
    assert pa.input_shape_zyxc == tuple(ja.input_shape_zyxc)
    assert pa.input_shape_zyxc[-1] == input_channels(dict(cfg.DATASET))
    assert pa.sparse_head == ja.sparse_head
    assert pa.multi_poses == ja.multi_poses
    assert pa.one_hm == ja.one_hm
    assert dataclasses.astuple(pa.decode_spec) == dataclasses.astuple(ja.decode_spec)
    assert pa.target_spec.max_poses == ja.target_spec.max_poses
    x = torch.zeros((1, *pa.input_shape_zyxc))
    first = pa.model.backbone.backbone.layer1
    assert (first.conv1 if first.conv1 is not None else first.conv2.conv).weight.shape[1] \
        == x.shape[-1]
    # train and test data: the same samples, flags and lengths
    mp = ja.target_spec.max_poses
    for split in ("train", "test"):
        jd = jax_dataset(jcfg.data, split, max_poses=mp, device_preprocess=True)
        pd = build_dataset_from_cfg(cfg.data, split, max_poses=mp, device_preprocess=True)
        assert len(pd) == len(jd) > 0, split
        np.testing.assert_array_equal(pd.flag, jd.flag)
        assert type(pd).__name__ == type(jd).__name__
        assert pd.device_preprocess == jd.device_preprocess
        assert (pd.norm_start, pd.norm_scale) == (jd.norm_start, jd.norm_scale)


def test_assembly_faults_fixed():
    """``sparse_head`` is off for multi-person and deformable-head configs;
    the input channels come from the data (RDR_TYPE, DOPPLER_BINS), not the
    backbone."""
    path = os.path.join(REPO, "configs", "cruw_pose", "hr3d_one_hm_doppler.py")
    for dcn, mp, sparse in ((False, 1, True), (True, 1, False), (False, 2, False)):
        cfg = Config.fromfile(path)
        cfg.model["pose_head"]["dcn_head"] = dcn
        cfg.train_cfg["assigner"]["max_poses"] = mp
        asm = assemble(cfg)
        assert asm.sparse_head == sparse and asm.multi_poses == (mp if mp > 1 else 0)
    ds = dict(Config.fromfile(path).DATASET)
    assert input_channels(dict(ds, RDR_TYPE="dzyx_complex")) == 64
    assert input_channels(dict(ds, RDR_TYPE="dzyx_real", DOPPLER_BINS=8)) == 8
    assert input_channels(dict(ds, RDR_TYPE="zyx_complex")) == 2
    assert input_channels(dict(ds, RDR_TYPE="zyx_real")) == 1


def _cube_path(use_native, *datasets):
    """Both packages' datasets (or every child of a wrapper) on the same host
    cube path: the native C++ loader (``use_native=True``, the default of
    both) or the numpy one; the two round the normalization up to one
    float32 ulp apart.  ``rtpose_tpu.native`` keeps None for the process
    when its first load fails (another test worker still linking the
    library): it is asked again until the file is complete."""
    from rtpose_tpu import native as jax_native
    deadline = time.monotonic() + 120
    while use_native and jax_native.get_lib() is None and time.monotonic() < deadline:
        jax_native._tried = False
        time.sleep(1)
    for ds in datasets:
        for d in getattr(ds, "datasets", None) or [getattr(ds, "dataset", ds)]:
            d.use_native = use_native
    return datasets


def _wrapped(name, roots, monkeypatch):
    path = os.path.join(REPO, "configs", "cruw_pose", f"{name}.py")
    jcfg, cfg = _load(path, roots, monkeypatch)
    return _cube_path(True, jax_dataset(jcfg.data, "train", max_poses=1),
                      build_dataset_from_cfg(cfg.data, "train", max_poses=1))


@pytest.mark.parametrize("name,kind,n", [
    ("hr3d_one_hm_doppler_skel960", ConcatDataset, 12),
    ("hr3d_one_hm_doppler_skel1920", ConcatDataset, 24),
    ("hr3d_one_hm_doppler_skel480x2", RepeatDataset, 12)])
def test_wrappers_match_jax(name, kind, n, roots, monkeypatch):
    jd, pd = _wrapped(name, roots, monkeypatch)
    assert isinstance(pd, kind) and len(pd) == len(jd) == n
    np.testing.assert_array_equal(pd.flag, jd.flag)
    assert pd.flag.shape == (n,)
    assert pd.norm_start == jd.norm_start and pd.evaluation.__name__ == "evaluation"
    for i in range(n):
        a, b = jd[i], pd[i]
        assert a["meta"] == b["meta"]
        np.testing.assert_array_equal(b["rdr_tensor"], a["rdr_tensor"])
        np.testing.assert_array_equal(b["poses"], a["poses"])


def test_wrapper_flags_none_unless_every_child_has_them():
    class NoFlag:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return i

    class Flagged(NoFlag):
        flag = np.ones(3, np.uint8)

    assert ConcatDataset([Flagged(), NoFlag()]).flag is None
    assert ConcatDataset([Flagged(), Flagged()]).flag.shape == (6,)
    assert RepeatDataset(NoFlag(), times=2).flag is None
    r = RepeatDataset(Flagged(), times=3)
    assert r.flag.shape == (9,) and len(r) == 9 and r[7] == 1
    c = ConcatDataset([Flagged(), NoFlag()])
    assert [c[i] for i in range(6)] == [0, 1, 2, 0, 1, 2]
    import copy
    assert len(copy.deepcopy(c)) == 6


def _metas(loader, epoch):
    loader.set_epoch(epoch)
    return [(m["seq"], m["frame"]) for b in loader for m in b["meta"]]


@pytest.mark.parametrize("name", ["hr3d_one_hm_doppler_skel960",
                                  "hr3d_one_hm_doppler_skel480x2"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loaders_epoch_order_over_wrappers(name, shuffle, roots, monkeypatch):
    """Epochs 0-2: the port's BatchLoader and DeviceCachedLoader in the JAX
    BatchLoader's order, its StreamingDeviceLoader in the JAX streaming
    loader's, batch for batch (arrays bit for bit through the host loader)."""
    jd, pd = _wrapped(name, roots, monkeypatch)
    kw = dict(batch_size=4, shuffle=shuffle, seed=3)
    jl, pl = JaxLoader(jd, **kw), BatchLoader(pd, **kw)
    cl = DeviceCachedLoader(pd, device=CPU, **kw)
    chunk = 6 * (16 * 64 * 160 * 4 + 1000)
    js = JaxStreaming(jd, chunk_bytes=chunk, **kw)
    ps = StreamingDeviceLoader(pd, chunk_bytes=chunk, device=CPU, **kw)
    assert len(jl) == len(pl) == len(cl) == 3 and len(js) == len(ps)
    for epoch in range(3):
        order = _metas(jl, epoch)
        assert _metas(pl, epoch) == order and _metas(cl, epoch) == order
        assert _metas(ps, epoch) == _metas(js, epoch)
        if not shuffle:
            assert order == [(m["seq"], m["frame"]) for m in (pd[i]["meta"]
                                                              for i in range(12))]
    jl.set_epoch(1)
    pl.set_epoch(1)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(b["rdr_tensor"], a["rdr_tensor"])
        np.testing.assert_array_equal(b["poses"], a["poses"])


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_complex_cube_items_match_jax(device_preprocess, roots, monkeypatch):
    """``_phase``: crop only, (Z, Y, X, 2D) float32, and the card preprocess
    refused (complex cubes carry ``rdr_tensor`` even when it is asked)."""
    path = os.path.join(REPO, "configs", "cruw_pose", "hr3d_one_hm_doppler_phase.py")
    jcfg, cfg = _load(path, roots, monkeypatch)
    jd, pd = _cube_path(True, jax_dataset(jcfg.data, "test", device_preprocess=device_preprocess),
                        build_dataset_from_cfg(cfg.data, "test",
                                               device_preprocess=device_preprocess))
    assert not pd.device_preprocess and not jd.device_preprocess
    assert pd.rdr_dirname == jd.rdr_dirname == "DZYX_npy_f16_complex"
    for i in range(len(jd)):
        a, b = jd[i], pd[i]
        assert "rdr_raw" not in b and b["rdr_tensor"].dtype == np.float32
        assert b["rdr_tensor"].shape == (16, 64, 160, 2)
        np.testing.assert_array_equal(b["rdr_tensor"], a["rdr_tensor"])
        assert b["rdr_tensor"].min() < 0          # the imaginary parts: no clamp


def test_group_by_frame_matches_jax(roots, monkeypatch):
    """``_skel_mp2``: one sample per frame carrying both people."""
    path = os.path.join(REPO, "configs", "cruw_pose", "hr3d_one_hm_doppler_skel_mp2.py")
    jcfg, cfg = _load(path, roots, monkeypatch)
    for split in ("train", "test"):
        jd = jax_dataset(jcfg.data, split, max_poses=2, device_preprocess=True)
        pd = build_dataset_from_cfg(cfg.data, split, max_poses=2, device_preprocess=True)
        assert pd.group_by_frame and pd.samples == jd.samples
        for i in range(len(jd)):
            a, b = jd[i], pd[i]
            assert int(b["num_poses"]) == int(a["num_poses"]) == 2
            np.testing.assert_array_equal(b["poses"], a["poses"])
            np.testing.assert_array_equal(b["rdr_raw"], a["rdr_raw"])
    # one person per sample without the grouping (the reference's layout)
    assert len(build_dataset_from_cfg(cfg.data, "test")) == 2 * len(pd)


def test_gen_skel_data_cli_matches_jax_generator(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    kw = dict(num_seqs=2, frames_per_seq=1, test_frames_per_seq=0, seed=4, seq_offset=5,
              persons_per_frame=2, rdr_type="dzyx_real", roi_only=True,
              pose_mode="skeleton")
    jax_generate(str(a), **kw)
    keys = gen_skel_data.main([str(b), "--num_seqs", "2", "--frames_per_seq", "1",
                               "--test_frames", "0", "--seed", "4", "--seq_offset", "5",
                               "--persons_per_frame", "2", "--roi_only"])
    assert keys["Train"] == ["5/train_0000/000000", "6/train_0000/000000"]
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    # --with_lidar writes the point clouds (and keeps the cubes), as JAX's
    c, d = tmp_path / "jax_lidar", tmp_path / "port_lidar"
    jax_generate(str(c), **dict(kw, persons_per_frame=1, with_lidar=True))
    gen_skel_data.main([str(d), "--num_seqs", "2", "--frames_per_seq", "1", "--test_frames",
                        "0", "--seed", "4", "--seq_offset", "5", "--roi_only", "--with_lidar"])
    files = sorted(p.relative_to(c) for p in c.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())
    assert sum(1 for rel in files if "os2-64" in str(rel)) == 2
    for rel in files:
        assert (c / rel).read_bytes() == (d / rel).read_bytes(), rel


TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}  # -> grid (8, 16, 32)
KINDS = {
    # (template edit, appended lines, persons per frame, train steps, test frames)
    "skel_mp2": (("max_poses=1", "max_poses=2"), "", 2, 1, 2),
    "dcn": (("dcn_head=False", "dcn_head=True"), "", 1, 1, 2),
    "repeat": (None, 'data["train"] = dict(type="RepeatDataset", times=2, '
                     'dataset=data["train"])\n', 1, 2, 2),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_then_test_cli(kind, tmp_path):
    """The port's CLIs on a tiny variant of each new kind of config, on the
    CPU: ``tools.train`` (one epoch, finite losses, the steps of its data:
    twice the child's through ``RepeatDataset``), then ``tools.test`` on the
    checkpoint it wrote (every test frame decoded; two people a frame with
    ``max_poses=2``)."""
    import re

    from rtpose_tpu_torch.tools import test as port_test
    from rtpose_tpu_torch.tools import train as port_train

    edit, extra, persons, steps, frames = KINDS[kind]
    root = str(tmp_path / "data")
    generate_synthetic_dataset(
        root, num_seqs=2, frames_per_seq=2, test_frames_per_seq=1, rdr_type="zyx_real",
        seed=12, persons_per_frame=persons,
        pelvis_range={"x": (0.9, 2.1), "y": (-1.1, 1.1), "z": (-0.5, 1.2)},
        offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7))
    src = open(os.path.join(REPO, "tests", "test_e2e_cli.py")).read()
    text = re.search(r"CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1).format(
        root=root, roi=TINY_ROI)
    if edit is not None:
        assert edit[0] in text
        text = text.replace(*edit)
    cfg_path = str(tmp_path / f"tiny_{kind}.py")
    with open(cfg_path, "w") as f:
        f.write(text + extra)
    work = str(tmp_path / "work")
    trainer = port_train.main([cfg_path, "--work_dir", work, "--seed", "0", "--total_epochs",
                               "1", "--device", "cpu"])
    losses = trainer.log_buffer.val_history["loss"]
    assert len(trainer.iter_seconds) == steps == len(losses)
    assert all(np.isfinite(v) for v in losses)
    out = port_test.main([cfg_path, "--checkpoint", work, "--work_dir", work, "--testset",
                          "--device", "cpu"])
    assert len(out["detections"]) == frames
    assert all(len(d["keypoints"]) == 15 * persons for d in out["detections"].values())
    assert np.isfinite(out["results"]["MPJPE"])
