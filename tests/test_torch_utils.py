"""The port's ``utils`` package and ``data/{builder,factory}`` against
rtpose_tpu's, on the CPU: object-store paths through a fake boto3-style
client (``tests/test_aux_components.py``'s), the radar and LiDAR datasets
and their evaluation on an ``s3://`` root equal to the same root on disk,
file IO, timer, progress bar, ``get_downsample_factor``, the dataset
factory and builder, parameter and FLOP counts, and freezing.

Everything here is copied, counted or read back: equality is exact.  FLOPs:
a 64 x 64 by 64 x 64 product is 2 * 64^3 operations, in both packages.
"""

import io
import os

import numpy as np
import pytest
import torch

from rtpose_tpu.data.synthetic import dataset_cfg
from rtpose_tpu.utils import fileio as jfileio
from rtpose_tpu.utils import oss as joss

from rtpose_tpu_torch import utils
from rtpose_tpu_torch.data import CRUWPoseDataset, generate_synthetic_dataset
from rtpose_tpu_torch.data.cruw_pose import CRUWPoseLidarDataset
from rtpose_tpu_torch.utils import fileio, oss
from rtpose_tpu_torch.utils.oss import OSSPath, set_client


class FakeS3:
    def __init__(self):
        self.blobs = {}

    def put_object(self, Bucket, Key, Body):
        self.blobs[(Bucket, Key)] = bytes(Body)

    def get_object(self, Bucket, Key):
        return {"Body": self.blobs[(Bucket, Key)]}

    def head_object(self, Bucket, Key):
        if (Bucket, Key) not in self.blobs:
            raise KeyError(Key)

    def list_objects(self, Bucket, Prefix):
        return {"Contents": [{"Key": k} for (b, k) in sorted(self.blobs)
                             if b == Bucket and k.startswith(Prefix)]}


@pytest.fixture
def s3():
    cli = FakeS3()
    set_client(cli)
    yield cli
    set_client(None)


def test_oss_local_passthrough(tmp_path):
    p = OSSPath(str(tmp_path)) / "x.bin"
    p.write_bytes(b"abc")
    assert p.exists() and p.read_bytes() == b"abc" and p.name == "x.bin"
    assert os.fspath(p) == str(tmp_path / "x.bin")
    assert [q.name for q in OSSPath(str(tmp_path)).iterdir()] == ["x.bin"]
    with oss.open_path(str(tmp_path / "x.bin"), "rb") as f:
        assert f.read() == b"abc"


def test_oss_remote_requires_client():
    set_client(None)
    p = OSSPath("oss://bucket/a/b.npy")
    assert p.remote and p.bucket == "bucket" and p.key == "a/b.npy"
    with pytest.raises(RuntimeError, match="set_client"):
        p.read_bytes()
    with pytest.raises(TypeError):
        os.fspath(p)
    assert oss.is_oss_path("s3://b/k") and oss.is_oss_path("oss://b/k")
    assert not oss.is_oss_path("/b/k") and not oss.is_oss_path(None)


def test_oss_remote_roundtrip(s3):
    root = OSSPath("oss://bkt/data")
    (root / "a.npy").write_bytes(b"111")
    (root / "b.txt").write_bytes(b"hello")
    assert (root / "a.npy").exists() and not (root / "missing").exists()
    assert (root / "b.txt").read_text() == "hello"
    assert [p.name for p in root.iterdir()] == ["a.npy", "b.txt"]
    assert [p.name for p in root.iterdir(suffix=".npy")] == ["a.npy"]
    assert (root / "a.npy").parent.key == "data"
    with oss.open_path("oss://bkt/data/b.txt") as f:
        assert f.read() == "hello"
    with pytest.raises(ValueError):
        (root / "b.txt").open("w")
    buf = io.BytesIO()
    np.save(buf, np.arange(6, dtype=np.float32).reshape(2, 3))
    (root / "c.npy").write_bytes(buf.getvalue())
    np.testing.assert_array_equal(oss.load_npy("oss://bkt/data/c.npy"),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))


def _upload(cli, local_root, bucket, prefix):
    for dp, _, fs in os.walk(local_root):
        for f in fs:
            path = os.path.join(dp, f)
            key = f"{prefix}/{os.path.relpath(path, local_root)}"
            with open(path, "rb") as fh:
                cli.put_object(Bucket=bucket, Key=key, Body=fh.read())


@pytest.mark.parametrize("rdr_type", ["dzyx_real", "zyx_real"])
def test_dataset_on_an_object_store_root(tmp_path, s3, rdr_type):
    """Labels, meta, cubes (numpy path: object-store paths skip the native
    loader) and the evaluation read from ``s3://`` equal the local root's,
    and the JAX dataset's on the same ``s3://`` root."""
    from rtpose_tpu.data import CRUWPoseDataset as JaxDataset
    local = str(tmp_path / "data")
    generate_synthetic_dataset(local, num_seqs=2, frames_per_seq=2, test_frames_per_seq=1,
                               doppler_bins=2, rdr_type=rdr_type, seed=3)
    _upload(s3, local, "bkt", "root")
    joss.set_client(s3)
    try:
        remote_cfg = dict(DATASET=dataset_cfg("s3://bkt/root", rdr_type=rdr_type))
        ds = CRUWPoseDataset(remote_cfg, "Test.json", split="test")
        jd = JaxDataset(remote_cfg, "Test.json", split="test")
        loc = CRUWPoseDataset(dict(DATASET=dataset_cfg(local, rdr_type=rdr_type)), "Test.json",
                              split="test", use_native=False)
        assert ds.samples == loc.samples == jd.samples and len(ds) == 2
        for i in range(len(ds)):
            a, b, c = ds[i], loc[i], jd[i]
            assert a["rdr_tensor"].tobytes() == b["rdr_tensor"].tobytes()
            assert a["rdr_tensor"].tobytes() == c["rdr_tensor"].tobytes()
            np.testing.assert_array_equal(a["poses"], b["poses"])
        raw = CRUWPoseDataset(remote_cfg, "Test.json", split="test", device_preprocess=True)[0]
        assert raw["rdr_raw"].tobytes() == loc.get_cube_raw(
            loc.samples[0]["seq"], loc.samples[0]["rdr_frame"]).tobytes()
        det = {f"{s['seq']}/{s['frame']}/{s['rdr_frame']}":
               {"keypoints": [(j, *np.asarray(s["poses"][0][j]) + 0.05, 0.9)
                              for j in range(15)]} for s in ds.samples}
        assert ds.evaluation(det)[0] == loc.evaluation(det)[0] == jd.evaluation(det)[0]
    finally:
        joss.set_client(None)


def test_lidar_points_from_an_object_store_root(tmp_path, s3):
    local = str(tmp_path / "data")
    generate_synthetic_dataset(local, num_seqs=1, frames_per_seq=2, test_frames_per_seq=0,
                               with_lidar=True, radar_cubes=False, seed=4)
    _upload(s3, local, "bkt", "lidar")
    cfg = dict(DATASET=dict(dataset_cfg("s3://bkt/lidar", rdr_type="zyx_real"),
                            ENABLE_SENSOR=["LIDAR"]))
    remote = CRUWPoseLidarDataset(cfg, "Train.json")
    cfg_local = dict(DATASET=dict(cfg["DATASET"], DIR=dict(cfg["DATASET"]["DIR"],
                                                            ROOT_DIR=local)))
    here = CRUWPoseLidarDataset(cfg_local, "Train.json")
    for s in remote.samples:
        frame = s.get("lidar_frame") or s["rdr_frame"]
        np.testing.assert_array_equal(remote.get_points(s["seq"], frame),
                                      here.get_points(s["seq"], frame))


@pytest.mark.parametrize("fmt", ["json", "yaml", "pkl"])
def test_fileio_matches_jax(tmp_path, fmt):
    obj = {"a": [1, 2, 3], "b": {"c": "d"}, "e": 1.5}
    p = str(tmp_path / f"x.{fmt}")
    fileio.dump(obj, p)
    assert fileio.load(p) == jfileio.load(p) == obj
    q = str(tmp_path / f"y.{fmt}")
    jfileio.dump(obj, q)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert utils.load_file(p) == obj
    with pytest.raises(TypeError, match="unsupported"):
        fileio.load(str(tmp_path / "x.txt"))


def test_timer_and_progressbar(capsys):
    from rtpose_tpu.utils import ProgressBar as JaxBar
    t = utils.Timer()
    assert t.since_start() >= 0 and t.since_last_check() >= 0
    with utils.Timer(print_tmpl="took {:.1f}"):
        pass
    assert "took" in capsys.readouterr().out
    stopped = utils.Timer(start=False)
    with pytest.raises(Exception, match="not running"):
        stopped.since_start()
    outs = []
    for cls in (utils.ProgressBar, JaxBar):
        buf = io.StringIO()
        bar = cls(task_num=2, file=buf)
        bar.update()
        bar.update()
        outs.append(buf.getvalue())
    assert "2/2" in outs[0] and outs[0].count("\r") == outs[1].count("\r") == 2
    assert outs[0].endswith("\n") and outs[1].endswith("\n")


def test_config_tool_matches_jax():
    from rtpose_tpu.utils.config_tool import get_downsample_factor as jax_factor
    for cfg in ({"neck": dict(ds_layer_strides=[2, 2, 2], us_layer_strides=[1, 2, 4])},
                {"neck": dict(ds_layer_strides=[2, 2]), "backbone": {"ds_factor": 2}},
                {"neck": None, "backbone": {"ds_factor": 4}}, {"neck": None},
                {"first_stage_cfg": {"neck": dict(ds_layer_strides=[4],
                                                  us_layer_strides=[2])}}):
        assert utils.get_downsample_factor(cfg) == jax_factor(cfg)


def test_dataset_factory_and_builder(tmp_path):
    from rtpose_tpu.data import dataset_factory as jax_factory
    from rtpose_tpu_torch.data.builder import build_dataset
    from rtpose_tpu_torch.data.factory import dataset_factory, get_dataset
    from rtpose_tpu_torch.data.wrappers import ConcatDataset, RepeatDataset
    assert dataset_factory == jax_factory
    assert get_dataset("CRUW_POSE") is get_dataset("CRUW_POSE_Dataset") is CRUWPoseDataset
    assert get_dataset("CRUW_POSE_LIDAR") is CRUWPoseLidarDataset
    assert get_dataset("CONCAT") is ConcatDataset and get_dataset("REPEAT") is RepeatDataset
    with pytest.raises(KeyError, match="known: .*CRUW_POSE"):
        get_dataset("NUSC")
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, num_seqs=1, frames_per_seq=2, test_frames_per_seq=0,
                               doppler_bins=1, seed=1)
    child = dict(type="CRUW_POSE", cfg=dict(DATASET=dataset_cfg(root)), label_file="Train.json")
    ds = build_dataset(child)
    assert isinstance(ds, CRUWPoseDataset) and len(ds) == 2
    rep = build_dataset(dict(type="REPEAT", times=2, dataset=child))
    assert isinstance(rep, RepeatDataset) and len(rep) == 4
    # the api's builder goes through the factory too
    from rtpose_tpu_torch.api import build_dataset_from_cfg
    cat = build_dataset_from_cfg({"train": dict(type="CONCAT", datasets=[child, child])},
                                 "train")
    assert isinstance(cat, ConcatDataset) and len(cat) == 4


def test_count_parameters_and_flops_match_jax():
    import jax.numpy as jnp
    from rtpose_tpu.utils import count_parameters as jax_count
    from rtpose_tpu.utils import estimate_flops as jax_flops
    m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 5, bias=False))
    assert utils.count_parameters(m) == 16 + 20
    tree = {"a": np.zeros((3, 4)), "b": {"c": np.zeros(5)}}
    assert utils.count_parameters({"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5)}}) \
        == jax_count(tree) == 17
    a = torch.zeros(64, 64)
    flops = utils.estimate_flops(lambda x, y: x @ y, a, a)
    assert flops == 2 * 64 ** 3
    jflops = jax_flops(lambda x, y: x @ y, jnp.zeros((64, 64)), jnp.zeros((64, 64)))
    assert jflops is None or jflops == flops
    assert utils.estimate_flops(lambda x: x + 1, a) is None          # nothing counted
    assert utils.estimate_flops(lambda x: x @ torch.zeros(3, 3), a) is None   # the call fails


def test_freeze_mask_matches_jax():
    from rtpose_tpu.utils import freeze_mask as jax_mask
    m = torch.nn.ModuleDict({"teacher": torch.nn.ModuleDict({"backbone": torch.nn.Linear(2, 2)}),
                             "student": torch.nn.ModuleDict({"head": torch.nn.Linear(2, 2),
                                                             "backbone": torch.nn.Linear(2, 2)})})
    prefixes = ["teacher", "head/bias"]          # a substring, not a prefix, match
    mask = utils.freeze_mask(m, prefixes)
    tree = {}
    for name, p in m.named_parameters():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.zeros(p.shape)
    jmask = jax_mask(tree, prefixes)
    for name, trainable in mask.items():
        node = jmask
        for part in name.split("."):
            node = node[part]
        assert trainable == node, name
    assert mask == {"teacher.backbone.weight": False, "teacher.backbone.bias": False,
                    "student.head.weight": True, "student.head.bias": False,
                    "student.backbone.weight": True, "student.backbone.bias": True}
    assert utils.freeze_mask(dict(m.named_parameters()), ["backbone"])["student.head.bias"]


def test_split_frozen_keeps_frozen_tensors_bit_equal_under_decay():
    g = torch.Generator().manual_seed(0)
    m = torch.nn.ModuleDict({"backbone": torch.nn.Linear(4, 4), "head": torch.nn.Linear(4, 2)})
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    opt = utils.split_frozen(lambda ps: torch.optim.AdamW(ps, lr=0.1, weight_decay=0.5), m,
                             ["backbone"])
    assert sum(len(grp["params"]) for grp in opt.param_groups) == 2
    for _ in range(2):
        opt.zero_grad()
        m["head"](m["backbone"](torch.randn(3, 4, generator=g))).square().sum().backward()
        opt.step()
    for n, p in m.named_parameters():
        if n.startswith("backbone"):
            assert torch.equal(p, before[n]) and not p.requires_grad and p.grad is None
        else:
            assert not torch.equal(p, before[n])
    # requires_grad=False alone would not do: decoupled decay moves a tensor
    # that stays in a param group with a gradient buffer (zeros, as
    # zero_grad(set_to_none=False) leaves it)
    w = torch.nn.Parameter(torch.ones(3))
    other = torch.nn.Parameter(torch.ones(1))
    opt = torch.optim.AdamW([w, other], lr=0.1, weight_decay=0.5)
    w.requires_grad_(False)
    other.sum().backward()
    w.grad = torch.zeros(3)
    opt.step()
    assert not torch.equal(w, torch.ones(3))
