"""The port's serving export (``rtpose_tpu_torch/export.py``), its CLIs
(``tools.export``, ``tools.test --exported``) and the kernels' custom ops,
on the CPU at the tiny grid (8, 16, 32).

Tolerances: none.  On the CPU the artifact runs the same operations on the
same prepared weights as the live model (the custom ops' CPU
implementations are the kernels' plain versions), so predictions are held
bit for bit, and MPJPE of the artifact equal to the live int8 run's.
"""

import contextlib
import copy
import logging
import os
import re

import numpy as np
import pytest
import torch

from rtpose_tpu_torch import export as pexp
from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.data import BatchLoader, generate_synthetic_dataset
from rtpose_tpu_torch.engine import run_eval, save_checkpoint
from rtpose_tpu_torch.models import TorchConv3d, init_weights
from rtpose_tpu_torch.ops import conv_k3, conv_k3_int8, preprocess, quant
from rtpose_tpu_torch.tools import export as export_cli
from rtpose_tpu_torch.tools import test as test_cli
from rtpose_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}  # -> grid (8, 16, 32)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs six workers at once: torch's default of one thread
    per core in each of them oversubscribes the machine, and this file's
    CPU convs then ran some 30x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("export_data"))
    generate_synthetic_dataset(
        root, num_seqs=2, frames_per_seq=2, test_frames_per_seq=3,
        rdr_type="zyx_real", seed=5,
        pelvis_range={"x": (1.0, 2.0), "y": (-1.0, 1.0), "z": (-0.5, 1.2)},
        offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7))
    src = open(os.path.join(REPO, "tests", "test_e2e_cli.py")).read()
    tpl = re.search(r"CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1)
    work = tmp_path_factory.mktemp("export_work")
    cfg_path = str(work / "tiny.py")
    with open(cfg_path, "w") as f:
        f.write(tpl.format(root=root, roi=TINY_ROI))
    cfg = Config.fromfile(cfg_path)
    asm = assemble(cfg)
    init_weights(asm.model, torch.Generator().manual_seed(0))
    with torch.no_grad():   # sub-voxel regression offsets, as a trained head
        asm.model.pose_head.tasks[0].reg[-1].weight.mul_(0.01)
    asm.model.eval()
    ckpt = save_checkpoint(str(work / "seed0.pth"), asm.model.state_dict())
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(np.abs(rng.normal(size=(2, *asm.input_shape_zyxc)))
                           .astype(np.float32)) for _ in range(2)]
    return dict(cfg_path=cfg_path, cfg=cfg, asm=asm, ckpt=ckpt, work=work, xs=xs,
                scales=pexp.calibrate_predict(asm, xs))


def _equal(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        assert len(ta) == len(tb) == 3
        for u, v in zip(ta, tb):
            assert u.dtype == v.dtype and torch.equal(u, v)


NORM = (0.5, 2.0)


@pytest.fixture(scope="module")
def artifacts(env):
    """Two traced programs shared by the tests below (each trace takes
    seconds): float with the preprocess op in front (raw cubes in), and
    int8 with ``final_dtype`` bfloat16; with the live functions they must
    equal and an input of each."""
    asm, x = env["asm"], env["xs"][0]
    raw = (x * 4.0).permute(0, 4, 1, 2, 3).contiguous().half()
    return {
        False: (pexp.export_predict(asm, batch_size=2, device="cpu", preprocess=NORM),
                pexp.make_predict_fn(asm, preprocess=NORM), [raw, raw.flip(0)]),
        True: (pexp.export_predict(asm, batch_size=2, device="cpu",
                                   int8_scales=env["scales"], final_dtype="bfloat16"),
               pexp.make_predict_fn(asm, int8_scales=env["scales"], final_dtype="bfloat16"),
               env["xs"]),
    }


@pytest.mark.parametrize("int8", [False, True])
def test_export_equals_live_bit_for_bit(artifacts, int8):
    """The traced program (saved and loaded in the CLI test below):
    predictions equal to the live model's bit for bit, its metadata, and
    the static batch enforced."""
    ep, live, xs = artifacts[int8]
    module = ep.module()
    for x in xs:
        _equal(pexp._grouped(module(x)), live(x))
    meta = ep.rtpose_meta
    assert meta["device"] == "cpu" and meta["batch_size"] == 2
    assert meta["input_shape"] == ([2, 8, 16, 32, 1] if int8 else [2, 1, 8, 16, 32])
    assert meta["int8_sites"] == (52 if int8 else None)
    with pytest.raises(RuntimeError, match=r"shape\[0\]|size"):
        module(torch.cat([xs[0], xs[1][:1]]))


def test_int8_artifact_differs_from_float(env):
    x = env["xs"][0]
    f = pexp.make_predict_fn(env["asm"])(x)[0][0]
    q = pexp.make_predict_fn(env["asm"], int8_scales=env["scales"])(x)[0][0]
    assert not torch.equal(f, q)      # the int8 program really ran


def test_final_dtype_is_baked_in(env, artifacts):
    """The int8 artifact was exported with ``final_dtype='bfloat16'``: it
    says so, and the head's output convs in bfloat16 change the result."""
    ep, live, xs = artifacts[True]
    assert ep.rtpose_meta["final_dtype"] == "bfloat16"
    f32 = pexp.make_predict_fn(env["asm"], int8_scales=env["scales"])(xs[0])
    _equal([tuple(ep.module()(xs[0]))], live(xs[0]))
    assert not torch.equal(live(xs[0])[0][0], f32[0][0])
    # the live model itself is untouched by the variant
    assert env["asm"].model.pose_head.tasks[0].final_dtype == torch.float32


def test_export_with_preprocess_traces_the_preprocess_op(artifacts):
    """``export_predict(preprocess=...)``: raw (B, D, Z, Y, X) cubes in,
    through ``rtpose::preprocess`` (equal to the live predict on them: the
    test above)."""
    ep = artifacts[False][0]
    ops = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert "rtpose.preprocess.default" in ops, ops
    assert ep.rtpose_meta["preprocess"] == list(NORM)


def test_artifact_reaches_the_kernels_through_custom_ops(env):
    """A bf16 K3-shaped model traces ``rtpose::conv3d_k3``, its int8 form
    ``rtpose::conv3d_k3_int8``; the flagship's shape at a tiny grid."""
    from rtpose_tpu_torch.models.layers import ResNetBlock

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.b = ResNetBlock(32, 32, dtype="bfloat16")
            self.b.conv2.conv.site = "b/conv2/TorchConv3d_0"
            self.b.conv3.conv.site = "b/conv3/TorchConv3d_0"

        def forward(self, x):
            return self.b(x)

    m = init_weights(Block(), torch.Generator().manual_seed(1)).eval()
    x = torch.randn((1, 4, 6, 8, 32), generator=torch.Generator().manual_seed(2))
    for scales, op in ((None, "rtpose.conv3d_k3.default"),
                       ({"b/conv2/TorchConv3d_0": 0.03, "b/conv3/TorchConv3d_0": 0.05},
                        "rtpose.conv3d_k3_int8.default")):
        mm = copy.deepcopy(m)
        convs = [c for c in mm.modules() if isinstance(c, TorchConv3d)]
        ctx = quant.int8_mode(scales) if scales else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            want = copy.deepcopy(mm)(x)        # the eager path
            live = mm(x)
            for c in convs:
                c.freeze()
            ep = torch.export.export(mm, (x,), strict=False)
            traced = ep.module()(x)
        targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        assert targets.count(op) == 2, targets
        assert torch.equal(traced, live) and torch.equal(live, want)


def test_frozen_conv_keeps_its_weights(env):
    m = TorchConv3d(4, 8, kernel=1)
    init_weights(m, torch.Generator().manual_seed(3))
    x = torch.randn((1, 2, 2, 2, 4))
    with torch.no_grad():
        want = m(x)
        m.freeze()
        m.weight.mul_(2.0)
        assert torch.equal(m(x), want)
    with pytest.raises(RuntimeError, match="no weights kept"), quant.int8_mode({"c": 0.1}):
        m.site = "c"
        m(x)


# ---------------------------------------------------------------- custom ops

def test_custom_ops_cpu_are_the_plain_versions():
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 3, 5, 7, 32), generator=g).to(torch.bfloat16)
    w = torch.randn((32, 32, 3, 3, 3), generator=g) * 0.05
    b = torch.randn((32,), generator=g)
    wr, bp = conv_k3.prepare(w, b)
    assert torch.equal(conv_k3.unprepare(wr), w.to(torch.bfloat16))
    assert torch.equal(torch.ops.rtpose.conv3d_k3(x, wr, bp),
                       conv_k3.conv3d_k3_reference(x, w, b))
    xq = quant._quantize_act(x, 0.02)
    wq, sw = quant._quantize_weight(w)
    wk = conv_k3_int8.prepare(wq)
    assert torch.equal(conv_k3_int8.unprepare(wk), wq)
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(torch.ops.rtpose.conv3d_k3_int8(xq, wk, sw * 0.02, b, dt),
                           conv_k3_int8.conv3d_k3_int8_reference(xq, wq, sw * 0.02, b, dt))
    raw = torch.rand((2, 4, 5, 6, 7), generator=g).half()
    roi = [1, 3, 0, 5, 2, 6]
    assert torch.equal(torch.ops.rtpose.preprocess(raw, roi, 0.1, 2.0),
                       preprocess.preprocess_reference(raw, roi, 0.1, 2.0))


def test_custom_ops_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty((2, 3, 5, 7, 32), dtype=torch.bfloat16)
        xq = torch.empty((2, 3, 5, 7, 32), dtype=torch.int8)
        out = torch.ops.rtpose.conv3d_k3(x, torch.empty((9, 4, 3, 32, 8), dtype=torch.bfloat16),
                                         None)
        assert out.shape == x.shape and out.dtype == torch.bfloat16
        out = torch.ops.rtpose.conv3d_k3_int8(xq, torch.empty((9, 2, 3, 32, 16),
                                                          dtype=torch.int8),
                                              torch.empty(32), None, torch.float32)
        assert out.shape == xq.shape and out.dtype == torch.float32
        out = torch.ops.rtpose.preprocess(torch.empty((2, 4, 5, 6, 7), dtype=torch.float16),
                                          [1, 3, 0, 5, 2, 6], 0.0, 1.0)
        assert out.shape == (2, 3, 6, 5, 4) and out.dtype == torch.float32


# ---------------------------------------------------------------- CLIs

def test_cli_export_int8_then_test_exported(env, capsys, caplog):
    """``tools.export --int8 --device cpu`` then ``tools.test --exported``
    (the artifact saved and loaded): every frame's keypoints, and so MPJPE,
    equal to the live int8 run on the same frames and scales."""
    out = str(env["work"] / "int8_b2.pt2")
    res = export_cli.main([env["cfg_path"], "--checkpoint", env["ckpt"], "--out", out,
                           "--int8", "--batch_size", "2", "--calib_batches", "2",
                           "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"int8 calibration: {len(res['int8_scales'])} conv scales from 2 x batch-2 val" \
        in printed and "exported" in printed
    assert res["meta"]["int8_sites"] == len(res["int8_scales"]) == 52
    # the device is recorded in the artifact and another one refused
    with pytest.raises(ValueError, match="exported for cpu"):
        pexp.load_predict(out, device="cuda")
    with open(out, "rb") as f, pytest.raises(ValueError, match="exported for cpu"):
        pexp.load_predict(f.read(), device="cuda")
    # on the logger itself: a trainer run earlier in this process may have
    # turned its propagation off (engine.trainer.get_root_logger)
    logger = logging.getLogger("rtpose_tpu_torch")
    logger.addHandler(caplog.handler)
    pexp.reset()
    quant.reset()
    trace.enable()
    trace.take()
    try:
        got = test_cli.main([env["cfg_path"], "--exported", out, "--testset",
                             "--device", "cpu", "--speed_test"])
        spans = [s[0] for s in trace.take()]
    finally:
        trace.disable()
        logger.removeHandler(caplog.handler)
    assert "NOT the reference's batch-1 protocol" in caplog.text
    # the loaded program's calls are counted, each in a span; its int8 sites
    # run inside the program, where the Python site hooks do not
    assert pexp.counts() == dict(predict_calls=3, frames=6, int8_sites=52)
    assert got["eval_graphs"] == dict(captures=0, replays=0, eager=3,
                                      launches_per_replay={})    # CPU calls run eagerly
    assert spans.count("serve.predict") == 3 and "int8.site" not in spans
    assert set(quant.counts().values()) == {0}
    # outputs named after the artifact
    assert os.path.isfile(os.path.join(env["work"], "int8_b2", "test_prediction.json"))
    # the live int8 run: the same model, scales and frames, batch 2
    asm = assemble(env["cfg"])
    asm.model.load_state_dict(torch.load(env["ckpt"], weights_only=True)["state_dict"])
    asm.model.eval()
    live = pexp.make_predict_fn(asm, int8_scales=res["int8_scales"])
    ds = build_dataset_from_cfg(env["cfg"].data, "test")
    det, _ = run_eval(lambda b: live(b["rdr_tensor"]), BatchLoader(ds, batch_size=2),
                      asm.decode_spec, device=torch.device("cpu"))
    want, _ = ds.evaluation(det, testset=True)
    assert got["results"]["MPJPE"] == want["results"]["MPJPE"]
    assert got["detections"] == det


@pytest.mark.parametrize("flag,msg", [
    (["--device_preprocess"], "--exported artifacts bake the normalized-input"),
    (["--final_dtype", "bfloat16"], "--final_dtype applies to the live model"),
])
def test_cli_test_exported_refuses_flags(env, flag, msg):
    with pytest.raises(SystemExit, match=msg):
        test_cli.main([env["cfg_path"], "--exported", "x.pt2", "--device", "cpu", *flag])
    with pytest.raises(SystemExit, match="one of --checkpoint or --exported"):
        test_cli.main([env["cfg_path"], "--device", "cpu"])


def test_calib_batches_are_contiguous(env, monkeypatch):
    """Dataset items are transposed views and ``np.stack`` keeps their
    layout; the kernels take contiguous inputs, so the calibration batches
    must be made contiguous (a strided batch reaches K3 and raises there)."""
    import rtpose_tpu_torch.api as api

    rng = np.random.default_rng(1)
    items = [{"rdr_tensor": rng.normal(size=(4, 8, 16, 32)).astype(np.float32)
              .transpose(1, 2, 3, 0)} for _ in range(4)]
    monkeypatch.setattr(api, "build_dataset_from_cfg", lambda cfg, split, **kw: items)
    batches = export_cli.collect_calib_batches(env["cfg"], 2, 2, "val", torch.device("cpu"))
    assert len(batches) == 2 and all(b.is_contiguous() for b in batches)
    assert torch.equal(batches[1][0], torch.from_numpy(items[2]["rdr_tensor"]))


def test_int8_diag_cli(env, tmp_path, capsys):
    """``tools.int8_diag`` on the CPU: the scale spectrum over every site,
    the live and int8 MPJPE, the group probes and the quantile probe.  Its
    batches are of 8 frames, so it gets a root with 8 test frames."""
    from rtpose_tpu_torch.tools import int8_diag

    root = str(tmp_path / "data")
    generate_synthetic_dataset(
        root, num_seqs=2, frames_per_seq=2, test_frames_per_seq=4,
        rdr_type="zyx_real", seed=6,
        pelvis_range={"x": (1.0, 2.0), "y": (-1.0, 1.0), "z": (-0.5, 1.2)},
        offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7))
    src = open(os.path.join(REPO, "tests", "test_e2e_cli.py")).read()
    tpl = re.search(r"CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1)
    cfg_path = str(tmp_path / "tiny.py")
    with open(cfg_path, "w") as f:
        f.write(tpl.format(root=root, roi=TINY_ROI))
    res = int8_diag.main([cfg_path, "--checkpoint", env["ckpt"], "--frames", "8",
                          "--calib_batches", "1", "--groups", "--quantile", "0.999",
                          "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "# 52 calibrated sites" in printed and len(res["scales"]) == 52
    assert np.isfinite(res["base_mm"])
    probes = res["probes"]
    assert "int8 ALL" in probes and "int8 ALL @ q=0.999" in probes
    assert any(k.startswith("only stage2 (") for k in probes)
    assert any(k.startswith("all but hm tower (") for k in probes)
    assert all(np.isfinite(v) for v in probes.values())
