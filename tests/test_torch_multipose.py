"""The port's multi-person path against rtpose_tpu's, on the CPU:
``decode_pose_multi`` (top-k ties on a heatmap plateau and on sigmoids that
underflowed to 0.0, peaks on the volume's border), ``post_process_pose_multi``
with its underflow quirk, the dense train step at ``max_poses=2``,
``run_eval`` on a tiny two-person root, and a multi-person export artifact
against the live model.

Tolerances: the decode evaluates the same formulas on the same arrays, so
indices and scores are identical and keypoints agree to 1e-5 m.  The train
step is held as ``tests/test_torch_train_step.py`` holds it (loss terms and
gradient norm to rtol 1e-4, each gradient leaf to 1e-3 of its largest
value).  Eval runs two models whose convs sum in different orders: the same
peaks, keypoints to 1e-4 m, MPJPE to 0.01 mm (``tests/test_torch_slice.py``).
"""

import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from rtpose_tpu.api import assemble as jax_assemble
from rtpose_tpu.api import build_dataset_from_cfg as jax_dataset
from rtpose_tpu.config import Config as JaxConfig
from rtpose_tpu.core import decode as jdec
from rtpose_tpu.core.targets import PoseTargetSpec as JaxSpec
from rtpose_tpu.data import BatchLoader as JaxLoader
from rtpose_tpu.engine import create_train_state as jax_create_state
from rtpose_tpu.engine import make_eval_step as jax_eval_step
from rtpose_tpu.engine import make_train_step as jax_make_train_step
from rtpose_tpu.engine import run_eval as jax_run_eval
from rtpose_tpu.models import CenterHead as JaxHead
from rtpose_tpu.models import build_detector as jax_build

from rtpose_tpu_torch import export as pexp
from rtpose_tpu_torch.api import assemble
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.core import decode as tdec
from rtpose_tpu_torch.core.targets import PoseTargetSpec
from rtpose_tpu_torch.data import generate_synthetic_dataset
from rtpose_tpu_torch.engine import make_loss_fn, save_checkpoint, state_dict_from_jax
from rtpose_tpu_torch.tools import test as port_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (8, 16, 32)
SPEC = dict(grid_zyx=GRID, pc_range_min_xyz=(0.0, -2.0, -1.0),
            voxel_size_xyz=(0.1, 0.25, 0.25))
TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}  # -> grid (8, 16, 32)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the cores: cap torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _planted_logits(B, rng):
    """Logits with a plateau (a 2x2x2 block of equal maxima: every voxel of
    it a local maximum), peaks on the volume's corners and faces, and one
    sample whose sigmoids mostly underflow to 0.0 (ties at zero)."""
    hm = rng.normal(size=(B, *GRID, 1)).astype(np.float32)
    Z, Y, X = GRID
    hm[0, 3:5, 6:8, 10:12, 0] = 9.0
    hm[0, 0, 0, 0, 0] = 8.0
    hm[0, Z - 1, Y - 1, X - 1, 0] = 8.5
    hm[1, 0, Y - 1, 5, 0] = 7.0
    hm[2] = -200.0                      # sigmoid 0.0 in float32
    hm[2, 4, 4, 4, 0] = 3.0
    return hm


@pytest.mark.parametrize("P", [2, 5, 12])
def test_decode_multi_matches_jax(P):
    rng = np.random.default_rng(0)
    hm = _planted_logits(3, rng)
    reg = rng.normal(size=(3, *GRID, 45)).astype(np.float32)
    wk, ws = jdec.decode_pose_multi(jnp.asarray(hm), jnp.asarray(reg),
                                    jdec.DecodeSpec(**SPEC), max_objects=P)
    gk, gs = tdec.decode_pose_multi(torch.from_numpy(hm), torch.from_numpy(reg),
                                    tdec.DecodeSpec(**SPEC), max_objects=P)
    assert gk.shape == (3, P, 15, 3) and gs.shape == (3, P)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0, atol=1e-5)
    if P >= 5:      # the plateau's first voxels, lowest index first
        assert float(gs[0, 0]) == float(gs[0, 3]) == float(torch.sigmoid(torch.tensor(9.0)))
    assert float(gs[2, 0]) > 0 and (gs[2, 1:] == 0).all()


def test_top_k_ties_lowest_index_first():
    v = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 0.0, 0.0]])
    vals, idx = tdec.top_k_lowest_index(v, 6)
    wv, wi = jax.lax.top_k(jnp.asarray(v.numpy()), 6)
    assert idx.tolist() == np.asarray(wi).tolist() == [[1, 2, 4, 0, 3, 5]]
    assert vals.tolist() == np.asarray(wv).tolist()


@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_post_process_multi_matches_jax(threshold):
    """Including a pose after the first whose score underflowed to 0.0: at
    threshold 0.0 it is dropped, as in the JAX package."""
    rng = np.random.default_rng(1)
    kpts = rng.normal(size=(3, 3, 15, 3)).astype(np.float32)
    scores = np.array([[0.9, 0.0, 0.0], [0.8, 0.5, 0.2], [0.0, 0.4, 0.25]], np.float32)
    metas = [{"seq": "0", "frame": f"f{b}", "rdr_frame": str(b)} for b in range(3)]
    want = jdec.post_process_pose_multi(kpts, scores, jdec.DecodeSpec(
        **SPEC, score_threshold=threshold), metas=metas)
    got = tdec.post_process_pose_multi(kpts, scores, tdec.DecodeSpec(
        **SPEC, score_threshold=threshold), metas=metas)
    assert got == want
    assert len(got[0]["keypoints"]) == 15                 # the 0.0 poses dropped
    assert len(got[2]["keypoints"]) == (45 if threshold == 0.0 else 30)


TRAIN_GRID = (8, 8, 16)
LR = 1e-3
MODEL_CFG = dict(
    type="RadarPoseNet",
    reader=dict(type="RadarFeatureNet"),
    backbone=dict(type="HRNet3D", backbone_cfg="hr_tiny_feat16_zyx_l4",
                  final_conv_in=176, final_conv_out=64, final_fuse="conat_conv",
                  ds_factor=1),
    pose_head=dict(type="CenterHead", tasks=[dict(num_class=1, class_names=["Pelvis"])],
                   in_channels=64, share_conv_channel=64, common_heads={"reg": (45, 2)},
                   weight=0.5, code_weights=[1.0] * 45),
    neck=None,
)
SPEC_KW = dict(grid_zyx=TRAIN_GRID, pc_range_min_xyz=(0.0, -4.0, -1.0),
               voxel_size_xyz=(0.5, 1.0, 0.5), max_poses=2, min_radius=2,
               mode="one_hm", num_classes=1)


def _grad_keeper():
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def test_dense_train_step_two_poses_matches_jax():
    """max_poses=2: two people in the first sample, one in the second; the
    targets assigned on the device at max_objects=2, the dense step.  The
    data seed is ``tests/test_torch_train_step.py``'s (0).  Another draw
    (seed 2) put two backbone leaves 1 % apart at max_poses 1 and 2 alike
    (a GroupNorm of small variance amplifying the float32 summation order):
    the input's conditioning, not the multi-person path."""
    rng = np.random.default_rng(0)
    Z, Y, X = TRAIN_GRID
    B = 2
    poses = (rng.uniform(0.2, 0.8, size=(B, 2, 15, 3)) * np.array([X, Y, Z])
             * np.array([0.5, 1.0, 0.5]) + np.array([0.0, -4.0, -1.0]))
    batch = {"rdr_tensor": rng.normal(size=(B, Z, Y, X, 1)).astype(np.float32),
             "poses": poses.astype(np.float32), "num_poses": np.array([2, 1], np.int32)}
    jmodel = jax_build(MODEL_CFG)
    jhead = JaxHead(**{k: v for k, v in MODEL_CFG["pose_head"].items() if k != "type"})
    params = jax.tree.map(np.array, jmodel.init(jax.random.PRNGKey(0),
                                                jnp.asarray(batch["rdr_tensor"])))
    state = jax_create_state(jmodel, _grad_keeper(), jnp.asarray(batch["rdr_tensor"]))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          opt_state=jax.tree.map(jnp.zeros_like, params))
    step = jax.jit(jax_make_train_step(jmodel, jhead, JaxSpec(**SPEC_KW), _grad_keeper(),
                                       lr_fn=lambda s: jnp.float32(LR)))
    new_state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = state_dict_from_jax(jax.device_get(new_state.opt_state))
    assert float(jm["num_positive"]) == 3.0

    from rtpose_tpu_torch.models import build_detector
    model = build_detector(MODEL_CFG)
    model.load_state_dict(state_dict_from_jax(params))
    loss_fn = make_loss_fn(model, model.pose_head, PoseTargetSpec(**SPEC_KW))
    loss, losses = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                           torch.zeros((), dtype=torch.int64))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    for got, key in ((loss.detach(), "loss"), (losses["hm_loss"][0].detach(), "hm_loss"),
                     (losses["loc_loss"][0].detach(), "loc_loss"), (gnorm, "grad_norm"),
                     (losses["num_positive"][0], "num_positive")):
        np.testing.assert_allclose(float(got), float(jm[key]), rtol=1e-4, err_msg=key)
    assert sorted(grads) == sorted(jgrads)
    for k, g in grads.items():
        w = jgrads[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


@pytest.fixture(scope="module")
def mp_env(tmp_path_factory):
    """A tiny two-person root, the tiny config at max_poses=2, and shared
    weights (flax, carried into a port checkpoint)."""
    root = str(tmp_path_factory.mktemp("mp_data"))
    generate_synthetic_dataset(
        root, num_seqs=2, frames_per_seq=1, test_frames_per_seq=3, rdr_type="zyx_real",
        seed=6, persons_per_frame=2,
        pelvis_range={"x": (0.9, 2.1), "y": (-1.1, 1.1), "z": (-0.5, 1.2)},
        offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7))
    src = open(os.path.join(REPO, "tests", "test_e2e_cli.py")).read()
    tpl = re.search(r"CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1)
    text = tpl.format(root=root, roi=TINY_ROI).replace("max_poses=1", "max_poses=2")
    assert "max_poses=2" in text
    work = tmp_path_factory.mktemp("mp_work")
    cfg_path = str(work / "tiny_mp2.py")
    with open(cfg_path, "w") as f:
        f.write(text)
    cfg = JaxConfig.fromfile(cfg_path)
    asm = jax_assemble(cfg)
    assert asm.multi_poses == 2 and not asm.sparse_head
    params = jax.tree.map(np.array, asm.model.init(jax.random.PRNGKey(5),
                                                   asm.example_input()))
    params["params"]["head_m"]["task0"]["reg_out"]["kernel"] *= 0.01
    ckpt = save_checkpoint(str(work / "epoch_1.pth"), state_dict_from_jax(params),
                           meta={"epoch": 1})
    return dict(root=root, cfg_path=cfg_path, cfg=cfg, asm=asm, params=params,
                ckpt=ckpt, work=work)


def test_run_eval_two_persons_matches_jax(mp_env):
    cfg, asm = mp_env["cfg"], mp_env["asm"]
    ds = jax_dataset(cfg.data, "test", max_poses=2)
    loader = JaxLoader(ds, batch_size=int(cfg.data["samples_per_gpu"]), shuffle=False,
                       drop_last=False)
    step = jax_eval_step(asm.model, asm.head, asm.decode_spec, multi_poses=2)
    jdet, _ = jax_run_eval(step, mp_env["params"], loader, asm.decode_spec)
    jres, _ = ds.evaluation(jdet, testset=True)
    out = port_test.main([mp_env["cfg_path"], "--checkpoint", mp_env["ckpt"], "--work_dir",
                          str(mp_env["work"] / "eval"), "--testset", "--device", "cpu"])
    pdet = out["detections"]
    assert len(ds) == 6 and sorted(pdet) == sorted(jdet)
    people = 0
    for key in jdet:
        a, b = jdet[key]["keypoints"], pdet[key]["keypoints"]
        assert len(a) == len(b) == 30
        assert [p[0] for p in a] == [p[0] for p in b]
        np.testing.assert_allclose(np.asarray(b)[:, 1:4], np.asarray(a)[:, 1:4], atol=1e-4)
        np.testing.assert_allclose(np.asarray(b)[:, 4], np.asarray(a)[:, 4], rtol=1e-4)
        seq, frame, _ = key.split("/")
        people += len(ds.samples[[i for i, s in enumerate(ds.samples)
                                  if (s["seq"], s["frame"]) == (seq, frame)][0]]["poses"])
    assert people == 12        # every test frame carries its two people
    for k in ("MPJPE", "ABS_MPJPE"):
        assert abs(out["results"][k] - jres["results"][k]) <= 0.01, k


def test_multi_person_export_equals_live(mp_env):
    """A ``_skel_mp2``-shaped artifact (dense forward + multi-peak decode):
    (kpts, scores) per task, equal to the live model bit for bit, saved and
    loaded."""
    asm = assemble(Config.fromfile(mp_env["cfg_path"]))
    asm.model.load_state_dict(torch.load(mp_env["ckpt"], weights_only=True)["state_dict"])
    asm.model.eval()
    x = torch.from_numpy(np.abs(np.random.default_rng(3).normal(
        size=(2, *asm.input_shape_zyxc))).astype(np.float32))
    live = pexp.make_predict_fn(asm)(x)
    ep = pexp.export_predict(asm, batch_size=2, device="cpu")
    assert ep.rtpose_meta["multi_poses"] == 2
    path = str(mp_env["work"] / "mp2.pt2")
    pexp.save_exported(path, ep)
    got = pexp.load_predict(path)(x)
    assert len(got) == len(live) == 1 and len(got[0]) == len(live[0]) == 2
    assert got[0][0].shape == (2, 2, 15, 3) and got[0][1].shape == (2, 2)
    for u, v in zip(got[0], live[0]):
        assert u.dtype == v.dtype and torch.equal(u, v)
