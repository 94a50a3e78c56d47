"""Sparse predict and decode: the port's ``predict_sparse`` equals its dense
forward at the peak (including peaks on the volume's faces and corners),
with and without the head's shared conv, and the decode / post-processing /
metric functions equal rtpose_tpu's on the same arrays, ties included.

With a shared conv (``_phase``'s head) the port's sparse paths are held to
JAX's **dense** forward: the JAX package's sparse paths send each 5^3 patch
through the shared conv, which needs the whole volume, and the port leaves
that answer (``models/detectors.py``).

Tolerances: sparse vs dense within the port, 1e-5 of max|reg| (the patch
and the full volume sum the same products, in float32); the port against
JAX's forward, 1e-3 of max|reg| (the frameworks sum the convs in other
orders, ``tests/test_torch_slice.py``); decode against JAX, 1e-6 m / 1e-6
on scores (float32 rounding of the same formulas); labels and indices exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rtpose_tpu.core import decode as jdec
from rtpose_tpu.core import metrics as jmet
from rtpose_tpu.models import build_detector as jax_build_detector
from rtpose_tpu_torch.engine import state_dict_from_jax
from rtpose_tpu_torch.core import decode as tdec
from rtpose_tpu_torch.core import metrics as tmet
from rtpose_tpu_torch.models import build_detector, init_weights

GRID = (8, 16, 32)
SPEC = dict(grid_zyx=GRID, pc_range_min_xyz=(0.0, -2.0, -1.0),
            voxel_size_xyz=(0.1, 0.25, 0.25))
CFG = dict(type="RadarPoseNet", reader=dict(type="RadarFeatureNet"),
           backbone=dict(type="HRNet3D", backbone_cfg="hr_tiny_feat32_zyx_l4_in32",
                         final_conv_in=192, final_conv_out=128),
           pose_head=dict(type="CenterHead",
                          tasks=[dict(num_class=1, class_names=["Pelvis"])],
                          in_channels=128, share_conv_channel=128,
                          common_heads={"reg": (45, 2)}))
# the head with a shared conv (GroupNorm, 3x3x3 128 -> 64, ReLU), as _phase's
SHARED_CFG = dict(CFG, pose_head=dict(CFG["pose_head"], share_conv_channel=64))


@pytest.fixture(scope="module", params=["flagship", "shared_conv"])
def model(request):
    cfg = CFG if request.param == "flagship" else SHARED_CFG
    return init_weights(build_detector(cfg), torch.Generator().manual_seed(0)).eval()


def test_predict_sparse_equals_dense(model):
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, *GRID, 32)).astype(np.float32))
    with torch.no_grad():
        dense = model(x)[0]
        hm, reg_at_peak, peak = model.predict_sparse(x)
    torch.testing.assert_close(hm, dense["hm"], rtol=0, atol=0)
    flat = dense["hm"].reshape(3, -1).argmax(dim=1)
    assert torch.equal(peak, flat)
    want = dense["reg"].reshape(3, -1, 45)[torch.arange(3), peak]
    scale = want.abs().max().item()
    torch.testing.assert_close(reg_at_peak, want, rtol=0, atol=1e-5 * scale)
    kd = tdec.decode_pose_preds(dense["hm"], dense["reg"], tdec.DecodeSpec(**SPEC))
    ks = tdec.decode_pose_sparse(hm, reg_at_peak, peak, tdec.DecodeSpec(**SPEC))
    torch.testing.assert_close(ks[0], kd[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(ks[1], kd[1])
    assert torch.equal(ks[2], kd[2])


def test_reg_patches_at_faces_and_corners(model):
    """The 5^3 patch reproduces the dense conv's zero padding at the volume
    edges: corners, faces and interior points."""
    Z, Y, X = GRID
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, *GRID, 32)).astype(np.float32))
    pts = [(0, 0, 0), (Z - 1, Y - 1, X - 1), (0, Y - 1, 3), (1, 0, X - 2),
           (Z - 2, 7, 0), (4, 8, 16), (2, 1, 30)]
    with torch.no_grad():
        feat = model.shared(model.extract_feat(x))
        dense = model.pose_head.heads(feat, branch="reg")[0]["reg"][0]
        n = len(pts)
        z, y, xx = (torch.tensor(c) for c in zip(*pts))
        got = model._reg_patches(feat.expand(n, -1, -1, -1, -1), z, y, xx, GRID)
    want = torch.stack([dense[p] for p in pts])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_small_grid_takes_the_dense_path(model):
    """A grid smaller than the 5^3 receptive field: dense reg + gather."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 4, 8, 8, 32)).astype(np.float32))
    with torch.no_grad():
        dense = model(x)[0]
        _, reg_at_peak, peak = model.predict_sparse(x)
    want = dense["reg"].reshape(2, -1, 45)[torch.arange(2), peak]
    torch.testing.assert_close(reg_at_peak, want, rtol=0, atol=0)


@pytest.fixture(scope="module")
def jax_shared():
    """The JAX detector with a shared conv and its flax weights, and the
    port's with the same weights."""
    jmodel = jax_build_detector(SHARED_CFG)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *GRID, 32), jnp.float32))
    port = build_detector(SHARED_CFG)
    port.load_state_dict(state_dict_from_jax(params))
    return jmodel, params, port.eval()


def test_shared_conv_sparse_paths_follow_jax_dense_forward(jax_shared):
    """``predict_sparse``'s and ``forward_sparse_train``'s regression at the
    peak and at face and corner targets against JAX's dense forward
    gathered there; JAX's own sparse predict misses it (the recorded
    divergence)."""
    jmodel, params, port = jax_shared
    Z, Y, X = GRID
    x = np.random.default_rng(10).normal(size=(1, *GRID, 32)).astype(np.float32)
    preds = jmodel.apply(params, jnp.asarray(x))[0]
    jhm = np.asarray(preds["hm"])
    jreg = np.asarray(preds["reg"]).reshape(1, -1, 45)
    scale = np.abs(jreg).max()
    pts = [(0, 0, 0), (Z - 1, Y - 1, X - 1), (0, Y - 1, 3), (4, 8, 16)]
    ind = torch.tensor([[(z * Y + y) * X + xx for z, y, xx in pts]])
    with torch.no_grad():
        hm, reg_at_peak, peak = port.predict_sparse(torch.from_numpy(x))
        hm_t, reg_at_ind = port.forward_sparse_train(torch.from_numpy(x), ind)
    np.testing.assert_allclose(hm.numpy(), jhm, atol=1e-3 * np.abs(jhm).max())
    np.testing.assert_allclose(hm_t.numpy(), jhm, atol=1e-3 * np.abs(jhm).max())
    assert int(peak[0]) == int(jhm.reshape(-1).argmax())
    np.testing.assert_allclose(reg_at_peak.numpy(), jreg[:, int(peak[0])], atol=1e-3 * scale)
    np.testing.assert_allclose(reg_at_ind.numpy(), jreg[:, ind[0].numpy()], atol=1e-3 * scale)
    _, jsparse, _ = jmodel.apply(params, jnp.asarray(x), method="predict_sparse")
    assert np.abs(np.asarray(jsparse) - jreg[:, int(peak[0])]).max() > 1e-2 * scale


def _hm_with_ties(B, C, rng):
    hm = rng.normal(size=(B, *GRID, C)).astype(np.float32)
    flat = hm.reshape(B, -1, C)
    for b in range(B):
        for c in range(C):
            i, j = sorted(rng.choice(flat.shape[1], 2, replace=False))
            flat[b, i, c] = flat[b, j, c] = 10.0     # a tie: the first wins
    return hm


def test_flat_argmax_ties():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 4, size=(5, 64)).astype(np.float32)   # many ties
    got = tdec.flat_argmax(torch.from_numpy(v), dim=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdec.flat_argmax(jnp.asarray(v))))
    np.testing.assert_array_equal(got, v.argmax(axis=1))


@pytest.mark.parametrize("K", [15, 1])
def test_decode_dense_matches_jax(K):
    """One-heatmap head (C = 1, 45-dim reg) and per-joint heads (C = 15,
    3-dim reg)."""
    rng = np.random.default_rng(4)
    C = 1 if K == 15 else 15
    hm = _hm_with_ties(2, C, rng)
    reg = rng.normal(size=(2, *GRID, 3 * K)).astype(np.float32)
    want = jdec.decode_pose_preds(jnp.asarray(hm), jnp.asarray(reg), jdec.DecodeSpec(**SPEC))
    got = tdec.decode_pose_preds(torch.from_numpy(hm), torch.from_numpy(reg),
                                 tdec.DecodeSpec(**SPEC))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_decode_sparse_matches_jax():
    rng = np.random.default_rng(5)
    hm = _hm_with_ties(3, 1, rng)
    peak = np.array(jdec.flat_argmax(jnp.asarray(hm.reshape(3, -1))))
    reg = rng.normal(size=(3, 45)).astype(np.float32)
    want = jdec.decode_pose_sparse(jnp.asarray(hm), jnp.asarray(reg),
                                   jnp.asarray(peak), jdec.DecodeSpec(**SPEC))
    got = tdec.decode_pose_sparse(torch.from_numpy(hm), torch.from_numpy(reg),
                                  torch.from_numpy(peak), tdec.DecodeSpec(**SPEC))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("spec", [
    SPEC,
    dict(grid_zyx=(16, 64, 160), pc_range_min_xyz=(0.7703125, -1.25625, -1.0875),
         voxel_size_xyz=(0.009375, 0.0392578125, 0.18125)),
    dict(grid_zyx=GRID, pc_range_min_xyz=(0.1, -0.3, -1.7), voxel_size_xyz=(0.3, 0.7, 0.11),
         out_size_factor_zyx=(2, 1, 3))])
def test_voxel_to_world_equals_the_float32_tensor_formula(spec):
    """Python-float scale and offset give, bit for bit, the float32 values
    of ``vox * tensor(scale, float32) + tensor(offset, float32)``."""
    s = tdec.DecodeSpec(**spec)
    (fz, fy, fx), (sx, sy, sz) = s.out_size_factor_zyx, s.voxel_size_xyz
    scale = torch.tensor([sx * fx, sy * fy, sz * fz], dtype=torch.float32)
    offset = torch.tensor(s.pc_range_min_xyz, dtype=torch.float32)
    vox = torch.from_numpy(np.random.default_rng(8).uniform(
        -20.0, 200.0, size=(64, 15, 3)).astype(np.float32))
    got = tdec._voxel_to_world(vox, s)
    assert got.dtype == torch.float32
    assert torch.equal(got, vox * scale + offset)


def test_dense_radar_eval_step_runs_eagerly_on_the_cpu(model):
    """``make_eval_step`` of a dense radar input is an ``EvalGraphs``; on
    the CPU every call is eager (no capture, no replay) and gives the plain
    step's answer; the voxel-input step stays a plain function."""
    from rtpose_tpu_torch.engine import EvalGraphs, make_eval_step

    spec = tdec.DecodeSpec(**SPEC)
    step = make_eval_step(model, spec, sparse=True)
    assert isinstance(step, EvalGraphs)
    assert not isinstance(make_eval_step(model, spec, input_key=None), EvalGraphs)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, *GRID, 32)).astype(np.float32))
    first, second = step({"rdr_tensor": x}), step({"rdr_tensor": x})
    assert step.counts() == dict(captures=0, replays=0, eager=2, launches_per_replay={})
    for a, b, c in zip(first[0], second[0], step.step({"rdr_tensor": x})[0]):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("threshold,one_hm", [(0.0, True), (0.5, True), (0.5, False)])
def test_post_process_matches_jax(threshold, one_hm):
    """Threshold rules, including a score that underflowed to exactly 0.0
    (kept when the threshold is <= 0)."""
    rng = np.random.default_rng(6)
    kpts = rng.normal(size=(3, 15, 3)).astype(np.float32)
    scores = rng.uniform(size=(3, 15)).astype(np.float32)
    scores[0, 0] = 0.0
    labels = np.tile(np.arange(15, dtype=np.int32), (3, 1))
    metas = [{"seq": "0", "frame": f"f{b}", "rdr_frame": str(b)} for b in range(3)]
    want = jdec.post_process_pose(kpts, scores, labels, jdec.DecodeSpec(
        **SPEC, score_threshold=threshold), metas=metas, one_hm=one_hm)
    got = tdec.post_process_pose(kpts, scores, labels, tdec.DecodeSpec(
        **SPEC, score_threshold=threshold), metas=metas, one_hm=one_hm)
    assert got == want


def test_metrics_match_jax_package():
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(15, 3)), rng.normal(size=(15, 3))
    np.testing.assert_array_equal(tmet.pjpe(a, b), jmet.pjpe(a, b))
    np.testing.assert_array_equal(tmet.abs_pjpe(a, b), jmet.abs_pjpe(a, b))
