"""One train step of the port against rtpose_tpu's ``make_train_step``, in
float32 on the CPU, from the same weights (``state_dict_from_jax``) and the
same numpy batch: dense and ``sparse_reg``.

Tolerances: the two frameworks sum the convs in different orders, so the
float32 loss terms and the gradient norm agree to rtol 1e-4; each gradient
leaf to 1e-3 of its largest value (the backward through ~20 layers
accumulates more of that order noise than the forward).  Parameters after
one Adam step (one-cycle, fixed_wd) are bounded as in
``tests/test_solver_engine.py::TestRemat``: Adam's first step moves every
element by about +-lr whatever the gradient's size, so a near-zero gradient
whose sign differs between the two frameworks moves 2 lr apart; every
difference stays within 2.05 lr and fewer than 1e-3 of the elements differ
by more than 1e-5.  The JAX gradients come out of ``make_train_step``
itself, through an optimizer that keeps them as its state.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from rtpose_tpu.core.targets import PoseTargetSpec as JaxSpec
from rtpose_tpu.engine import create_train_state as jax_create_state
from rtpose_tpu.engine import make_train_step as jax_make_train_step
from rtpose_tpu.models import CenterHead as JaxHead
from rtpose_tpu.models import build_detector as jax_build
from rtpose_tpu.solver import adam_one_cycle as jax_adam
from rtpose_tpu.solver import piecewise_weight as jax_piecewise

from rtpose_tpu_torch.core.targets import PoseTargetSpec
from rtpose_tpu_torch.engine import (create_train_state, make_loss_fn, make_train_step,
                                     state_dict_from_jax)
from rtpose_tpu_torch.models import build_detector
from rtpose_tpu_torch.solver import AdamOneCycle, piecewise_weight

GRID = (8, 8, 16)           # >= 5 per axis: the sparse path takes 5^3 patches
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
SPEC_KW = dict(grid_zyx=GRID, pc_range_min_xyz=(0.0, -4.0, -1.0),
               voxel_size_xyz=(0.5, 1.0, 0.5), max_poses=1, min_radius=2,
               mode="one_hm", num_classes=1)


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    Z, Y, X = GRID
    poses = (rng.uniform(0.2, 0.8, size=(B, 1, 15, 3)) * np.array([X, Y, Z])
             * np.array([0.5, 1.0, 0.5]) + np.array([0.0, -4.0, -1.0]))
    return {"rdr_tensor": rng.normal(size=(B, Z, Y, X, 1)).astype(np.float32),
            "poses": poses.astype(np.float32),
            "num_poses": np.ones((B,), np.int32)}


def _grad_keeper():
    """An optax transformation whose state after an update is the gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def env():
    jmodel = jax_build(MODEL_CFG)
    jhead = JaxHead(**{k: v for k, v in MODEL_CFG["pose_head"].items() if k != "type"})
    batch = _batch(0)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["rdr_tensor"]))
    params = jax.tree.map(np.array, params)
    return dict(jmodel=jmodel, jhead=jhead, params=params, batch=batch,
                sd=state_dict_from_jax(params))


def _port_model(env):
    model = build_detector(MODEL_CFG)
    model.load_state_dict(env["sd"])
    return model


def _jax_step(env, sparse, loc_weight_fn=None):
    state = jax_create_state(env["jmodel"], _grad_keeper(), jnp.asarray(env["batch"]["rdr_tensor"]))
    state = state.replace(params=jax.tree.map(jnp.asarray, env["params"]),
                          opt_state=jax.tree.map(jnp.zeros_like, env["params"]))
    step = jax.jit(jax_make_train_step(env["jmodel"], env["jhead"], JaxSpec(**SPEC_KW),
                                       _grad_keeper(), lr_fn=lambda s: jnp.float32(LR),
                                       sparse_reg=sparse, loc_weight_fn=loc_weight_fn))
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in env["batch"].items()})
    return jax.device_get(new_state.opt_state), jax.device_get(metrics)


def _port_step(env, sparse, loc_weight_fn=None, remat=False):
    model = _port_model(env)
    params = list(model.parameters())
    opt = AdamOneCycle(params, lambda s: torch.tensor(LR), None, beta2=0.999,
                       weight_decay=0.0, grad_clip_norm=None)
    loss_fn = make_loss_fn(model, model.pose_head, PoseTargetSpec(**SPEC_KW),
                           sparse_reg=sparse, remat=remat, loc_weight_fn=loc_weight_fn)
    batch = {k: torch.from_numpy(v) for k, v in env["batch"].items()}
    loss, _ = loss_fn(batch, torch.zeros((), dtype=torch.int64))
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    for p in params:
        p.grad = None
    step = make_train_step(model, model.pose_head, PoseTargetSpec(**SPEC_KW), opt,
                           lr_fn=lambda s: torch.tensor(LR), sparse_reg=sparse,
                           remat=remat, loc_weight_fn=loc_weight_fn)
    state = create_train_state(model, opt)
    _, metrics = step(state, batch)
    return model, opt, state, grads, metrics


@pytest.fixture(scope="module", params=["dense", "sparse"])
def pair(request, env):
    sparse = request.param == "sparse"
    # the sparse case also carries a loc-weight schedule (early weight at step 0)
    lw = (jax_piecewise(0.3, 1.5, 1), piecewise_weight(0.3, 1.5, 1)) if sparse else (None, None)
    jgrads, jmetrics = _jax_step(env, sparse, lw[0])
    port = _port_step(env, sparse, lw[1])
    return dict(sparse=sparse, jgrads=jgrads, jmetrics=jmetrics, port=port)


def test_metrics_match_jax(pair):
    _, _, state, _, metrics = pair["port"]
    jm = pair["jmetrics"]
    for k in ("loss", "hm_loss", "loc_loss", "grad_norm", "num_positive"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(metrics["loc_loss_elem"].numpy(), np.asarray(jm["loc_loss_elem"]),
                               rtol=1e-4, atol=1e-6)
    assert float(metrics["skipped"]) == float(jm["skipped"]) == 0.0
    assert float(metrics["lr"]) == pytest.approx(LR)
    if pair["sparse"]:
        assert float(metrics["loc_weight"]) == float(jm["loc_weight"]) == 1.5
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(metrics["hm_loss"]) + 1.5 * float(metrics["loc_loss"]),
                                   rtol=1e-6)
    assert int(state.step) == 1


def test_grads_match_jax_leaf_by_leaf(pair):
    grads = pair["port"][3]
    want = state_dict_from_jax(pair["jgrads"])
    assert sorted(want) == sorted(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def test_params_after_one_step_within_adam_bound(pair, env):
    model = pair["port"][0]
    jopt = jax_adam(lambda s: jnp.float32(LR), None, beta2=0.999, weight_decay=0.0,
                    grad_clip_norm=None)
    jp = jax.tree.map(jnp.asarray, env["params"])
    upd, _ = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, pair["jgrads"]), jopt.init(jp), jp)
    want = state_dict_from_jax(jax.device_get(optax.apply_updates(jp, upd)))
    total = mismatched = 0
    for k, p in model.state_dict().items():
        d = np.abs(p.numpy() - want[k].numpy())
        assert d.max() <= 2.05 * LR, (k, d.max())
        total += d.size
        mismatched += int((d > 1e-5).sum())
    assert mismatched / total < 1e-3


def test_nan_loss_skips_the_step(env):
    """A non-finite loss keeps parameters, moments and the optimizer's step
    count; the global step still advances (steps.py:169-174, 191-192)."""
    model = _port_model(env)
    opt = AdamOneCycle(list(model.parameters()), lambda s: torch.tensor(LR), None)
    step = make_train_step(model, model.pose_head, PoseTargetSpec(**SPEC_KW), opt,
                           lr_fn=lambda s: torch.tensor(LR))
    state = create_train_state(model, opt)
    good = {k: torch.from_numpy(v) for k, v in env["batch"].items()}
    state, m = step(state, good)
    assert float(m["skipped"]) == 0.0 and int(opt.step_count) == 1
    before = ({k: v.clone() for k, v in model.state_dict().items()},
              opt.mu.clone(), opt.nu.clone())
    bad = dict(good, rdr_tensor=torch.full_like(good["rdr_tensor"], float("nan")))
    state, m = step(state, bad)
    assert float(m["skipped"]) == 1.0 and not np.isfinite(float(m["loss"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[0][k]), k
    assert torch.equal(opt.mu, before[1]) and torch.equal(opt.nu, before[2])
    assert int(opt.step_count) == 1 and int(state.step) == 2


def test_remat_matches_plain_step(env):
    """``remat`` (torch.utils.checkpoint) gives the same loss, and an update
    within TestRemat's bound of the plain step's."""
    plain = _port_step(env, sparse=True)
    remat = _port_step(env, sparse=True, remat=True)
    assert float(plain[4]["loss"]) == pytest.approx(float(remat[4]["loss"]), rel=1e-6)
    total = mismatched = 0
    b = remat[0].state_dict()
    for k, p in plain[0].state_dict().items():
        d = np.abs(p.numpy() - b[k].numpy())
        assert d.max() <= 2.05 * LR, (k, d.max())
        total += d.size
        mismatched += int((d > 1e-5).sum())
    assert mismatched / total < 1e-3
