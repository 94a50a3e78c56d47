"""The training slice's pieces against rtpose_tpu, on the CPU, with numpy
inputs from a seed fed to both packages:

* K3 backward (``ops.conv_k3.Conv3dK3``'s plain backward on bf16 tensors)
  against ``jax.vjp`` of ``fold_conv.conv3d_naive``, against the Pallas
  ``_fused_bwd`` in interpret mode on the folded input, and against torch
  autograd of ``conv3d_k3_reference``.  Grad-input is rounded once to bf16
  from a float32 sum in both: one bf16 ulp (2^-7 relative) plus 2e-3 of the
  largest value.  Grad-weight is float32 on the same bf16 operands: 1e-4
  of the largest value (summation order).  Against the Pallas path, whose
  grad-weight is XLA's bf16 conv transpose (partial sums rounded to bf16 on
  the CPU: 0.58 % of the largest value off the float32 result, measured),
  1 % of the largest value.
* Targets and heatmaps (``one_hm`` and ``per_joint``, out-of-range pelvises,
  ``num_poses`` = 0): equal to 1e-6 relative (plus 1e-6 absolute: XLA may
  fuse the float32 world-to-voxel scaling differently).
* Losses (focal from logits and clamped, ``reg_loss``, no positives):
  rtol 1e-5 (float32 sums in two orders).
* The optimizer: a 100-step trajectory of ``AdamOneCycle`` against
  ``adam_one_cycle`` / ``build_optimizer_from_cfg`` fed the same gradient
  sequence, rtol 1e-5 / atol 1e-5 (the float32 cosine of the schedule and
  the norm's summation order differ in the last bits, and each of the 100
  steps moves a parameter by up to lr = 3e-3); ``one_cycle_values`` past
  the total, rtol 1e-6.
* The loader's epoch order: exactly the JAX loader's.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from jax.experimental.pallas import tpu as pltpu

from rtpose_tpu.config import Config as JaxConfig
from rtpose_tpu.core.targets import PoseTargetSpec as JaxSpec
from rtpose_tpu.core.targets import assign_pose_targets as jax_assign
from rtpose_tpu.data import BatchLoader as JaxLoader
from rtpose_tpu.models import losses as jl
from rtpose_tpu.ops import pallas_conv
from rtpose_tpu.ops.fold_conv import conv3d_naive, fold_x, unfold_x
from rtpose_tpu.solver import adam_one_cycle as jax_adam
from rtpose_tpu.solver import build_optimizer_from_cfg as jax_build_opt
from rtpose_tpu.solver import one_cycle_values as jax_one_cycle

from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.core.gaussian import gaussian_radius
from rtpose_tpu_torch.core.targets import PoseTargetSpec, assign_pose_targets
from rtpose_tpu_torch.data import BatchLoader
from rtpose_tpu_torch.models import losses as pl
from rtpose_tpu_torch.ops import conv_k3
from rtpose_tpu_torch.solver import (AdamOneCycle, build_optimizer_from_cfg,
                                     make_one_cycle_fns, one_cycle_values)

BF16_ULP = 2.0 ** -7


# ---------------------------------------------------------------- K3 backward

@pytest.fixture(scope="module")
def k3_case():
    """x (1, 3, 8, 32, 32): X folds to Xf = 8, the Pallas kernel's shape."""
    rng = np.random.default_rng(0)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    x = np.array(bf(rng.normal(size=(1, 3, 8, 32, 32))))
    w = np.array(bf(rng.normal(size=(3, 3, 3, 32, 32)) * 0.05))      # DHWIO
    g = np.array(bf(rng.normal(size=(1, 3, 8, 32, 32))))
    b = rng.normal(size=(32,)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = conv_k3.Conv3dK3.apply(xt, wt, bt)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    port = dict(gx=xt.grad.float().numpy(),
                gw=wt.grad.numpy().transpose(2, 3, 4, 1, 0), gb=bt.grad.numpy())
    return dict(x=x, w=w, g=g, b=b, out=out, port=port)


def _close_gx(got, want):
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=2e-3 * np.abs(want).max())


def test_k3_bwd_matches_jax_vjp_of_naive_conv(k3_case):
    c = k3_case
    _, vjp = jax.vjp(lambda x, w: conv3d_naive(x, w), jnp.asarray(c["x"]), jnp.asarray(c["w"]))
    gx, gw = vjp(jnp.asarray(c["g"]))
    _close_gx(c["port"]["gx"], np.asarray(gx))
    gw = np.asarray(gw)
    np.testing.assert_allclose(c["port"]["gw"], gw, rtol=0, atol=1e-4 * np.abs(gw).max())
    np.testing.assert_allclose(c["port"]["gb"], c["g"].sum((0, 1, 2, 3)), rtol=1e-5)
    assert c["port"]["gw"].dtype == np.float32


def test_k3_bwd_matches_pallas_fused_bwd(k3_case):
    c = k3_case
    xf = fold_x(jnp.asarray(c["x"]).astype(jnp.bfloat16))
    w = jnp.asarray(c["w"]).astype(jnp.bfloat16)
    ct = fold_x(jnp.asarray(c["g"]).astype(jnp.bfloat16))
    assert pallas_conv._supported(xf, w)
    with pltpu.force_tpu_interpret_mode():
        gxf, gw = pallas_conv._fused_bwd((xf, w), ct)
    gx = np.asarray(unfold_x(gxf), np.float32)
    _close_gx(c["port"]["gx"], gx)
    gw = np.asarray(gw, np.float32)
    np.testing.assert_allclose(c["port"]["gw"], gw, rtol=0, atol=1e-2 * np.abs(gw).max())


def test_k3_bwd_matches_torch_autograd_of_reference(k3_case):
    c = k3_case
    xt = torch.from_numpy(c["x"]).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(c["w"].transpose(4, 3, 0, 1, 2))).requires_grad_()
    bt = torch.from_numpy(c["b"]).requires_grad_()
    out = conv_k3.conv3d_k3_reference(xt, wt, bt)
    assert torch.equal(out, c["out"])
    out.backward(torch.from_numpy(c["g"]).to(torch.bfloat16))
    _close_gx(c["port"]["gx"], xt.grad.float().numpy())
    # autograd through the reference's bf16 cast of the weights rounds their
    # gradient to bf16: one bf16 ulp
    gw = wt.grad.numpy().transpose(2, 3, 4, 1, 0)
    np.testing.assert_allclose(c["port"]["gw"], gw, rtol=BF16_ULP,
                               atol=1e-4 * np.abs(gw).max())
    np.testing.assert_allclose(c["port"]["gb"], bt.grad.numpy(), rtol=1e-6)


def test_k3_bwd_counts_no_kernel_on_cpu(k3_case):
    from rtpose_tpu_torch import ops
    ops.reset_launch_counts()
    x = torch.from_numpy(k3_case["x"]).to(torch.bfloat16).requires_grad_()
    w = torch.zeros((32, 32, 3, 3, 3), requires_grad=True)
    conv_k3.Conv3dK3.apply(x, w, None).sum().backward()
    assert ops.launch_counts() == {"preprocess": 0, "preprocess_single": 0, "conv3d_k3": 0,
                                   "conv3d_k3_bwd": 0, "conv3d_k3_int8": 0,
                                   "deform_conv2d": 0, "group_norm": 0,
                                   "resize_trilinear": 0}
    assert w.grad.dtype == torch.float32 and x.grad.dtype == torch.bfloat16


def test_layer_routes_bf16_grad_mode_through_function():
    from rtpose_tpu_torch.models.layers import TorchConv3d
    m = TorchConv3d(32, 32, bias=False, dtype="bfloat16")
    torch.nn.init.normal_(m.weight, std=0.05)
    x = torch.randn(1, 2, 3, 4, 32)
    out = m(x)
    assert out.grad_fn is not None and "Conv3dK3" in type(out.grad_fn).__name__
    out.float().sum().backward()
    assert m.weight.grad is not None and m.weight.grad.dtype == torch.float32
    with torch.no_grad():
        assert torch.equal(m(x), out.detach())


# ------------------------------------------------------- targets and gaussian

def _poses(rng, B, M, grid, spec):
    """World poses around the grid, some pelvises outside it."""
    nz, ny, nx = grid
    sx, sy, sz = spec.voxel_size_xyz
    lo = np.array(spec.pc_range_min_xyz)
    ext = np.array([nx * sx, ny * sy, nz * sz])
    pelvis = lo + rng.uniform(-0.3, 1.3, size=(B, M, 1, 3)) * ext
    return (pelvis + rng.normal(scale=0.3, size=(B, M, 15, 3))).astype(np.float32)


@pytest.mark.parametrize("mode,max_poses", [("one_hm", 1), ("one_hm", 3), ("per_joint", 1),
                                            ("per_joint", 2)])
def test_targets_match_jax(mode, max_poses):
    grid = (8, 16, 32)
    kw = dict(grid_zyx=grid, pc_range_min_xyz=(0.77, -1.25, -1.09),
              voxel_size_xyz=(0.0453125, 0.15703125, 0.3625), max_poses=max_poses,
              min_radius=2, mode=mode, num_classes=1 if mode == "one_hm" else 15)
    spec, jspec = PoseTargetSpec(**kw), JaxSpec(**kw)
    rng = np.random.default_rng(1)
    B = 6
    poses = _poses(rng, B, max_poses, grid, spec)
    num = np.array([max_poses, 0, 1, max_poses, max_poses, 1], np.int32)
    want = jax.jit(jax.vmap(lambda p, n: jax_assign(p, n, jspec)))(jnp.asarray(poses),
                                                                   jnp.asarray(num))
    got = assign_pose_targets(torch.from_numpy(poses), torch.from_numpy(num), spec)
    assert got["mask"].dtype == torch.uint8
    assert got["ind"].dtype == got["cat"].dtype == torch.int64
    assert got["hm"].shape == (B, spec.num_classes, *grid)
    for k in ("hm", "anno_pose", "ind", "mask", "cat"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    ok = got["mask"].bool()
    assert not ok[1].any()                              # num_poses = 0
    assert (got["ind"][~ok] == 0).all() and (got["anno_pose"][~ok] == 0).all()
    assert 0 < int(ok.sum()) < ok.numel()               # some poses dropped


@pytest.mark.parametrize("size,overlap", [((3.0, 5.0), 0.5), ((10.0, 2.0), 0.1),
                                          ((1.0, 1.0), 0.7)])
def test_gaussian_radius_matches_jax(size, overlap):
    from rtpose_tpu.core.gaussian import gaussian_radius as jax_radius
    assert gaussian_radius(size, overlap) == pytest.approx(jax_radius(size, overlap), rel=1e-12)


# --------------------------------------------------------------------- losses

@pytest.fixture(scope="module")
def loss_case():
    rng = np.random.default_rng(2)
    B, M, grid, C, D = 3, 2, (4, 6, 8), 2, 5
    N = int(np.prod(grid))
    logits = rng.normal(scale=3.0, size=(B, *grid, C)).astype(np.float32)
    target = rng.uniform(0, 1, size=(B, *grid, C)).astype(np.float32) ** 4
    ind = rng.integers(0, N, size=(B, M))
    mask = (rng.uniform(size=(B, M)) < 0.7).astype(np.uint8)
    mask[0, 0] = 1
    cat = rng.integers(0, C, size=(B, M))
    reg = rng.normal(size=(B, *grid, D)).astype(np.float32)
    anno = rng.normal(size=(B, M, D)).astype(np.float32)
    return dict(logits=logits, target=target, ind=ind, mask=mask, cat=cat, reg=reg, anno=anno)


@pytest.mark.parametrize("form", ["logits", "clamped", "reg"])
@pytest.mark.parametrize("positives", [True, False])
def test_losses_match_jax(loss_case, form, positives):
    c = dict(loss_case)
    if not positives:
        c["mask"] = np.zeros_like(c["mask"])
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in c.items()}
    j = {k: jnp.asarray(v) for k, v in c.items()}
    if form == "logits":
        got = pl.fast_focal_loss_logits(t["logits"], t["target"], t["ind"], t["mask"], t["cat"])
        want = jl.fast_focal_loss_logits(j["logits"], j["target"], j["ind"], j["mask"], j["cat"])
    elif form == "clamped":
        got = pl.fast_focal_loss(pl.clamped_sigmoid(t["logits"]), t["target"], t["ind"],
                                 t["mask"], t["cat"])
        want = jl.fast_focal_loss(jl.clamped_sigmoid(j["logits"]), j["target"], j["ind"],
                                  j["mask"], j["cat"])
    else:
        got = pl.reg_loss(t["reg"], t["mask"], t["ind"], t["anno"])
        want = jl.reg_loss(j["reg"], j["mask"], j["ind"], j["anno"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ optimizer

def test_one_cycle_values_past_total():
    total = 50
    steps = np.arange(0, total + 25)
    lr, mom = one_cycle_values(torch.from_numpy(steps), total, 2e-3)
    jlr, jmom = jax.vmap(lambda s: jax_one_cycle(s, total, 2e-3))(jnp.asarray(steps))
    np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), rtol=1e-6)
    np.testing.assert_allclose(mom.numpy(), np.asarray(jmom), rtol=1e-6)
    assert lr.dtype == torch.float32
    assert float(lr[-1]) == float(lr[total])            # held past the total


def _opt_cfg(clip, fixed_wd):
    d = dict(optimizer=dict(type="adam", wd=0.01, fixed_wd=fixed_wd),
             lr_config=dict(type="one_cycle", lr_max=3e-3, moms=[0.95, 0.85],
                            div_factor=10.0, pct_start=0.4),
             optimizer_config=dict(grad_clip=dict(max_norm=35.0)) if clip else {})
    return Config(d), JaxConfig(d)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("fixed_wd", [True, False])
def test_optimizer_trajectory_matches_jax(clip, fixed_wd):
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    steps = 100
    cfg, jcfg = _opt_cfg(clip, fixed_wd)
    params = [torch.from_numpy(p0[k].copy()) for k in shapes]
    opt = build_optimizer_from_cfg(cfg, params, total_steps=steps)
    jopt = jax_build_opt(jcfg, total_steps=steps)
    assert opt.beta2 == (0.99 if fixed_wd else 0.999)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    for i in range(steps):
        # gradients whose norm crosses the clip (35) now and then
        scale = 60.0 if i % 7 == 0 else 1.0
        g = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(g[k])
        gnorm = opt.step()
        upd, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(g)), rtol=1e-5)
    for p, k in zip(params, shapes):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-5)
    mus = torch.split(opt.mu, opt.sizes)
    for m, k in zip(mus, shapes):
        np.testing.assert_allclose(m.reshape(shapes[k]).numpy(), np.asarray(js.mu[k]),
                                   rtol=1e-5, atol=1e-5)
    assert int(opt.step_count) == int(js.step) == steps


def test_optimizer_guard_and_state_dict_round_trip():
    lr_fn, mom_fn = make_one_cycle_fns(10, 1e-2)
    p = torch.ones(5)
    opt = AdamOneCycle([p], lr_fn, mom_fn)
    p.grad = torch.full((5,), 0.5)
    opt.step()
    before = (p.clone(), opt.mu.clone(), opt.nu.clone(), int(opt.step_count))
    p.grad = torch.full((5,), float("nan"))
    gn = opt.step(finite=torch.tensor(False))
    assert torch.isnan(gn)
    assert torch.equal(p, before[0]) and torch.equal(opt.mu, before[1])
    assert torch.equal(opt.nu, before[2]) and int(opt.step_count) == before[3] == 1
    sd = opt.state_dict()
    q = torch.ones(5)
    opt2 = AdamOneCycle([q], lr_fn, mom_fn)
    opt2.load_state_dict(sd)
    assert torch.equal(opt2.mu, opt.mu) and int(opt2.step_count) == 1
    with pytest.raises(ValueError):
        AdamOneCycle([torch.ones(3)], lr_fn).load_state_dict(sd)


# ---------------------------------------------------------------- loader order

class _Items:
    def __init__(self, n, flag):
        self.n = n
        if flag:
            self.flag = np.ones(n, np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32), "meta": {"i": i}}


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("n,bs", [(19, 4), (24, 8)])
def test_loader_order_matches_jax(flag, shards, n, bs):
    ds = _Items(n, flag)
    for shard in range(shards):
        a = BatchLoader(ds, bs, shuffle=True, num_shards=shards, shard_id=shard, seed=5)
        b = JaxLoader(ds, bs, shuffle=True, num_shards=shards, shard_id=shard, seed=5,
                      prefetch=0)
        for epoch in range(3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            np.testing.assert_array_equal(a._indices(), b._indices())
            assert len(a) == len(b)
            got = [bt["x"][:, 0].astype(int).tolist() for bt in a]
            want = [bt["x"][:, 0].astype(int).tolist() for bt in b]
            assert got == want and len(got) == len(a)


def test_eval_loader_pads_tail_and_stops_early():
    ds = _Items(10, True)
    batches = list(BatchLoader(ds, 4))
    assert [int(b["valid"]) for b in batches] == [4, 4, 2]
    assert batches[-1]["x"][:, 0].tolist() == [8, 9, 9, 9]
    assert [m["i"] for m in batches[0]["meta"]] == [0, 1, 2, 3]
    it = iter(BatchLoader(ds, 2, num_workers=2))
    next(it)
    it.close()                                          # the prefetch thread stops
