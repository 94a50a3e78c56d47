"""The port's deformable conv and DCN head against rtpose_tpu's, in float32
on the CPU: ``ops.deform_conv.deform_conv2d`` v1 and v2 forward and its
gradients (input, offsets, weights, mask), samples out of the map and half
out of it, chunked against unchunked; ``DCNSepHead`` (through
``CenterHead(dcn_head=True)``) with the flax weights carried by
``state_dict_from_jax``; and one ``_dcn``-shaped train step against
``make_train_step``.

Tolerances: the deform conv is the same gathers, bilinear weights and one
contraction in both frameworks; only the contraction's summation order
differs, so values and gradients agree to rtol 1e-5 (atol 1e-5 of the
largest magnitude, for elements that cancel to near zero).  The head and
the train step run convs summed in different orders (as in
``tests/test_torch_modules.py`` and ``tests/test_torch_train_step.py``):
head outputs to 1e-4 of their range, the loss terms and the gradient norm
to rtol 1e-4, each gradient leaf to 1e-3 of its largest value.
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
from rtpose_tpu.ops.deform_conv import deform_conv2d as jax_deform

from rtpose_tpu_torch.core.targets import PoseTargetSpec
from rtpose_tpu_torch.engine import make_loss_fn, state_dict_from_jax
from rtpose_tpu_torch.models import CenterHead, build_detector, init_weights
from rtpose_tpu_torch.models.dcn_head import DCNSepHead, LayerNormNHWC
from rtpose_tpu_torch.ops import deform_conv as dc


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the cores: cap torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max() + 1e-12, err_msg=err_msg)


def _inputs(seed, B=2, H=7, W=9, C=8, Cout=5, dg=2, k=3, mask=False, scale=1.5):
    """Offsets of up to ``scale`` * 2 pixels, a few planted out of the map
    (the whole sample gone) and half out (two corners outside)."""
    rng = np.random.default_rng(seed)
    K = k * k
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    off = rng.uniform(-scale, scale, size=(B, H, W, dg * K * 2)).astype(np.float32)
    off[0, 0, 0, :2] = (-5.0, 0.3)                  # center far above the map
    off[0, 0, 1, 2:4] = (-0.5, 0.25)                # top row tap half outside
    off[1, H - 1, W - 1, -2:] = (0.6, 2.7)          # bottom-right tap leaving right
    off[1, 3, 4, 4:6] = (1.0, -2.0)                 # integer offsets
    w = (rng.normal(size=(k, k, C, Cout)) / np.sqrt(K * C)).astype(np.float32)
    m = rng.uniform(0, 1, size=(B, H, W, dg * K)).astype(np.float32) if mask else None
    return x, off, w, m


def _jax_fwd_grads(x, off, w, m, cot, **kw):
    def f(x, off, w, m):
        out = jax_deform(x, off, w, mask=m, **kw)
        return jnp.sum(out * cot), out
    argnums = (0, 1, 2, 3) if m is not None else (0, 1, 2)
    (_, out), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
        None if m is None else jnp.asarray(m))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_fwd_grads(x, off, w, m, cot, **kw):
    ts = [torch.tensor(a, requires_grad=True) for a in (x, off, w)]
    tm = None if m is None else torch.tensor(m, requires_grad=True)
    out = dc.deform_conv2d(*ts, mask=tm, **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = [t.grad.numpy() for t in ts] + ([] if tm is None else [tm.grad.numpy()])
    return out.detach().numpy(), grads


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("geom", [dict(), dict(stride=2, padding=1, dilation=2)])
def test_deform_conv_matches_jax(version, geom):
    x, off, w, m = _inputs(0, mask=version == "v2")
    H, W = x.shape[1:3]
    s, p, d = geom.get("stride", 1), geom.get("padding", 1), geom.get("dilation", 1)
    Ho, Wo = (H + 2 * p - d * 2 - 1) // s + 1, (W + 2 * p - d * 2 - 1) // s + 1
    off, m = off[:, :Ho, :Wo], None if m is None else m[:, :Ho, :Wo]
    kw = dict(deformable_groups=2, **geom)
    cot = np.random.default_rng(9).normal(size=(x.shape[0], Ho, Wo, w.shape[-1])
                                          ).astype(np.float32)
    jout, jgrads = _jax_fwd_grads(x, off, w, m, cot, **kw)
    pout, pgrads = _port_fwd_grads(x, off, w, m, cot, **kw)
    _close(pout, jout, err_msg="forward")
    for name, g, jg in zip(("x", "offset", "weight", "mask"), pgrads, jgrads):
        _close(g, jg, err_msg=f"grad {name}")


def test_out_of_map_samples_contribute_zero():
    """A tap moved entirely off the map adds nothing; a tap half outside
    adds only its inside corners (the bilinear weights of the others)."""
    x = np.arange(1, 1 + 4 * 4, dtype=np.float32).reshape(1, 4, 4, 1)
    w = np.ones((1, 1, 1, 1), np.float32)
    off = np.zeros((1, 4, 4, 2), np.float32)
    off[0, 0, 0] = (-1.0, 0.0)        # y = -1: the center has left the map
    off[0, 0, 1] = (-0.5, 0.0)        # y = -0.5: the y = 0 corner only, weight 0.5
    off[0, 3, 3] = (0.0, 1.25)        # x = 4.25 >= W: gone
    out = dc.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(w),
                           padding=0).numpy()
    want = np.asarray(jax_deform(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w), padding=0))
    np.testing.assert_array_equal(out, want)
    assert out[0, 0, 0, 0] == 0.0 and out[0, 3, 3, 0] == 0.0
    assert out[0, 0, 1, 0] == pytest.approx(0.5 * x[0, 0, 1, 0])


def test_chunks_change_nothing(monkeypatch):
    """Chunked over the images (with autograd recomputing each chunk) equals
    one chunk, forward and gradients."""
    x, off, w, m = _inputs(3, B=5, mask=True)
    cot = np.random.default_rng(4).normal(size=(5, 7, 9, 5)).astype(np.float32)
    one = _port_fwd_grads(x, off, w, m, cot, deformable_groups=2)
    monkeypatch.setattr(dc, "CHUNK_ELEMS", 2 * 7 * 9 * 9 * 8)       # two images a chunk
    many = _port_fwd_grads(x, off, w, m, cot, deformable_groups=2)
    np.testing.assert_array_equal(many[0], one[0])
    for g1, g2 in zip(many[1], one[1]):
        np.testing.assert_allclose(g1, g2, rtol=1e-6, atol=1e-6 * np.abs(g2).max())


def test_layer_norm_is_flax_layer_norm():
    import flax.linen as fnn
    x = np.random.default_rng(5).normal(2.0, 0.3, size=(3, 4, 5, 16)).astype(np.float32)
    ln = fnn.LayerNorm()
    params = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1 * np.arange(a.size).reshape(a.shape), params)
    want = np.asarray(ln.apply(params, jnp.asarray(x)))
    mod = LayerNormNHWC(16)
    with torch.no_grad():
        mod.weight.copy_(torch.tensor(np.array(params["params"]["scale"])))
        mod.bias.copy_(torch.tensor(np.array(params["params"]["bias"])))
    assert mod.eps == 1e-6
    _close(mod(torch.from_numpy(x)).detach().numpy(), want)


HEAD_CFG = dict(tasks=[dict(num_class=1, class_names=["Pelvis"])], in_channels=32,
                share_conv_channel=32, common_heads={"reg": (45, 2)}, weight=0.5,
                code_weights=[1.0] * 45, dcn_head=True)


def _perturb_offsets(params, seed, scale):
    """The offset convs start at zero (a plain conv); give them weights so
    the samples move."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.array, params)

    def walk(node):
        for k, v in node.items():
            if k == "conv_offset":
                v["kernel"] = (scale * rng.normal(size=v["kernel"].shape)).astype(np.float32)
                v["bias"] = (scale * rng.normal(size=v["bias"].shape)).astype(np.float32)
            elif isinstance(v, dict):
                walk(v)
    walk(params["params"])
    return params


def test_dcn_head_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 3, 8, 12, 32)).astype(np.float32)
    jhead = JaxHead(**HEAD_CFG)
    params = _perturb_offsets(jhead.init(jax.random.PRNGKey(1), jnp.asarray(x)), 7, 0.3)
    want = jhead.apply(params, jnp.asarray(x))[0]
    head = CenterHead(**HEAD_CFG)
    sd = state_dict_from_jax(params)
    assert sorted(sd) == sorted(head.state_dict())
    assert "tasks.0.cls_norm.weight" in sd and sd["tasks.0.cls_conv0.weight"].shape == (32, 32, 3, 3)
    head.load_state_dict(sd)
    assert isinstance(head.tasks[0], DCNSepHead)
    with torch.no_grad():
        got = head(torch.from_numpy(x))[0]
    assert sorted(got) == sorted(want) == ["hm", "reg"]
    for k in ("hm", "reg"):
        w = np.asarray(want[k])
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * (w.max() - w.min()), err_msg=k)


def test_init_weights_dcn_head():
    """Seeded init: offset convs at zero (a plain conv at the start), the
    heatmap bias at init_bias, unit LayerNorm scale."""
    head = CenterHead(**HEAD_CFG)
    init_weights(head, torch.Generator().manual_seed(0))
    t = head.tasks[0]
    assert not t.feature_adapt_cls.conv_offset.weight.any()
    assert torch.all(t.cls_out.bias == -2.19)
    assert torch.all(t.cls_norm.weight == 1.0)
    assert t.feature_adapt_reg.conv_adaption.weight.std() > 0


GRID = (4, 8, 16)
LR = 1e-3
MODEL_CFG = dict(
    type="RadarPoseNet",
    reader=dict(type="RadarFeatureNet"),
    backbone=dict(type="HRNet3D", backbone_cfg="hr_tiny_feat16_zyx_l4",
                  final_conv_in=176, final_conv_out=64, final_fuse="conat_conv",
                  ds_factor=1),
    pose_head=dict(type="CenterHead", tasks=[dict(num_class=1, class_names=["Pelvis"])],
                   in_channels=64, share_conv_channel=64, common_heads={"reg": (45, 2)},
                   weight=0.5, code_weights=[1.0] * 45, dcn_head=True),
    neck=None,
)
SPEC_KW = dict(grid_zyx=GRID, pc_range_min_xyz=(0.0, -4.0, -1.0),
               voxel_size_xyz=(0.5, 1.0, 0.5), max_poses=1, min_radius=2,
               mode="one_hm", num_classes=1)


def _grad_keeper():
    """An optax transformation whose state after an update is the gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def test_dcn_train_step_matches_jax():
    """The dense train step of a ``_dcn``-shaped model (deformable head,
    no sparse path): loss terms, gradient norm and every gradient leaf."""
    rng = np.random.default_rng(8)
    Z, Y, X = GRID
    B = 2
    poses = (rng.uniform(0.2, 0.8, size=(B, 1, 15, 3)) * np.array([X, Y, Z])
             * np.array([0.5, 1.0, 0.5]) + np.array([0.0, -4.0, -1.0]))
    batch = {"rdr_tensor": rng.normal(size=(B, Z, Y, X, 1)).astype(np.float32),
             "poses": poses.astype(np.float32), "num_poses": np.ones((B,), np.int32)}
    jmodel = jax_build(MODEL_CFG)
    jhead = JaxHead(**{k: v for k, v in MODEL_CFG["pose_head"].items() if k != "type"})
    params = _perturb_offsets(jmodel.init(jax.random.PRNGKey(0),
                                          jnp.asarray(batch["rdr_tensor"])), 9, 0.05)
    state = jax_create_state(jmodel, _grad_keeper(), jnp.asarray(batch["rdr_tensor"]))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          opt_state=jax.tree.map(jnp.zeros_like, params))
    step = jax.jit(jax_make_train_step(jmodel, jhead, JaxSpec(**SPEC_KW), _grad_keeper(),
                                       lr_fn=lambda s: jnp.float32(LR)))
    new_state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = state_dict_from_jax(jax.device_get(new_state.opt_state))

    model = build_detector(MODEL_CFG)
    model.load_state_dict(state_dict_from_jax(params))
    loss_fn = make_loss_fn(model, model.pose_head, PoseTargetSpec(**SPEC_KW))
    loss, losses = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                           torch.zeros((), dtype=torch.int64))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    for got, key in ((loss.detach(), "loss"), (losses["hm_loss"][0].detach(), "hm_loss"),
                     (losses["loc_loss"][0].detach(), "loc_loss"), (gnorm, "grad_norm")):
        np.testing.assert_allclose(float(got), float(jm[key]), rtol=1e-4, err_msg=key)
    assert sorted(grads) == sorted(jgrads)
    assert float(grads["pose_head.tasks.0.feature_adapt_cls.conv_offset.weight"].abs().max()) > 0
    for k, g in grads.items():
        w = jgrads[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def test_dcn_export_equals_live(tmp_path):
    """A ``_dcn``-shaped serving artifact (dense forward, the deformable
    head, single-peak decode) equals the live model bit for bit."""
    from rtpose_tpu_torch import export as pexp
    from rtpose_tpu_torch.api import Assembly
    from rtpose_tpu_torch.core.decode import DecodeSpec

    model = init_weights(build_detector(MODEL_CFG), torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "conv_offset"):
                m.conv_offset.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
    spec = PoseTargetSpec(**SPEC_KW)
    asm = Assembly(model=model, one_hm=True, model_cfg=MODEL_CFG, target_spec=spec,
                   decode_spec=DecodeSpec(grid_zyx=GRID, pc_range_min_xyz=(0.0, -4.0, -1.0),
                                          voxel_size_xyz=(0.5, 1.0, 0.5)),
                   input_shape_zyxc=(*GRID, 1))
    assert not asm.sparse_head and asm.multi_poses == 0
    x = torch.randn(2, *GRID, 1, generator=torch.Generator().manual_seed(3))
    live = pexp.make_predict_fn(asm)(x)
    path = str(tmp_path / "dcn.pt2")
    pexp.save_exported(path, pexp.export_predict(asm, batch_size=2, device="cpu"))
    got = pexp.load_predict(path)(x)
    assert len(got) == len(live) == 1 and len(got[0]) == 3
    for u, v in zip(got[0], live[0]):
        assert u.dtype == v.dtype and torch.equal(u, v)
