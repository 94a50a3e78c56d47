"""The port's int8 PTQ (``rtpose_tpu_torch/ops/quant.py``, the int8 resize,
the quant sites) against ``rtpose_tpu/ops/quant.py`` on the same inputs.

Inputs come from numpy seeds; JAX runs on the CPU.  Tolerances:

* activation and weight quantization: bit-equal (the same float32 products
  and divisions, rounded half to even, clipped);
* int8 convs: the int32 accumulators equal (both exact), the dequantized
  outputs within one ulp of the output dtype of the JAX naive and folded
  forms (the same float32 epilogue; XLA may contract it into one FMA);
* ``conv3d_int8_concat_1x1``, the int8 resize (X, then Z, then Y) and the
  calibration statistics: 1e-6 relative (float32 epilogues and
  statistics of the same values, in other orders);
* calibration scales of the whole tiny model in float32: 1e-4 relative
  (the two frameworks' float32 forwards differ by ~1e-5 relative after
  ~20 layers; seen 1.2e-5).

The slice as a whole runs in float64 on both sides (JAX with x64): in
float32 the two frameworks' float ops (GroupNorm sums, the resize's
interpolation weights, float32 in the JAX package and float64 in
``F.interpolate``) differ in the last bits, each difference flips the
rounding of a few activations at 52 int8 sites, and the flips compound:
on random weights the int8 heatmaps then differ by ~1.5 logits and peaks
move (seen: 13-37 % of frames).  In float64, with the port's resize given
the JAX package's interpolation matrices, the int8 programs are the same
integers: peaks identical, keypoints within the effect of one activation
quantum (``_one_quantum_tolerance``; seen ~3e-5 voxels).  Dense heads (the
JAX sparse path does not run under x64); the port's sparse int8 path is
held to its dense one at the peak.  The scales are the JAX package's
float32 calibration, which the port's float64 calibration matches to
1e-4 relative.
"""

import copy
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rtpose_tpu.api import assemble as jax_assemble
from rtpose_tpu.config import Config as JaxConfig
from rtpose_tpu.core.decode import decode_pose_preds as jax_decode
from rtpose_tpu.engine.torch_import import import_torch_state_dict
from rtpose_tpu.export import calibrate_predict as jax_calibrate_predict
from rtpose_tpu.models.hrnet3d import MODEL_CONFIGS
from rtpose_tpu.ops import quant as jq
from rtpose_tpu.ops.fold_conv import fold_x, unfold_x
from rtpose_tpu.ops.interpolate import resize_trilinear_folded_int8

import rtpose_tpu_torch.models.hrnet3d as port_hrnet
from rtpose_tpu_torch.api import assemble as port_assemble
from rtpose_tpu_torch.config import Config as PortConfig
from rtpose_tpu_torch.core.decode import decode_pose_preds as port_decode
from rtpose_tpu_torch.engine import bind_sites, site_paths, state_dict_from_jax
from rtpose_tpu_torch.models import init_weights
from rtpose_tpu_torch.export import calibrate_predict
from rtpose_tpu_torch.ops import conv_k3_int8, quant
from rtpose_tpu_torch.ops.interpolate import _interp_matrix_np, resize_trilinear_int8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}    # grid (8, 16, 32): X folds in JAX
ROI_X24 = dict(TINY_ROI, x=[0.7703125, 1.8578125])   # grid (8, 16, 24): no fold
SCALE_RTOL = 1e-4
STAT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs six workers at once: torch's default of one thread
    per core in each of them oversubscribes the machine, and this file's
    CPU convs then ran some 30x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _torch_w(w):
    """(kz, ky, kx, C, Co) flax kernel -> torch (Co, C, kz, ky, kx)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2))))


def _assert_within_ulp(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":   # 8 bits of mantissa
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    else:
        ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


# ---------------------------------------------------------------- quantizers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.05, 1.0 / 127.0, 0.3])
def test_quantize_act_bit_equal_with_ties(dtype, scale):
    x = _rand((3, 4, 5, 6, 8), 0, 4.0)
    # exact .5 ties of x * (1 / scale) (half to even: 2.5 -> 2, -3.5 -> -4)
    inv = np.float32(1.0 / scale)
    ties = (np.arange(-20, 20, dtype=np.float32) + 0.5) / inv
    ties = ties[(ties * inv) % 1 == 0.5]
    x.reshape(-1)[:ties.size] = ties
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jq._quantize_act(xj, scale))
    got = quant._quantize_act(torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
                              .to(getattr(torch, dtype)), scale)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(3, 3, 3, 16, 24), (1, 1, 1, 192, 128), (3, 3, 3, 32, 32)])
def test_quantize_weight_bit_equal(shape):
    w = _rand(shape, 1, 0.2)
    w[..., 0] = 0.0                       # a dead output channel: scale 1
    wq_j, sw_j = jq._quantize_weight(jnp.asarray(w))
    wq, sw = quant._quantize_weight(_torch_w(w))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_j))
    np.testing.assert_array_equal(wq.numpy(), np.transpose(np.asarray(wq_j), (4, 3, 0, 1, 2)))
    assert float(sw[0]) == 1.0


# ---------------------------------------------------------------- int8 convs

CONVS = [(3, 1, 16, 24), (3, 2, 16, 32), (1, 1, 16, 8), (1, 2, 16, 16), (3, 1, 32, 32)]


def test_int8_accumulator_equal_over_channel_chunks():
    """64 input channels at k3: the CPU route's float32 sums run in two
    chunks of input channels (one could reach 2^24); the int32 total
    equals JAX's, at the extremes of the int8 range too."""
    rng = np.random.default_rng(40)
    x = rng.integers(100, 128, size=(1, 3, 4, 5, 64)).astype(np.float32)
    w = rng.uniform(0.2, 0.3, size=(3, 3, 3, 64, 8)).astype(np.float32)
    w[..., 1] *= -1.0
    scale = 1.0
    xq_j = jq._quantize_act(jnp.asarray(x), scale)
    wq_j, _ = jq._quantize_weight(jnp.asarray(w))
    acc_j = jax.lax.conv_general_dilated(
        xq_j, wq_j, (1, 1, 1), [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), preferred_element_type=jnp.int32)
    acc = quant.int8_conv_acc(quant._quantize_act(torch.from_numpy(x), scale),
                              quant._quantize_weight(_torch_w(w))[0], 1)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    assert int(np.abs(np.asarray(acc_j)).max()) > 2 ** 24     # beyond one float32 sum


@pytest.mark.parametrize("kernel,stride,C,Co", CONVS)
def test_int8_accumulator_equal(kernel, stride, C, Co):
    x = _rand((2, 4, 6, 8, C), 2)
    w = _rand((kernel, kernel, kernel, C, Co), 3, 0.3)
    scale = float(np.abs(x).max()) / 127.0
    xq_j = jq._quantize_act(jnp.asarray(x), scale)
    wq_j, _ = jq._quantize_weight(jnp.asarray(w))
    p = kernel // 2
    acc_j = jax.lax.conv_general_dilated(
        xq_j, wq_j, (stride,) * 3, [(p, p)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), preferred_element_type=jnp.int32)
    xq = quant._quantize_act(torch.from_numpy(x), scale)
    wq, _ = quant._quantize_weight(_torch_w(w))
    acc = quant.int8_conv_acc(xq, wq, stride)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))


@pytest.mark.parametrize("form", ["naive", "folded"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,C,Co", CONVS)
def test_conv3d_int8_matches_jax(kernel, stride, C, Co, out_dtype, form):
    x = _rand((2, 4, 6, 16, C), 4)
    w = _rand((kernel, kernel, kernel, C, Co), 5, 0.3)
    b = _rand((Co,), 6)
    scale = float(np.abs(x).max()) / 127.0
    xj = jnp.asarray(x).astype(out_dtype)
    if form == "naive":
        want = jq.conv3d_int8(xj, jnp.asarray(w), jnp.asarray(b), stride, scale,
                              folded=False, out_dtype=out_dtype)
    else:
        want = unfold_x(jq.conv3d_int8(fold_x(xj), jnp.asarray(w), jnp.asarray(b), stride,
                                       scale, folded=True, out_dtype=out_dtype))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, out_dtype))
    got = quant.conv3d_int8(xt, _torch_w(w), torch.from_numpy(b), stride, scale)
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    _assert_within_ulp(got.float().numpy(), np.asarray(want.astype(jnp.float32)), out_dtype)


def test_concat_1x1_matches_jax_folded():
    blocks = (16, 8, 8)
    xs = [_rand((2, 4, 6, 16, c), 10 + i) for i, c in enumerate(blocks)]
    w = _rand((1, 1, 1, sum(blocks), 24), 13, 0.3)
    b = _rand((24,), 14)
    x_cat = np.concatenate(xs, axis=-1)
    scale = float(np.abs(x_cat).max()) / 127.0
    xf = jnp.concatenate([fold_x(jnp.asarray(x)) for x in xs], axis=-1)
    want = unfold_x(jq.conv3d_int8_concat_1x1(xf, jnp.asarray(w), jnp.asarray(b), blocks,
                                              scale, jnp.float32))
    got = quant.conv3d_int8_concat_1x1(torch.from_numpy(x_cat), _torch_w(w),
                                       torch.from_numpy(b), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STAT_RTOL, atol=0)


def test_k3_shape_plain_kernel_version_equals_generic_route():
    """On the CPU the K3 shape's plain kernel version is what runs: the same
    integers and epilogue as the generic route, bit for bit."""
    x = _rand((2, 3, 5, 7, 32), 15)
    w = _rand((3, 3, 3, 32, 32), 16, 0.2)
    b = torch.from_numpy(_rand((32,), 17))
    scale = float(np.abs(x).max()) / 127.0
    xq = quant._quantize_act(torch.from_numpy(x), scale)
    wq, sw = quant._quantize_weight(_torch_w(w))
    plain = conv_k3_int8.conv3d_k3_int8(xq, wq, sw * scale, b)
    generic = quant.epilogue(quant.int8_conv_acc(xq, wq, 1), sw * scale, b, torch.bfloat16)
    assert plain.dtype == torch.bfloat16
    assert torch.equal(plain, generic)


# ---------------------------------------------------------------- int8 resize

@pytest.mark.parametrize("src,tgt", [((2, 4, 8), (4, 8, 32)), ((4, 8, 16), (4, 16, 32)),
                                     ((1, 2, 4), (8, 16, 32))])
def test_int8_resize_matches_jax(src, tgt):
    C = 8
    x = _rand((2, *src, C), 18, 2.0)
    scale = float(np.abs(x).max()) / 127.0
    want = unfold_x(resize_trilinear_folded_int8(fold_x(jnp.asarray(x)), tgt, scale))
    got = resize_trilinear_int8(torch.from_numpy(x), tgt, scale)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STAT_RTOL, atol=0)


def test_int8_resize_order_is_x_then_z_then_y():
    """Re-quantizing between passes makes the order observable: X -> Z -> Y
    matches, the float order Z -> Y -> X does not."""
    x = _rand((1, 2, 4, 8, 4), 19, 3.0)
    tgt = (8, 16, 32)
    scale = float(np.abs(x).max()) / 127.0
    got = resize_trilinear_int8(torch.from_numpy(x), tgt, scale).numpy()
    want = np.asarray(unfold_x(resize_trilinear_folded_int8(fold_x(jnp.asarray(x)), tgt,
                                                            scale)))
    np.testing.assert_allclose(got, want, rtol=STAT_RTOL, atol=0)
    zyx = resize_trilinear_int8(
        resize_trilinear_int8(torch.from_numpy(x), (8, 16, 8), scale), tgt, scale).numpy()
    assert np.abs(zyx - want).max() > 10 * STAT_RTOL * np.abs(want).max()


# ---------------------------------------------------------------- calibration

@pytest.mark.parametrize("quantile", [None, 0.5, 0.999])
@pytest.mark.parametrize("shape", [(2, 8, 16, 32, 16), (2, 16, 64, 160, 4)])
def test_calibration_statistics_match_jax(shape, quantile):
    """absmax and the quantile of |x| (over the strided subsample above
    200k elements) recorded by ``consult``, max-accumulated over two
    applications of one site."""
    x1, x2 = _rand(shape, 20), _rand(shape, 21, 1.5)
    with jq.calibrate((), quantile=quantile) as qj:
        for x in (x1, x2):
            jq.consult("a/conv", jnp.asarray(x))
    with quant.calibrate((), quantile=quantile) as qp:
        for x in (x1, x2):
            quant.consult("a/conv", torch.from_numpy(x))
    want, got = float(qj.traced["a/conv"]), float(qp.traced["a/conv"])
    assert got == pytest.approx(want, rel=STAT_RTOL)


def test_scales_from_calib_and_exclusion():
    assert quant.scales_from_calib([{"a": 127.0, "b": 0.0}, {"a": 254.0}]) == \
        jq.scales_from_calib([{"a": 127.0, "b": 0.0}, {"a": 254.0}]) == {"a": 2.0, "b": 1.0}
    q = quant.QuantState("int8", exclude=quant.DEFAULT_EXCLUDE)
    assert q.excluded("head_m/task0/hm_out") and q.excluded("backbone_m/final_fuse1_resize")
    assert not q.excluded("head_m/task0_out/hm_conv0")      # suffix of the leaf only
    assert quant.DEFAULT_EXCLUDE == jq.DEFAULT_EXCLUDE
    assert quant.INT8_RESIZE_EXCLUDE == jq.INT8_RESIZE_EXCLUDE


# ---------------------------------------------------------------- whole model

def _config_text(roi):
    src = open(os.path.join(REPO, "tests", "test_e2e_cli.py")).read()
    tpl = re.search(r"CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1)
    return tpl.format(root="/nonexistent", roi=roi)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The tiny config at X = 32 (folded in JAX) and X = 24 (not folded):
    the port's model with seeded weights, and the same weights as JAX params
    (``import_torch_state_dict`` onto the init's shapes: cheaper than a
    traced init; no parameter depends on the grid)."""
    out, params, state = {}, None, None
    for name, roi in (("x32", TINY_ROI), ("x24", ROI_X24)):
        path = str(tmp_path_factory.mktemp(f"quant_{name}") / "tiny.py")
        with open(path, "w") as f:
            f.write(_config_text(roi))
        cfg = JaxConfig.fromfile(path)
        ja = jax_assemble(cfg)
        pa = port_assemble(PortConfig.fromfile(path))
        if params is None:
            state = init_weights(pa.model, torch.Generator().manual_seed(3)).state_dict()
            shapes = jax.eval_shape(ja.model.init, jax.random.PRNGKey(3), ja.example_input())
            params, report = import_torch_state_dict(
                {k: v.numpy() for k, v in state.items()}, shapes,
                MODEL_CONFIGS[cfg.model["backbone"]["backbone_cfg"]])
            assert not report["missing"] and not report["unexpected"], report
            params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
        # the JAX params carried to the port (the round trip is exact)
        pa.model.load_state_dict(state_dict_from_jax(params))
        pa.model.eval()
        xs = _batches(pa.input_shape_zyxc)
        # the JAX package's calibration of its sparse predict path, with
        # ``--int8_resize``'s exclusion so the resize sites show
        scales = jax_calibrate_predict(ja, params, [jnp.asarray(x) for x in xs],
                                       exclude=jq.INT8_RESIZE_EXCLUDE)
        out[name] = (ja, params, pa, xs, scales)
    return out


def _batches(shape_zyxc, n=2, batch=1, seed=30):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.normal(size=(batch, *shape_zyxc))).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("grid", ["x32", "x24"])
def test_site_sets_and_scales_match_jax(models, grid):
    """Both packages calibrate their sparse predict path on the same batches:
    the same sites key for key, every one named by ``site_paths``, and the
    default exclusion's set is that less the resizes.  At X = 24 the JAX
    package does not fold, and ``final_conv`` and the resizes are no sites."""
    ja, params, pa, xs, want = models[grid]
    got = calibrate_predict(pa, [torch.from_numpy(x) for x in xs],
                            exclude=quant.INT8_RESIZE_EXCLUDE)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=SCALE_RTOL), k
    paths = site_paths(pa.model)
    convs = set(paths.values()) - {"backbone_m"}
    resizes = {k for k in got if k.endswith("_resize")}
    assert set(got) - resizes == {p for p in convs if not p.endswith("_out")} - (
        set() if grid == "x32" else {"backbone_m/final_conv"})
    if grid == "x32":
        assert resizes == {f"backbone_m/final_fuse{i}_resize" for i in (1, 2, 3)}
        assert len(got) - len(resizes) == 52
    else:
        assert not resizes and "backbone_m/final_conv" not in got
    default = calibrate_predict(pa, [torch.from_numpy(x) for x in xs])
    assert sorted(default) == sorted(set(got) - resizes)


def _jax_resize_weights(x, size, addend=None, out=None):
    """The port's float resize with the JAX package's float32 interpolation
    matrices (``resize_trilinear_folded``'s X, then Z, then Y order), with
    the resize's own ``addend`` and ``out`` epilogues."""
    if addend is not None or out is not None:
        y = _jax_resize_weights(x, size)
        y = y if addend is None else addend + y
        return y if out is None else out.copy_(y)
    out = x
    _, Z, Y, X, _ = x.shape
    tz, ty, tx = size
    m = lambda a, b: torch.from_numpy(_interp_matrix_np(a, b)).to(x.dtype)   # noqa: E731
    if X != tx:
        out = torch.einsum("ox,bzyxc->bzyoc", m(X, tx), out)
    if Z != tz:
        out = torch.einsum("oz,bzyxc->boyxc", m(Z, tz), out)
    if Y != ty:
        out = torch.einsum("oy,bzyxc->bzoxc", m(Y, ty), out)
    return out


def _one_quantum_tolerance(pa, scales):
    """Keypoint tolerance (voxels): the largest change of the regression
    output that one activation quantum at the input of the reg tower's last
    int8 site (``reg_conv0``) can make, through that conv and ``reg_out``
    (the l-inf operator norms of both)."""
    sep = pa.model.pose_head.tasks[0]
    conv0, out = sep.reg[0], sep.reg[-1]
    n0 = conv0.weight.detach().double().abs().sum((1, 2, 3, 4)).max()
    n1 = out.weight.detach().double().abs().sum((1, 2, 3, 4)).max()
    return float(scales["head_m/task0/reg_conv0"] * n0 * n1)


def test_int8_slice_matches_jax_float64(models, monkeypatch):
    """JAX params carried to the port; the scales are the JAX package's
    calibration (default exclusion), and the port's own float64
    calibration on the same batches agrees with them; both run the int8
    forward in float64 on a third batch."""
    ja, params, pa, xs, calib = models["x32"]
    js = {k: v for k, v in calib.items() if not k.endswith("_resize")}
    monkeypatch.setattr(port_hrnet, "resize_trilinear_align_corners", _jax_resize_weights)
    model = copy.deepcopy(pa.model).double()
    bind_sites(model)
    ps = quant.calibration_scales(lambda b: model.predict_sparse(b),
                                  [torch.from_numpy(x.astype(np.float64)) for x in xs])
    assert sorted(ps) == sorted(js)
    for k in js:
        assert ps[k] == pytest.approx(js[k], rel=SCALE_RTOL), k
    x0 = _batches(pa.input_shape_zyxc, n=1, batch=1, seed=31)[0].astype(np.float64)
    with jax.enable_x64(True):
        def int8_fwd(p, x):
            with jq.int8_mode(js):
                return ja.model.apply(p, x)[0]
        jout = jax.jit(int8_fwd)(params, jnp.asarray(x0))
        jk, _, _ = jax_decode(jout["hm"], jout["reg"], ja.decode_spec)
        jk, jhm = np.asarray(jk), np.asarray(jout["hm"])
    x0 = torch.from_numpy(x0)
    with torch.inference_mode(), quant.int8_mode(js):
        pout = model(x0)[0]
        hm, reg_at_peak, peak = model.predict_sparse(x0)
    pk, _, _ = port_decode(pout["hm"], pout["reg"], pa.decode_spec)
    B = jhm.shape[0]
    jpeak = jhm.reshape(B, -1).argmax(1)
    np.testing.assert_array_equal(pout["hm"].reshape(B, -1).argmax(1).numpy(), jpeak)
    np.testing.assert_array_equal(peak.numpy(), jpeak)
    tol_vox = _one_quantum_tolerance(pa, js)
    tol_m = tol_vox * np.asarray(pa.decode_spec.voxel_size_xyz)
    err = np.abs(pk.numpy() - jk)
    assert np.all(err <= tol_m), (err.max(), tol_m)
    # the serving (sparse) int8 path equals the dense one at the peak
    dense_at_peak = pout["reg"].reshape(B, -1, 45)[torch.arange(B), peak]
    np.testing.assert_allclose(reg_at_peak.numpy(), dense_at_peak.numpy(),
                               atol=1e-4 * tol_vox)
