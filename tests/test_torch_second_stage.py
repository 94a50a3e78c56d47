"""The port's second-stage and auxiliary model modules against rtpose_tpu's,
on the CPU, with inputs seeded through numpy: ``ops.grid_sample``, both
``PolarToCart`` modes in 2-D and 3-D, the BEV feature extractor,
``RoIHead`` and ``assign_roi_targets``, the ``RPN`` neck (5-D input, two
train-mode calls and their running statistics, the transposed conv with
an asymmetric kernel, the 'SAME' strided deblock conv), ``RadarPoseNet`` /
``VoxelNet`` with a neck, ``jde_embedding_loss``, and ``Distillation``'s
forward and ``distill_loss`` on JAX's weights through
``engine.state_dict_from_jax``.

Tolerance: float32 throughout, RTOL = 1e-5 relative to the largest value of
the compared array (summation orders of XLA's and PyTorch's CPU convs and
matmuls differ).  Grid sampling and the BEV taps sum the same terms in the
same order: held to 1e-6.  Labels, indices and argmax picks are exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rtpose_tpu.models import build_detector as jax_build
from rtpose_tpu.models import feat_transforms as jft
from rtpose_tpu.models import losses as jlosses
from rtpose_tpu.models import necks as jnecks
from rtpose_tpu.models import roi_head as jroi
from rtpose_tpu.models import second_stage as jss
from rtpose_tpu.ops import grid_sample as jgs

from rtpose_tpu_torch.engine import state_dict_from_jax
from rtpose_tpu_torch.models import (RPN, BEVFeatureExtractor, PolarToCart, RoIHead,
                                     assign_roi_targets, bilinear_interpolate, build_detector,
                                     jde_embedding_loss)
from rtpose_tpu_torch.ops import grid_sample as tgs
from rtpose_tpu_torch.registry import (DETECTORS, FEAT_TRANSFORMS, LOSSES, NECKS, ROI_HEAD,
                                       SECOND_STAGE)

RTOL = 1e-5
EXACT_TAPS = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the cores: cap torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _np(t):
    return t.detach().cpu().numpy()


def test_registries_match_jax():
    from rtpose_tpu import registry as jreg
    from rtpose_tpu_torch import registry as treg
    names = [n for n in dir(jreg) if isinstance(getattr(jreg, n), jreg.Registry)]
    assert names == [n for n in dir(treg) if isinstance(getattr(treg, n), treg.Registry)]
    assert "RPN" in NECKS and "PolarToCart" in FEAT_TRANSFORMS
    assert "BEVFeatureExtractor" in SECOND_STAGE and "RoIHead" in ROI_HEAD
    assert "Distillation" in DETECTORS and LOSSES.name == "loss"


@pytest.mark.parametrize("dim", [2, 3])
def test_grid_sample_matches_jax(dim):
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(5, 7, 3) if dim == 2 else (4, 5, 6, 2)).astype(np.float32)
    g = (rng.random((4, 6, dim) if dim == 2 else (3, 4, 5, 3)) * 2.4 - 1.2).astype(np.float32)
    jf, tf = (jgs.grid_sample_2d, tgs.grid_sample_2d) if dim == 2 else \
        (jgs.grid_sample_3d, tgs.grid_sample_3d)
    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(g)))
    got = _np(tf(torch.from_numpy(x), torch.from_numpy(g)))
    _close(got, want, EXACT_TAPS)
    # F.grid_sample computes the same function channels-first
    import torch.nn.functional as F
    xc = torch.from_numpy(np.moveaxis(x, -1, 0))[None]
    ref = F.grid_sample(xc, torch.from_numpy(g)[None], mode="bilinear", align_corners=False,
                        padding_mode="zeros")[0]
    _close(got, np.moveaxis(_np(ref), 0, -1), 1e-5)


@pytest.mark.parametrize("dimension", ["2", "3"])
@pytest.mark.parametrize("normalized", ["minus1_1", "torch_ratio"])
def test_polar_to_cart_matches_jax(dimension, normalized):
    kw = dict(cart_roi={"z": [-0.5, 1.0], "y": [-2, 2], "x": [0.25, 4]}, voxel_size=0.5,
              polar_range=(0, 5, -60, 60, -20, 20), dimension=dimension,
              normalized=normalized)
    rng = np.random.default_rng(7)
    shape = (2, 10, 12, 3) if dimension == "2" else (2, 4, 10, 12, 2)
    x = rng.normal(size=shape).astype(np.float32)
    jm = jft.PolarToCart(**kw)
    want = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x)))
    tm = PolarToCart(**kw)
    np.testing.assert_array_equal(_np(tm.grid), np.asarray(jm._grids()))
    got = _np(tm(torch.from_numpy(x)))
    assert got.shape == want.shape == ((2, 8, 8, 3) if dimension == "2" else (2, 3, 8, 8, 2))
    _close(got, want, EXACT_TAPS)
    assert tm.transform_dim == dimension


@pytest.mark.parametrize("num_point", [1, 2])
def test_bev_extractor_matches_jax(num_point):
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(2, 6, 9, 4)).astype(np.float32)
    # centers inside and outside the map (clamped edges, not zero padding)
    centers = rng.uniform([-1.0, -1.0], [5.0, 3.5], size=(2, 6 * num_point, 2)).astype(np.float32)
    kw = dict(pc_start=(-0.5, -0.25), voxel_size=(0.25, 0.25), out_stride=2)
    jm = jss.BEVFeatureExtractor(**kw)
    args = (jnp.asarray(feat), jnp.asarray(centers))
    want = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0), *args), *args, num_point))
    got = _np(BEVFeatureExtractor(**kw)(torch.from_numpy(feat), torch.from_numpy(centers),
                                         num_point))
    assert got.shape == (2, 6, 4 * num_point)
    _close(got, want, EXACT_TAPS)
    xs, ys = centers[0, :, 0] * 2, centers[0, :, 1] * 2
    one = bilinear_interpolate(torch.from_numpy(feat[0]), torch.from_numpy(xs),
                               torch.from_numpy(ys))
    _close(_np(one), np.asarray(jss.bilinear_interpolate(jnp.asarray(feat[0]), jnp.asarray(xs),
                                                         jnp.asarray(ys))), EXACT_TAPS)


@pytest.mark.parametrize("add_box_param", [False, True])
def test_roi_head_matches_jax(add_box_param):
    kw = dict(input_channels=16, shared_fc=(32, 24), cls_fc=(16,), reg_fc=(16, 8),
              num_class=2, code_size=7, add_box_param=add_box_param)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 5, 16)).astype(np.float32)
    rois = rng.normal(size=(2, 5, 7)).astype(np.float32)
    scores = rng.random((2, 5)).astype(np.float32)
    jm = jroi.RoIHead(**kw)
    jargs = tuple(jnp.asarray(a) for a in (feats, rois, scores))
    params = jm.init(jax.random.PRNGKey(1), *jargs)
    # LayerNorm scales and biases away from their init values
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(len(str(p))), v.shape)
        if "ln" in str(p) else v, params)
    want = jm.apply(params, *jargs)
    tm = RoIHead(**kw)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    got = tm(*(torch.from_numpy(a) for a in (feats, rois, scores)))
    for k in ("rcnn_cls", "rcnn_reg"):
        _close(_np(got[k]), np.asarray(want[k]))


def test_assign_roi_targets_matches_jax():
    rng = np.random.default_rng(5)
    gt = np.concatenate([rng.uniform(-2, 2, (4, 3)), rng.uniform(0.5, 1.5, (4, 3)),
                         rng.uniform(-1, 1, (4, 1))], 1).astype(np.float32)
    rois = np.concatenate([gt[[0, 0, 1, 2, 3, 3]] + rng.normal(scale=0.2, size=(6, 7)),
                           gt[:2] + 5.0], 0).astype(np.float32)
    rois[-1] = gt[3]            # equal IoU 1.0 with GT 3 and its copy (GT 4): first wins
    gt = np.concatenate([gt, gt[3:4], np.zeros((1, 7), np.float32)], 0)
    for num_gt in (5, 3):
        want = jroi.assign_roi_targets(jnp.asarray(rois), jnp.ones(len(rois)), jnp.asarray(gt),
                                       jnp.int32(num_gt))
        got = assign_roi_targets(torch.from_numpy(rois), torch.ones(len(rois)),
                                 torch.from_numpy(gt), num_gt)
        np.testing.assert_array_equal(_np(got["labels"]), np.asarray(want["labels"]))
        _close(_np(got["max_iou"]), np.asarray(want["max_iou"]))
        np.testing.assert_array_equal(_np(got["target_boxes"]), np.asarray(want["target_boxes"]))
    assert set(_np(got["labels"]).tolist()) <= {-1, 0, 1}


RPN_CASES = {
    # strides (1, 2) down, (1, 2) up: a 1x1 stride-1 deblock conv and a
    # 2x2 transposed conv
    "deconv2": dict(layer_nums=(1, 2), ds_layer_strides=(1, 2), ds_num_filters=(8, 12),
                    us_layer_strides=(1, 2), us_num_filters=(4, 6), num_input_features=3),
    # a 3x3 transposed conv, and one downsample block left out of the upsampling
    "deconv3": dict(layer_nums=(1, 1, 1), ds_layer_strides=(1, 3, 1),
                    ds_num_filters=(6, 6, 8), us_layer_strides=(3, 3),
                    us_num_filters=(5, 4), num_input_features=3),
    # stride-2 'SAME' deblock convs on an odd grid
    "same_conv": dict(layer_nums=(1, 1), ds_layer_strides=(1, 1), ds_num_filters=(8, 8),
                      us_layer_strides=(0.5, 0.5), us_num_filters=(4, 4),
                      num_input_features=3),
}


def _rpn_input(case, five_d):
    rng = np.random.default_rng(11)
    hw = {"deconv2": (6, 8), "deconv3": (6, 9), "same_conv": (7, 9)}[case]
    shape = (2, 3, *hw, 3) if five_d else (2, *hw, 3)
    return rng.normal(size=shape).astype(np.float32)


def _perturbed(variables, scale=0.1):
    """BatchNorm scales / biases / running stats away from their init."""
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    out = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(variables),
        [v + scale * jax.random.uniform(jax.random.PRNGKey(i), v.shape)
         if v.ndim == 1 else v for i, (_, v) in enumerate(leaves)])
    return out


@pytest.mark.parametrize("case", list(RPN_CASES))
@pytest.mark.parametrize("five_d", [False, True])
def test_rpn_matches_jax(case, five_d):
    """Eval output, then two train-mode calls: outputs, running statistics
    (flax momentum, biased variance) and the input gradient of the second."""
    kw = RPN_CASES[case]
    x = _rpn_input(case, five_d)
    jm = jnecks.RPN(**kw)
    variables = _perturbed(jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x))))
    tm = RPN(**kw)
    tm.load_state_dict(state_dict_from_jax(variables))
    if kw["us_layer_strides"][-1] >= 1:
        assert tm.downsample_factor == jm.downsample_factor
    else:       # int(0.5): both packages divide by zero
        for m in (tm, jm):
            with pytest.raises(ZeroDivisionError):
                m.downsample_factor
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = _np(tm(torch.from_numpy(x)))
    assert got.shape == want.shape and got.shape[:-3] == x.shape[:-3]
    _close(got, want)
    jvars, xt = variables, torch.from_numpy(x).requires_grad_(True)
    for call in range(2):
        (jout, upd) = jm.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
        jvars = {"params": jvars["params"], "batch_stats": upd["batch_stats"]}
        out = tm(xt, train=True)
        _close(_np(out), np.asarray(jout))
    sd = state_dict_from_jax(jax.device_get(jvars))
    for name, buf in tm.named_buffers():
        _close(_np(buf), _np(sd[name]))
    gx = jax.grad(lambda a: jnp.sum(jm.apply(jvars, a, train=True, mutable=["batch_stats"])[0]
                                    * jnp.arange(1.0, 1.0 + jout.shape[-1])))(jnp.asarray(x))
    xt.grad = None
    out = tm(xt, train=True)
    (out * torch.arange(1.0, 1.0 + out.shape[-1])).sum().backward()
    _close(_np(xt.grad), np.asarray(gx), 1e-4)


def test_batchnorm_running_stats_match_flax():
    """Two train-mode calls of the port's BatchNorm against flax's: outputs
    and running statistics; ``torch.nn.BatchNorm2d`` at the same momentum
    updates the variance with the unbiased batch variance instead."""
    import flax.linen as fnn
    from rtpose_tpu_torch.models import BatchNormNHWC
    rng = np.random.default_rng(12)
    xs = [rng.normal(loc=0.5, scale=2.0, size=(3, 4, 5, 6)).astype(np.float32)
          for _ in range(2)]
    jm = fnn.BatchNorm(momentum=0.99, epsilon=1e-3, dtype=jnp.float32)
    jvars = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), use_running_average=False)
    tm, ref = BatchNormNHWC(6), torch.nn.BatchNorm2d(6, eps=1e-3, momentum=0.01)
    for x in xs:
        jout, upd = jm.apply(jvars, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
        jvars = {"params": jvars["params"], "batch_stats": upd["batch_stats"]}
        _close(_np(tm(torch.from_numpy(x), train=True)), np.asarray(jout))
        ref(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(_np(tm.running_mean), np.asarray(jvars["batch_stats"]["mean"]))
    _close(_np(tm.running_var), np.asarray(jvars["batch_stats"]["var"]))
    assert not np.allclose(_np(ref.running_var), _np(tm.running_var), rtol=1e-4, atol=0)
    _close(_np(tm(torch.from_numpy(xs[0]))),
           np.asarray(jm.apply(jvars, jnp.asarray(xs[0]), use_running_average=True)))


def test_rpn_transposed_conv_asymmetric_kernel():
    """One deconv deblock with a kernel that differs under every flip: the
    converted ConvTranspose2d weight reproduces flax's ConvTranspose."""
    kw = dict(layer_nums=(0,), ds_layer_strides=(1,), ds_num_filters=(2,),
              us_layer_strides=(2,), us_num_filters=(1,), num_input_features=2)
    jm = jnecks.RPN(**kw)
    x = np.zeros((1, 2, 3, 2), np.float32)
    x[0, 1, 2, 0] = 1.0                                    # one hot pixel
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    k = np.arange(1.0, 9.0, dtype=np.float32).reshape(2, 2, 2, 1)
    variables["params"]["deblock0_deconv"]["kernel"] = k
    conv = np.zeros((3, 3, 2, 2), np.float32)
    conv[1, 1] = np.eye(2)                                  # identity 3x3 conv
    variables["params"]["block0_conv0"]["kernel"] = conv
    # BatchNorm as identity on the way in; the last one shows the raw deconv
    for name in ("block0_bn0", "deblock0_bn"):
        variables["batch_stats"][name]["var"] = np.full_like(
            variables["batch_stats"][name]["var"], 1.0 - 1e-3)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = RPN(**kw)
    tm.load_state_dict(state_dict_from_jax(variables))
    got = _np(tm(torch.from_numpy(x)))
    _close(got, want)
    # the hot pixel (1, 2) lands on output rows 2-3, columns 4-5: flax's
    # tap order is flipped there (pixel i * s + r reads tap s - 1 - r)
    np.testing.assert_allclose(got[0, 2:4, 4:6, 0], k[::-1, ::-1, 0, 0], rtol=1e-6)


def test_rpn_no_neck_factor_and_registry():
    from rtpose_tpu.utils.config_tool import get_downsample_factor as jax_factor
    from rtpose_tpu_torch.utils import get_downsample_factor
    neck = dict(type="RPN", ds_layer_strides=[2, 2, 2], us_layer_strides=[1, 2, 4])
    for cfg in ({"neck": neck}, {"neck": None, "backbone": {"ds_factor": 2}},
                {"first_stage_cfg": {"neck": neck, "backbone": {"ds_factor": 1}}}):
        assert get_downsample_factor(cfg) == jax_factor(cfg)
    assert RPN(ds_layer_strides=(2, 2, 2), us_layer_strides=(1, 2, 4)).downsample_factor == 2


HEAD = dict(type="CenterHead", tasks=[dict(num_class=1, class_names=["Pelvis"])],
            in_channels=64, share_conv_channel=64, common_heads={"reg": (45, 2)}, weight=0.5,
            code_weights=[1.0] * 45)
BACKBONE = dict(type="HRNet3D", backbone_cfg="hr_tiny_feat16_zyx_l4", final_conv_in=176,
                final_conv_out=64, final_fuse="conat_conv")
NECK = dict(type="RPN", layer_nums=(1, 1), ds_layer_strides=(1, 2), ds_num_filters=(32, 32),
            us_layer_strides=(1, 2), us_num_filters=(32, 32), num_input_features=64)
GRID = (4, 8, 8)


def _lidar_batch(rng, B=1):
    from rtpose_tpu.ops.voxelize import VoxelizerSpec, voxelize
    spec = VoxelizerSpec(pc_range=(0, -2, -1, 4, 2, 1), voxel_size=(0.5, 0.5, 0.5),
                         max_points=4, max_voxels=16)
    pts = rng.uniform([0, -2, -1, 0], [4, 2, 1, 1], size=(B, 32, 4)).astype(np.float32)
    vox = jax.vmap(lambda p: voxelize(p, jnp.int32(32), spec))(jnp.asarray(pts))
    return {k: np.asarray(vox[k]) for k in ("voxels", "num_points_per_voxel", "coors",
                                            "num_voxels")}


def _student(neck=None):
    return dict(type="RadarPoseNet", reader=dict(type="RadarFeatureNet"),
                backbone=dict(BACKBONE), pose_head=dict(HEAD), neck=neck)


def _teacher(neck=None):
    return dict(type="VoxelNet", reader=dict(type="VoxelFeatureExtractorV3",
                                             num_input_features=4),
                backbone=dict(BACKBONE), pose_head=dict(HEAD), neck=neck, grid_zyx=GRID)


def _compare_preds(got, want):
    for g, w in zip(got, want):
        for k in w:
            _close(_np(g[k]), np.asarray(w[k]))


@pytest.mark.parametrize("kind", ["radar", "lidar"])
def test_detectors_build_a_neck(kind):
    """RadarPoseNet (5-D features, per Z plane) and VoxelNet with an RPN
    neck, on JAX's weights (the neck normalizes with its running stats)."""
    rng = np.random.default_rng(21)
    cfg = _student(dict(NECK)) if kind == "radar" else _teacher(dict(NECK))
    jm = jax_build(cfg)
    if kind == "radar":
        inp = rng.normal(size=(1, *GRID, 1)).astype(np.float32)
        jin, tin = jnp.asarray(inp), torch.from_numpy(inp)
    else:
        inp = _lidar_batch(rng)
        jin, tin = ({k: jnp.asarray(v) for k, v in inp.items()},
                    {k: torch.from_numpy(v) for k, v in inp.items()})
    variables = _perturbed(jax.device_get(jm.init(jax.random.PRNGKey(3), jin)), 0.05)
    tm = build_detector(cfg).eval()
    tm.load_state_dict(state_dict_from_jax(variables))
    assert tm.neck is not None and "neck.block1_bn1.running_var" in tm.state_dict()
    with torch.no_grad():
        got = tm(tin)
    _compare_preds(got, jm.apply(variables, jin))


def test_jde_embedding_loss_matches_jax():
    rng = np.random.default_rng(8)
    for n, ids, mask in ((6, [0, 0, 1, 1, 2, 2], [1, 1, 1, 1, 1, 0]),
                         (4, [0, 1, 2, 3], [1, 1, 1, 1]),          # no positive: 0
                         (5, [3, 3, 3, 1, 1], [1, 0, 1, 1, 1])):
        e = rng.normal(size=(n, 8)).astype(np.float32)
        want = float(jlosses.jde_embedding_loss(jnp.asarray(e), jnp.asarray(ids),
                                                jnp.asarray(mask, jnp.float32), margin=0.3))
        got = jde_embedding_loss(torch.from_numpy(e), torch.tensor(ids),
                                 torch.tensor(mask, dtype=torch.float32), margin=0.3)
        assert abs(got.item() - want) <= RTOL * max(abs(want), 1.0)
    collapsed = jde_embedding_loss(torch.ones(4, 2), torch.tensor([0, 0, 1, 1]), torch.ones(4))
    assert collapsed.item() == pytest.approx(0.3, abs=1e-6)


def test_distillation_matches_jax():
    """Forward (both preds and features) and ``distill_loss`` on JAX's
    weights; the teacher frozen through ``utils.freeze`` gets no gradient."""
    from rtpose_tpu_torch.utils import split_frozen
    rng = np.random.default_rng(0)
    cfg = dict(type="Distillation", student=_student(), teacher=_teacher(), feat_weight=0.7,
               hm_weight=1.3)
    radar = rng.normal(size=(1, *GRID, 1)).astype(np.float32)
    lidar = _lidar_batch(rng)
    jm = jax_build(cfg)
    jr, jl = {"rdr_tensor": jnp.asarray(radar)}, {k: jnp.asarray(v) for k, v in lidar.items()}
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jr, jl))
    jout = jm.apply(params, jr, jl)
    jloss = float(jm.apply(params, *jout, method="distill_loss"))
    tm = build_detector(cfg)
    sd = state_dict_from_jax(params)
    assert any(k.startswith("student.") for k in sd) and any(k.startswith("teacher.") for k in sd)
    tm.load_state_dict(sd)
    tr = {"rdr_tensor": torch.from_numpy(radar)}
    tl = {k: torch.from_numpy(v) for k, v in lidar.items()}
    out = tm(tr, tl)
    _compare_preds(out[0], jout[0])
    _compare_preds(out[1], jout[1])
    _close(_np(out[2]), np.asarray(jout[2]))
    _close(_np(out[3]), np.asarray(jout[3]))
    loss = tm.distill_loss(*out)
    assert abs(loss.item() - jloss) <= RTOL * abs(jloss)
    opt = split_frozen(lambda ps: torch.optim.SGD(ps, lr=0.1), tm, ["teacher"])
    out = tm(tr, tl)
    assert not out[3].requires_grad and out[2].requires_grad
    tm.distill_loss(*out).backward()
    opt.step()
    assert all(p.grad is None for p in tm.teacher.parameters())
    assert all(torch.equal(p, sd[f"teacher.{n}"]) for n, p in tm.teacher.named_parameters())
