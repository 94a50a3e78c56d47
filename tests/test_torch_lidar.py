"""The port's LiDAR branch against rtpose_tpu's, on the CPU: the three
readers, VoxelNet's float32 forward and one train step on converted
weights, ``unflip_pose_preds``, the double-flip TTA eval step, the
int8 sites' flax paths and a bf16 serving artifact.

Tolerances: the readers sum a few points and run one dense layer: rtol
1e-5.  VoxelNet runs the radar slice's network behind the voxel scatter,
so it is held as ``tests/test_torch_slice.py`` / ``test_torch_train_step.py``
hold it: heatmap logits and regression within 1e-3 of their largest value,
loss terms and the gradient norm to rtol 1e-4, each gradient leaf to 1e-3
of its largest value.  ``unflip_pose_preds`` flips and subtracts from 1.0:
exact.  The TTA step averages four forwards and decodes once: keypoints to
ATOL_M = 1e-4 m, scores to rtol 1e-4 (``tests/test_torch_multipose.py``'s).
The train step's gradients, float64 and float32, are held against
JAX's float64 ones (its docstring says why).
The artifact runs the live model's operations on the same prepared
weights: bit for bit.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from rtpose_tpu.core import decode as jdec
from rtpose_tpu.core.targets import PoseTargetSpec as JaxSpec
from rtpose_tpu.data.pipelines import Voxelization as JaxVoxelization
from rtpose_tpu.engine import create_train_state as jax_create_state
from rtpose_tpu.engine import make_eval_step as jax_eval_step
from rtpose_tpu.engine import make_train_step as jax_make_train_step
from rtpose_tpu.models import CenterHead as JaxHead
from rtpose_tpu.models import build_detector as jax_build
from rtpose_tpu.models.readers import PillarFeatureNet as JaxPillars
from rtpose_tpu.models.readers import PointPillarsScatter as JaxPillarScatter
from rtpose_tpu.models.readers import VoxelFeatureExtractorV3 as JaxVFE
from rtpose_tpu.ops import quant as jquant

from rtpose_tpu_torch import export as pexp
from rtpose_tpu_torch.api import Assembly
from rtpose_tpu_torch.core import decode as tdec
from rtpose_tpu_torch.core.targets import PoseTargetSpec
from rtpose_tpu_torch.data.pipelines import Voxelization
from rtpose_tpu_torch.engine import (VOXEL_KEYS, make_eval_step, make_loss_fn, site_paths,
                                     state_dict_from_jax)
from rtpose_tpu_torch.models import (PillarFeatureNet, PointPillarsScatter,
                                     VoxelFeatureExtractorV3, build_detector)
from rtpose_tpu_torch.ops import quant

# ranges symmetric about 0 in x and y (the flip TTA's assumption), binary
# voxel sizes: grid (x, y, z) = (16, 8, 8)
RANGE = [-2.0, -1.0, -1.0, 2.0, 1.0, 1.0]
VSIZE = [0.25, 0.25, 0.25]
GRID = (8, 8, 16)
V, P, F = 64, 4, 4
ATOL_M = 1e-4
LR = 1e-3
MODEL_CFG = dict(
    type="VoxelNet",
    reader=dict(type="VoxelFeatureExtractorV3", num_input_features=4),
    backbone=dict(type="HRNet3D", backbone_cfg="hr_tiny_feat16_zyx_l4", final_conv_in=176,
                  final_conv_out=64, final_fuse="conat_conv", ds_factor=1),
    pose_head=dict(type="CenterHead", tasks=[dict(num_class=1, class_names=["Pelvis"])],
                   in_channels=64, share_conv_channel=64, common_heads={"reg": (45, 2)},
                   weight=0.5, code_weights=[1.0] * 45, dataset="cruw_pose", dcn_head=False),
    neck=None,
    grid_zyx=GRID,
)
SPEC_KW = dict(grid_zyx=GRID, pc_range_min_xyz=tuple(RANGE[:3]), voxel_size_xyz=tuple(VSIZE),
               max_poses=1, min_radius=2, mode="one_hm", num_classes=1)
DECODE_KW = dict(grid_zyx=GRID, pc_range_min_xyz=tuple(RANGE[:3]),
                 voxel_size_xyz=tuple(VSIZE))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the cores: cap torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cloud(rng, pelvis):
    """A person-like cluster around ``pelvis`` plus clutter, (N, 4)."""
    body = pelvis + rng.normal(scale=(0.15, 0.15, 0.4), size=(60, 3))
    clutter = rng.uniform(RANGE[:3], RANGE[3:], size=(40, 3))
    xyz = np.concatenate([body, clutter]).astype(np.float32)
    return np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)], 1)


def _voxel_cfg(**extra):
    return dict(range=RANGE, voxel_size=VSIZE, max_points_in_voxel=P, max_voxel_num=V,
                max_num_points=128, **extra)


def _batch(seed, B=2, mode="train", **vox_extra):
    """B point clouds through the port's Voxelization stage (the JAX one
    gives the same arrays: ``tests/test_torch_lidar_data.py``), stacked,
    with one pose per sample around each cloud's pelvis."""
    rng = np.random.default_rng(seed)
    stage = Voxelization(cfg=_voxel_cfg(**vox_extra))
    items, poses = [], []
    for _ in range(B):
        pelvis = rng.uniform([-1.2, -0.5, -0.5], [1.2, 0.5, 0.3])
        items.append(stage({"points": _cloud(rng, pelvis), "mode": mode}))
        pose = pelvis + rng.normal(scale=0.2, size=(15, 3))
        pose[0] = pelvis
        poses.append(np.clip(pose, np.array(RANGE[:3]) + 0.05, np.array(RANGE[3:]) - 0.05))
    batch = {}
    for k in items[0]:
        if k.endswith("coordinates"):
            batch[k[: -len("coordinates")] + "coors"] = np.stack([it[k] for it in items])
        elif k not in ("points", "mode", "grid_zyx"):
            batch[k] = np.stack([np.asarray(it[k]) for it in items])
    batch["poses"] = np.stack(poses)[:, None].astype(np.float32)
    batch["num_poses"] = np.ones((B,), np.int32)
    return batch


@pytest.fixture(scope="module")
def env():
    jmodel = jax_build(MODEL_CFG)
    jhead = JaxHead(**{k: v for k, v in MODEL_CFG["pose_head"].items() if k != "type"})
    batch = _batch(0)
    params = jmodel.init(jax.random.PRNGKey(0),
                         {k: jnp.asarray(batch[k]) for k in VOXEL_KEYS})
    params = jax.tree.map(np.array, params)
    # He-init regression outputs are tens of voxels; scale them to the
    # sub-voxel offsets of a trained head (tests/test_torch_slice.py)
    params["params"]["head_m"]["task0"]["reg_out"]["kernel"] *= 0.01
    model = build_detector(MODEL_CFG)
    model.load_state_dict(state_dict_from_jax(params))
    return dict(jmodel=jmodel, jhead=jhead, params=params, batch=batch,
                model=model.eval())


def _vox(batch, prefix=""):
    return {k: batch[prefix + k] for k in VOXEL_KEYS}


# ---- readers


def test_vfe_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, V, P, F)).astype(np.float32)
    npts = rng.integers(0, P + 1, size=(2, V)).astype(np.int32)
    feats *= (np.arange(P)[None, None, :] < npts[..., None]).astype(np.float32)[..., None]
    vfe = JaxVFE()
    want = np.stack([np.asarray(vfe.apply({}, jnp.asarray(f), jnp.asarray(n)))
                     for f, n in zip(feats, npts)])
    got = VoxelFeatureExtractorV3()(torch.from_numpy(feats), torch.from_numpy(npts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert not got[npts == 0].any()


@pytest.mark.parametrize("batch", [(), (3,)], ids=["unbatched", "batched"])
def test_pillar_feature_net_on_converted_weights(batch):
    """flax Dense (no bias) -> LayerNorm (epsilon 1e-6, fast variance) ->
    ReLU -> mask -> max over points; the flax parameters carried over by
    ``state_dict_from_jax`` (the ``reader_m`` subtree of a VoxelNet).  With
    a leading batch axis the port takes it whole; JAX's module runs under
    ``jax.vmap``."""
    rng = np.random.default_rng(1)
    kw = dict(num_filters=(16, 8), voxel_size=(0.25, 0.25, 2.0),
              pc_range=(-2.0, -1.0, -1.0, 2.0, 1.0, 1.0), num_input_features=4)
    feats = rng.normal(size=(*batch, V, P, F)).astype(np.float32)
    npts = rng.integers(0, P + 1, size=(*batch, V)).astype(np.int32)
    coors = np.stack([np.zeros((*batch, V)), rng.integers(0, 8, (*batch, V)),
                      rng.integers(0, 16, (*batch, V))], -1).astype(np.int32)
    jm = JaxPillars(**kw)
    one = (slice(None),) if not batch else (0,)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(feats[one]), jnp.asarray(npts[one]),
                     jnp.asarray(coors[one]))
    params = jax.tree.map(np.array, params)
    # non-trivial LayerNorm affine parameters
    for name in ("LayerNorm_0", "LayerNorm_1"):
        ln = params["params"][name]
        ln["scale"] = rng.uniform(0.5, 1.5, ln["scale"].shape).astype(np.float32)
        ln["bias"] = rng.normal(scale=0.1, size=ln["bias"].shape).astype(np.float32)
    apply = jm.apply if not batch else jax.vmap(jm.apply, in_axes=(None, 0, 0, 0))
    want = np.asarray(apply(params, jnp.asarray(feats), jnp.asarray(npts), jnp.asarray(coors)))
    sd = state_dict_from_jax({"reader_m": params["params"]})
    assert sorted(sd) == ["reader.linears.0.weight", "reader.linears.1.weight",
                          "reader.norms.0.bias", "reader.norms.0.weight",
                          "reader.norms.1.bias", "reader.norms.1.weight"]
    tm = PillarFeatureNet(**kw)
    tm.load_state_dict({k.removeprefix("reader."): v for k, v in sd.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(npts),
                 torch.from_numpy(coors)).numpy()
    assert got.shape == want.shape == (*batch, V, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_point_pillars_scatter_matches_jax():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(V, 6)).astype(np.float32)
    flat = rng.choice(8 * 16, size=V, replace=False)
    coors = np.stack([np.zeros(V), flat // 16, flat % 16], 1).astype(np.int32)
    valid = np.arange(V) < 40
    want = np.asarray(JaxPillarScatter().apply({}, jnp.asarray(feats), jnp.asarray(coors),
                                               jnp.asarray(valid), (8, 16)))
    got = PointPillarsScatter()(torch.from_numpy(feats), torch.from_numpy(coors),
                                torch.from_numpy(valid), (8, 16)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# ---- VoxelNet


def test_backbone_takes_the_reader_width(env):
    """layer1 lifts the reader's 4 features (the arch table says 1, the
    radar cube's); the keys are RadarPoseNet's."""
    model = env["model"]
    w = model.backbone.backbone.layer1.conv1.weight
    assert w.shape[:2] == (16, 4)
    assert sorted(model.state_dict()) == sorted(state_dict_from_jax(env["params"]))


def test_voxelnet_forward_matches_jax(env):
    batch = env["batch"]
    want = env["jmodel"].apply(env["params"], {k: jnp.asarray(v)
                                               for k, v in _vox(batch).items()})
    with torch.no_grad():
        got = env["model"]({k: torch.from_numpy(v) for k, v in _vox(batch).items()})
    for key in ("hm", "reg"):
        w = np.asarray(want[0][key])
        g = got[0][key].numpy()
        assert g.shape == w.shape == (2, *GRID, 1 if key == "hm" else 45)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max(), err_msg=key)


def _grad_keeper():
    """An optax transformation whose state after an update is the gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _jax_train_step(env, dtype):
    """JAX's dense step (``input_key=None``, no sparse reg) in ``dtype``
    (float64 under x64): its metrics and its gradients as float64 arrays."""
    batch = {k: (v.astype(dtype) if v.dtype == np.float32 else v)
             for k, v in env["batch"].items()}
    params = jax.tree.map(lambda a: np.asarray(a, dtype), env["params"])
    with jax.enable_x64(dtype == np.float64):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        state = jax_create_state(env["jmodel"], _grad_keeper(), _vox(jb))
        state = state.replace(params=jax.tree.map(jnp.asarray, params),
                              opt_state=jax.tree.map(jnp.zeros_like, params))
        step = jax.jit(jax_make_train_step(env["jmodel"], env["jhead"], JaxSpec(**SPEC_KW),
                                           _grad_keeper(), lr_fn=lambda s: jnp.float32(LR),
                                           input_key=None, sparse_reg=False))
        new_state, jm = step(state, jb)
        jm = jax.device_get(jm)
        grads = jax.device_get(new_state.opt_state)
    assert jax.tree.leaves(grads)[0].dtype == dtype
    return jm, {k: v.double().numpy() for k, v in state_dict_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float64), grads)).items()}


def _port_train_step(env, dtype):
    """The port's loss and backward on the same weights and batch in
    ``dtype``: (loss, loss terms, gradient norm, gradients)."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    batch = {k: (v.astype(dtype) if v.dtype == np.float32 else v)
             for k, v in env["batch"].items()}
    model = build_detector(MODEL_CFG).to(tdt)
    model.load_state_dict({k: v.to(tdt) for k, v in state_dict_from_jax(
        jax.tree.map(lambda a: np.asarray(a, dtype), env["params"])).items()})
    loss_fn = make_loss_fn(model, model.pose_head, PoseTargetSpec(**SPEC_KW), input_key=None)
    loss, losses = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                           torch.zeros((), dtype=torch.int64))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g.dtype == tdt for g in grads.values())
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    return loss, losses, gnorm, {k: g.double().numpy() for k, g in grads.items()}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
def test_train_step_matches_jax(env, dtype):
    """The dense step (``input_key=None``, no sparse reg) on converted
    weights and the same voxel batch: loss terms, gradient norm, and every
    gradient leaf.

    Both dtypes hold every leaf of the port within 1e-3 of its largest
    value of JAX's float64 gradient.  Not of JAX's float32 one: the dense
    grid of a point cloud is mostly empty, so layer1's output is its bias
    over most of the volume and the GroupNorm after it sees a variance
    small against its mean; JAX's float32 step moves layer1's bias gradient
    0.13 % from its float64 one on this batch (the port's float32 step:
    0.004 %), its summation order against the input's conditioning."""
    jm, jgrads = _jax_train_step(env, dtype)
    loss, losses, gnorm, grads = _port_train_step(env, dtype)
    assert float(jm["num_positive"]) == 2.0
    for got, key in ((loss.detach(), "loss"), (losses["hm_loss"][0].detach(), "hm_loss"),
                     (losses["loc_loss"][0].detach(), "loc_loss"), (gnorm, "grad_norm"),
                     (losses["num_positive"][0], "num_positive")):
        np.testing.assert_allclose(float(got), float(jm[key]), rtol=1e-4, err_msg=key)
    assert sorted(grads) == sorted(jgrads)
    exact = jgrads if dtype == np.float64 else _jax_train_step(env, np.float64)[1]
    for k, g in grads.items():
        w = exact[k]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


# ---- double-flip TTA


@pytest.mark.parametrize("flip", [(False, True), (True, False), (True, True)])
def test_unflip_matches_jax_exactly(flip):
    rng = np.random.default_rng(4)
    hm = rng.normal(size=(2, *GRID, 1)).astype(np.float32)
    reg = rng.normal(size=(2, *GRID, 45)).astype(np.float32)
    jh, jr = jdec.unflip_pose_preds(jnp.asarray(hm), jnp.asarray(reg), *flip)
    th, tr = tdec.unflip_pose_preds(torch.from_numpy(hm), torch.from_numpy(reg), *flip)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("tta_flips", [None, ["yflip"]])
def test_tta_eval_step_matches_jax(env, tta_flips):
    """The four voxel sets (or the original and the y-flip) of two frames,
    made by the port's Voxelization stage at test time, through both eval
    steps on the same weights."""
    extra = dict(double_flip=True)
    if tta_flips is not None:
        extra["tta_flips"] = tta_flips
    batch = _batch(6, mode="test", **extra)
    n_sets = sum(1 for k in batch if k == "voxels" or k.endswith("flip_voxels"))
    assert n_sets == (4 if tta_flips is None else 2)
    # the JAX stage makes the same sets
    jstage = JaxVoxelization(cfg=_voxel_cfg(**extra))
    assert [p for p, _ in jstage.tta_flips] == [p for p, _ in Voxelization(
        cfg=_voxel_cfg(**extra)).tta_flips]
    jstep = jax_eval_step(env["jmodel"], env["jhead"], jdec.DecodeSpec(**DECODE_KW),
                          input_key=None, tta_double_flip=True)
    (jk, js, jl), = jstep(env["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_eval_step(env["model"], tdec.DecodeSpec(**DECODE_KW), input_key=None,
                          tta_double_flip=True)
    (tk, ts, tl), = step({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=ATOL_M)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # the plain step reads only the original set and decodes otherwise
    (pk, _, _), = make_eval_step(env["model"], tdec.DecodeSpec(**DECODE_KW),
                                 input_key=None)({k: torch.from_numpy(v)
                                                  for k, v in batch.items()})
    assert pk.shape == tk.shape == (2, 15, 3)


# ---- serving


def _assembly(model, cfg=MODEL_CFG):
    return Assembly(model=model, decode_spec=tdec.DecodeSpec(**DECODE_KW), one_hm=True,
                    model_cfg=cfg, target_spec=PoseTargetSpec(**SPEC_KW),
                    input_shape_zyxc=(*GRID, 1), sensor="lidar", voxel_shape=(V, P, F))


def test_int8_sites_and_scales_match_jax(env):
    """Both packages calibrate on the same voxel batch: the same sites key
    for key (the flax paths ``site_paths`` names; at X = 16 the JAX package
    does not fold, so ``final_conv`` and the resizes are no sites), scales
    to rtol 1e-4 (``tests/test_torch_quant.py``)."""
    jparams = jax.tree.map(jnp.asarray, env["params"])
    vox = _vox(env["batch"])
    want = jquant.calibration_scales(lambda x: env["jmodel"].apply(jparams, x),
                                     [{k: jnp.asarray(v) for k, v in vox.items()}],
                                     exclude=jquant.INT8_RESIZE_EXCLUDE)
    asm = _assembly(env["model"])
    got = pexp.calibrate_predict(asm, [{k: torch.from_numpy(v) for k, v in vox.items()}],
                                 exclude=quant.INT8_RESIZE_EXCLUDE)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    convs = set(site_paths(env["model"]).values()) - {"backbone_m", "backbone_m/final_conv"}
    assert set(got) == {p for p in convs if not p.endswith("_out")}
    assert len(got) == 51


def test_bf16_artifact_equals_live(env):
    """A bf16 VoxelNet (the shipped config's compute dtype) exported for
    the CPU: the four voxel tensors in, the decoded keypoints equal to the
    live model's bit for bit, its metadata naming the voxel inputs."""
    cfg = dict(MODEL_CFG, backbone=dict(MODEL_CFG["backbone"], dtype="bfloat16"),
               pose_head=dict(MODEL_CFG["pose_head"], dtype="bfloat16"))
    model = build_detector(cfg)
    model.load_state_dict(state_dict_from_jax(env["params"]))
    asm = _assembly(model.eval(), cfg)
    x = {k: torch.from_numpy(v) for k, v in _vox(env["batch"]).items()}
    live = pexp.make_predict_fn(asm)(x)
    ep = pexp.export_predict(asm, batch_size=2, device="cpu")
    got = pexp._grouped(ep.module()(*(x[k] for k in VOXEL_KEYS)))
    assert len(got) == len(live) == 1
    for u, v in zip(got[0], live[0]):
        assert u.dtype == v.dtype and torch.equal(u, v)
    meta = ep.rtpose_meta
    assert meta["input_shape"] == {"voxels": [2, V, P, F], "num_points_per_voxel": [2, V],
                                   "coors": [2, V, 3], "num_voxels": [2]}
    assert meta["input_dtype"]["coors"] == "int32"
