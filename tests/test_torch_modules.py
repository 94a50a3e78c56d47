"""Module parity: the port's layers, HRNet3D backbone (flagship arch) and
CenterHead against the flax modules, in float32, with the flax weights
carried by ``state_dict_from_jax``; and the state-dict names against
``rtpose_tpu/engine/torch_import.py``.

Tolerance: the two frameworks sum each conv in a different order (float32
rounding, ~1e-6 relative per conv); GroupNorm re-amplifies the residue, so
deep outputs agree to ~1e-4 of their range.  Single layers are held to
1e-5 of max|ref|, the deep backbone and the head to 1e-3.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rtpose_tpu.engine.torch_import import import_torch_state_dict
from rtpose_tpu.models import build_detector as jax_build_detector
from rtpose_tpu.models.center_head import CenterHead as JaxHead
from rtpose_tpu.models.hrnet3d import HRNet3D as JaxHRNet3D
from rtpose_tpu.models.hrnet3d import MODEL_CONFIGS as JAX_CONFIGS
from rtpose_tpu.models.layers import GroupNorm8 as JaxGN
from rtpose_tpu.models.layers import ResNetBlock as JaxBlock

from rtpose_tpu_torch.engine import state_dict_from_jax
from rtpose_tpu_torch.models import (MODEL_CONFIGS, CenterHead, GroupNorm8,
                                     HRNet3D, ResNetBlock, build_detector)

GRID = (8, 16, 32)
FLAGSHIP_BB = "hr_tiny_feat32_zyx_l4_in32"
HEAD_CFG = dict(tasks=[dict(num_class=1, class_names=["Pelvis"])],
                in_channels=128, share_conv_channel=128,
                common_heads={"reg": (45, 2)}, weight=0.5, code_weights=[1.0] * 45)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(module, x, seed=0):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), jnp.asarray(x)))


def _load(port_module, params):
    port_module.load_state_dict(state_dict_from_jax(params), strict=True)
    return port_module.eval()


def _close(got, want, frac):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=frac * np.abs(want).max())


@pytest.mark.parametrize("cin", [32, 16])
def test_resnet_block(cin):
    """Identity residual (32 -> 32) and the conv1 channel lift (16 -> 32)."""
    x = _x((2, 4, 8, 16, cin))
    jb = JaxBlock(32)
    params = _init(jb, x)
    tb = _load(ResNetBlock(cin, 32), params)
    with torch.no_grad():
        _close(tb(torch.from_numpy(x)), jb.apply(params, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("channels", [32, 4])
def test_group_norm(channels):
    """float32 statistics, eps 1e-5, one group when C < 8; random affine."""
    x = _x((2, 3, 4, 5, channels), seed=1) * 3 + 1
    rng = np.random.default_rng(2)
    params = {"params": {"scale": rng.normal(size=channels).astype(np.float32),
                         "bias": rng.normal(size=channels).astype(np.float32)}}
    gn = GroupNorm8(channels)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(params["params"]["scale"]))
        gn.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        _close(gn(torch.from_numpy(x)), JaxGN().apply(params, jnp.asarray(x)), 1e-5)
        out16 = gn(torch.from_numpy(x).to(torch.bfloat16))
    assert out16.dtype == torch.bfloat16


def test_model_configs_carried():
    assert MODEL_CONFIGS == JAX_CONFIGS


def test_hrnet3d_flagship_backbone():
    x = _x((1, *GRID, 32), seed=3)
    jm = JaxHRNet3D(backbone_cfg=FLAGSHIP_BB, final_conv_in=192, final_conv_out=128,
                    fold_x=False)
    params = _init(jm, x, seed=1)
    tm = _load(HRNet3D(FLAGSHIP_BB, final_conv_in=192, final_conv_out=128), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (1, *GRID, 128)
    _close(got, jm.apply(params, jnp.asarray(x)), 1e-3)


def test_hrnet3d_top_fuse_three_stage():
    """The 'top' final fuse and a three-stage arch (hr_tiny_feat32)."""
    x = _x((1, 4, 8, 16, 32), seed=4)
    jm = JaxHRNet3D(backbone_cfg="hr_tiny_feat32", final_conv_in=32,
                    final_conv_out=16, final_fuse="top", fold_x=False)
    params = _init(jm, x, seed=2)
    tm = _load(HRNet3D("hr_tiny_feat32", final_conv_in=32, final_conv_out=16,
                       final_fuse="top"), params)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)), 1e-3)


def test_center_head_dense_branch_and_patch():
    feat = _x((2, 4, 8, 16, 128), seed=5)
    jh = JaxHead(**HEAD_CFG, fold_x=False)
    params = _init(jh, feat, seed=3)
    th = _load(CenterHead(**HEAD_CFG), params)
    with torch.no_grad():
        got = th(torch.from_numpy(feat))[0]
        hm_only = th(torch.from_numpy(feat), branch="hm")[0]
    want = jh.apply(params, jnp.asarray(feat))[0]
    assert set(got) == {"reg", "hm"} and set(hm_only) == {"hm"}
    for k in ("hm", "reg"):
        _close(got[k], want[k], 1e-4)
    assert got["hm"].dtype == torch.float32
    # a 5^3 patch with an in-volume mask (the sparse-inference input, which
    # the task heads take: this head has no shared conv)
    patch = _x((2, 5, 5, 5, 128), seed=6)
    mask = np.ones((2, 5, 5, 5, 1), np.float32)
    mask[:, :2] = 0.0
    want = jh.apply(params, jnp.asarray(patch), branch="reg", patch=True,
                    inner_mask=jnp.asarray(mask))[0]["reg"]
    with torch.no_grad():
        got = th.heads(torch.from_numpy(patch), branch="reg",
                       inner_mask=torch.from_numpy(mask))[0]["reg"]
    _close(got, want, 1e-4)


def test_center_head_bf16_final_dtype():
    """The serving knob (``--final_dtype bfloat16``): the output convs run
    in bf16 and return float32.  Tolerance 1e-2 of max|ref|: both sides
    round the operands and the result to bf16 (~0.4 %) but sum in
    different orders."""
    feat = _x((1, 4, 8, 16, 128), seed=7)
    jh = JaxHead(**HEAD_CFG, fold_x=False, final_dtype=jnp.bfloat16)
    params = _init(jh, feat, seed=4)
    th = _load(CenterHead(**HEAD_CFG), params)
    th.set_final_dtype("bfloat16")
    want = jh.apply(params, jnp.asarray(feat))[0]
    with torch.no_grad():
        got = th(torch.from_numpy(feat))[0]
    for k in ("hm", "reg"):
        assert got[k].dtype == torch.float32
        _close(got[k], np.asarray(want[k], np.float32), 1e-2)


@pytest.fixture(scope="module")
def flagship_params():
    cfg = dict(type="RadarPoseNet", reader=dict(type="RadarFeatureNet"),
               backbone=dict(type="HRNet3D", backbone_cfg=FLAGSHIP_BB,
                             final_conv_in=192, final_conv_out=128,
                             final_fuse="conat_conv"),
               pose_head=dict(type="CenterHead", **HEAD_CFG), neck=None)
    params = _init(jax_build_detector(cfg), np.zeros((1, *GRID, 32), np.float32))
    return cfg, params


def test_state_dict_names_round_trip(flagship_params):
    """Every port parameter loads into flax by the reference names: no
    missing, unexpected or mismatched keys, and the values land intact."""
    cfg, params = flagship_params
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back, report = import_torch_state_dict(sd, params, JAX_CONFIGS[FLAGSHIP_BB])
    assert not report["missing"] and not report["unexpected"]
    assert not report["mismatched"]
    assert len(report["loaded"]) == len(sd) == len(jax.tree.leaves(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "backbone.backbone.layer1.conv2.groupnorm.weight" in sd
    assert "backbone.backbone.transition1.1.0.1.weight" in sd
    assert "backbone.backbone.stage2.0.fuse_layers.0.1.0.weight" in sd
    assert "pose_head.tasks.0.hm.0.weight" in sd
