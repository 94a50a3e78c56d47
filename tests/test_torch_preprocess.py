"""Preprocess (K1/K2): the port's plain version against rtpose_tpu's XLA
reference and its Pallas kernels (interpret mode, as tests/test_preprocess.py
runs them).  Tolerance: rtol 1e-6 (the port multiplies by 1/n1 where the
XLA reference divides: one float32 ulp), 1e-3 for f16 inputs as in
tests/test_preprocess.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from rtpose_tpu.ops import preprocess as jpre
from rtpose_tpu_torch import ops
from rtpose_tpu_torch.ops import preprocess as tpre

ROI = (4, 11, 8, 23, 16, 47)  # (z0,z1,y0,y1,x0,x1) inclusive -> (8,16,32)
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32, 1e-6),
          "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16, 1e-6),
          "float16": (np.float16, torch.float16, jnp.float16, 1e-3)}


def _raw(shape, name, seed=0):
    """The same cube for both packages: numpy -> (jax array, torch tensor)."""
    npdt, tdt, jdt, _ = DTYPES[name]
    a = np.random.default_rng(seed).uniform(-1, 12, size=shape).astype(npdt)
    t = torch.from_numpy(a).to(tdt)
    return jnp.asarray(a).astype(jdt), t


@pytest.mark.parametrize("name", list(DTYPES))
def test_reference_matches_jax_reference(name):
    j, t = _raw((8, 16, 32, 64), name)
    want = np.asarray(jpre.preprocess_reference(j, ROI, 2.0, 8.0))
    got = tpre.preprocess_reference(t, ROI, 2.0, 8.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 16, 32, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=DTYPES[name][3])


@pytest.mark.parametrize("name", list(DTYPES))
def test_single_cube_matches_pallas(name):
    """K2: fused_preprocess (one cube) in interpret mode."""
    j, t = _raw((8, 16, 32, 64), name, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpre.fused_preprocess(j, ROI, 2.0, 8.0))
    got = tpre.fused_preprocess(t, ROI, 2.0, 8.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=DTYPES[name][3])


@pytest.mark.parametrize("name", list(DTYPES))
def test_batch_matches_pallas(name):
    """K1: fused_preprocess_batch in interpret mode."""
    j, t = _raw((2, 8, 16, 32, 64), name, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpre.fused_preprocess_batch(j, ROI, 2.0, 8.0))
    got = tpre.fused_preprocess_batch(t, ROI, 2.0, 8.0)
    assert tuple(got.shape) == (2, 8, 16, 32, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=DTYPES[name][3])


def test_odd_roi_height_and_identity_roi():
    """No yo % 2 restriction (a TPU VMEM artifact); the identity ROI of the
    --device_preprocess path."""
    j, t = _raw((2, 4, 9, 11, 13), "float32", seed=3)
    odd = (1, 7, 2, 8, 0, 12)
    want = jax.vmap(lambda c: jpre.preprocess_reference(c, odd, 0.5, 3.0))(j)
    np.testing.assert_allclose(tpre.fused_preprocess_batch(t, odd, 0.5, 3.0).numpy(),
                               np.asarray(want), rtol=1e-6)
    ident = (0, 8, 0, 10, 0, 12)
    want = jax.vmap(lambda c: jpre.preprocess_reference(c, ident, 0.5, 3.0))(j)
    np.testing.assert_allclose(tpre.fused_preprocess_batch(t, ident, 0.5, 3.0).numpy(),
                               np.asarray(want), rtol=1e-6)


def test_clamp_and_nan():
    t = torch.tensor([[[[[-5.0, 0.0, 2.0, float("nan")]]]]])
    out = tpre.preprocess_reference(t, (0, 0, 0, 0, 0, 3), 1.0, 2.0)
    assert out[0, 0, 0, 0, 0].item() == 0.0 and out[0, 0, 0, 2, 0].item() == 0.5
    assert torch.isnan(out[0, 0, 0, 3, 0])


def test_wrapper_cpu_only_plain_and_no_silent_fallback():
    """CPU tensors take the plain version without launching; a tensor on
    any other device goes to the kernel path (here: refused)."""
    ops.reset_launch_counts()
    _, t = _raw((1, 8, 16, 32, 64), "float16")
    got = tpre.fused_preprocess_batch(t, ROI, 2.0, 8.0)
    assert torch.equal(got, tpre.preprocess_reference(t, ROI, 2.0, 8.0))
    assert ops.launch_counts()["preprocess"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tpre.fused_preprocess_batch(torch.empty((1, 2, 3, 4, 5), device="meta"),
                                    (0, 2, 0, 3, 0, 4), 0.0, 1.0)
