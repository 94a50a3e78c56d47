"""K3, the stride-1 3x3x3 32->32 conv: the port's plain version against
rtpose_tpu's ``conv3d_naive`` and its Pallas kernel
``conv3d_folded_gather_fast`` (interpret mode, as tests/test_pallas_conv.py
runs it, on ``fold_x`` of the same input), and the dispatch rule of
``TorchConv3d``.  Tolerance: atol 2e-3 * max|ref| as in
tests/test_pallas_conv.py, plus one bf16 ulp (rtol 2^-7): both sides sum
in float32 and round once to bf16, and where the two float32 sums straddle
a rounding boundary the outputs differ by one ulp (seen on 1 of 65,536
outputs here).  rtpose_tpu adds a bias after that rounding and the port
before it, which the same ulp covers."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from rtpose_tpu.ops import pallas_conv
from rtpose_tpu.ops.fold_conv import conv3d_naive, fold_x, unfold_x
from rtpose_tpu_torch.models.layers import TorchConv3d, conv3d
from rtpose_tpu_torch.ops import conv_k3

BF16_ULP = 2.0 ** -7


def _case(B=2, Z=4, Y=8, X=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, Z, Y, X, 32)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 32, 32)) * 0.1).astype(np.float32)   # DHWIO
    b = rng.normal(size=(32,)).astype(np.float32)
    # bf16-round once on the numpy side so both packages see equal operands
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    wt = torch.from_numpy(np.asarray(wj.astype(jnp.float32)).transpose(4, 3, 0, 1, 2).copy())
    return xj, wj, b, xt, wt


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("with_bias", [False, True])
def test_reference_matches_conv3d_naive(with_bias):
    xj, wj, b, xt, wt = _case()
    want = _f32(conv3d_naive(xj, wj, jnp.asarray(b) if with_bias else None))
    got = _f32(conv_k3.conv3d_k3_reference(xt, wt, torch.from_numpy(b) if with_bias else None))
    np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max(),
                               rtol=BF16_ULP)


def test_reference_matches_pallas_interpret():
    xj, wj, _, xt, wt = _case(seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = _f32(unfold_x(pallas_conv.conv3d_folded_gather_fast(fold_x(xj), wj)))
    got = _f32(conv_k3.conv3d_k3(xt, wt))          # CPU tensor -> plain version
    np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max(),
                               rtol=BF16_ULP)


def test_dispatch_rule():
    """bf16, kernel 3, stride 1, 32 -> 32 goes to K3 (the plain version on
    the CPU, the kernel or an error elsewhere); other shapes to F.conv3d."""
    _, _, _, xt, wt = _case(B=1, Z=3, Y=5, X=6, seed=2)
    conv_k3.launches = 0
    np.testing.assert_array_equal(_f32(conv3d(xt, wt, None)),
                                  _f32(conv_k3.conv3d_k3_reference(xt, wt)))
    assert conv_k3.launches == 0
    meta = torch.empty(xt.shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3d(meta, wt.to(torch.bfloat16).to("meta"), None)
    # not the kernel's shape: stride 2, f32, other channel counts -> F.conv3d
    assert conv3d(meta, wt.to(torch.bfloat16).to("meta"), None, stride=2).shape == (1, 2, 3, 3, 32)
    assert conv3d(meta.float(), wt.to("meta"), None).shape == meta.shape
    w16 = torch.empty((16, 32, 3, 3, 3), dtype=torch.bfloat16, device="meta")
    assert conv3d(meta, w16, None).shape == (1, 3, 5, 6, 16)


def test_torchconv3d_module_paths():
    _, _, _, xt, wt = _case(B=1, Z=3, Y=5, X=6, seed=3)
    m = TorchConv3d(32, 32, bias=False, dtype="bfloat16")
    with torch.no_grad():
        m.weight.copy_(wt)
        out = m(xt.float())
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(out), _f32(conv_k3.conv3d_k3_reference(xt, wt)))
    m32 = TorchConv3d(32, 32, bias=False)
    with torch.no_grad():
        m32.weight.copy_(wt)
        out32 = m32(xt.float())
    assert out32.dtype == torch.float32


def test_torchconv3d_keeps_prepared_weights_until_they_change():
    """Under no_grad the cast weights are kept between calls and refreshed
    when the parameter changes in place or is replaced; with grad enabled
    nothing is kept, so gradients reach the parameter."""
    _, _, _, xt, wt = _case(B=1, Z=3, Y=5, X=6, seed=4)
    m = TorchConv3d(32, 32, bias=True, dtype="bfloat16")
    with torch.no_grad():
        m.weight.copy_(wt)
        m.bias.fill_(0.5)
        first = m(xt)
        kept = m._prepared[2]
        assert m(xt) is not first and m._prepared[2] is kept
        m.weight.mul_(2.0)                                   # in place
        doubled = m(xt)
        assert m._prepared[2] is not kept
        np.testing.assert_array_equal(
            _f32(doubled), _f32(conv_k3.conv3d_k3_reference(
                xt, 2.0 * wt.float(), torch.full((32,), 0.5))))
        m.weight.data = wt.clone()                           # replaced
        np.testing.assert_array_equal(_f32(m(xt)), _f32(first))
    m._prepared = None
    out = m(xt.float())
    assert m._prepared is None
    out.float().sum().backward()
    assert m.weight.grad is not None and torch.isfinite(m.weight.grad).all()


def test_prepare_lays_weights_out_for_the_kernel():
    """``prepare`` gives the kernel's (27, 32, 32) [tap][ci][co] bf16 weights
    and float32 bias; ``launch`` takes only CUDA tensors."""
    _, _, b, xt, wt = _case(B=1, Z=3, Y=5, X=6, seed=5)
    wr, br = conv_k3.prepare(wt, torch.from_numpy(b))
    assert wr.shape == (27, 32, 32) and wr.dtype == torch.bfloat16 and wr.is_contiguous()
    assert br.dtype == torch.float32
    tap = (1 * 3 + 2) * 3 + 0                                # (kz, ky, kx) = (1, 2, 0)
    np.testing.assert_array_equal(_f32(wr[tap]), _f32(wt[:, :, 1, 2, 0].T.to(torch.bfloat16)))
    with pytest.raises(ValueError, match="CUDA"):
        conv_k3.launch(xt, wr, br)
