"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  Imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: preprocess, 1e-6 relative (the same float32 ops in the same
order); conv, one bf16 ulp (2^-7 relative) plus 2e-3 of the output range
(float32 sums in two orders, each rounded once to bf16).
"""

import pytest
import torch

from rtpose_tpu_torch import ops
from rtpose_tpu_torch.ops import conv_k3, preprocess

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,roi", [
    ((2, 32, 16, 64, 160), (0, 15, 0, 63, 0, 159)),
    ((1, 3, 9, 11, 45), (1, 7, 2, 8, 3, 40)),          # odd ROI, D < 32, ragged X
    ((2, 40, 4, 5, 70), (0, 3, 1, 3, 5, 69)),          # D > 32: two channel tiles
])
def test_preprocess_kernel_matches_plain(dev, dtype, shape, roi):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand(shape, generator=g, device=dev) * 12 - 1).to(dtype)
    ops.reset_launch_counts()
    got = preprocess.fused_preprocess_batch(x, roi, 2.0, 8.0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["preprocess"] == 1
    want = preprocess.preprocess_reference(x, roi, 2.0, 8.0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    single = preprocess.fused_preprocess(x[0], roi, 2.0, 8.0)
    torch.testing.assert_close(single, want[0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape,with_bias", [
    ((1, 16, 64, 160), False), ((2, 8, 32, 80), True), ((1, 3, 7, 21), True),
    ((3, 1, 1, 1), False)])
def test_conv_kernel_matches_plain(dev, shape, with_bias):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((*shape, 32), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((32, 32, 3, 3, 3), generator=g, device=dev) * 0.05
    b = torch.randn((32,), generator=g, device=dev) if with_bias else None
    ops.reset_launch_counts()
    got = conv_k3.conv3d_k3(x, w, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["conv3d_k3"] == 1
    want = conv_k3.conv3d_k3_reference(x, w, b)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2e-3 * want.float().abs().max().item())


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((1, 2, 3, 4, 32), device=dev)
    w = torch.zeros((32, 32, 3, 3, 3), device=dev)
    with pytest.raises(ValueError):
        conv_k3.conv3d_k3(x, w)                       # float32 input
    with pytest.raises(ValueError):
        conv_k3.conv3d_k3(x.to(torch.bfloat16).transpose(2, 3), w)   # not contiguous
    raw = torch.zeros((1, 2, 3, 4, 5), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        preprocess.fused_preprocess_batch(raw, (0, 3, 0, 3, 0, 4), 0.0, 1.0)
    with pytest.raises(TypeError):
        preprocess.fused_preprocess_batch(raw.double(), (0, 2, 0, 3, 0, 4), 0.0, 1.0)


def test_module_launches_kernel_with_kept_weights(dev):
    """``TorchConv3d`` under inference_mode launches the kernel with its kept
    (27, 32, 32) weights, and refreshes them when the parameter changes."""
    from rtpose_tpu_torch.models.layers import TorchConv3d
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((1, 4, 8, 20, 32), generator=g, device=dev).to(torch.bfloat16)
    m = TorchConv3d(32, 32, bias=False, dtype="bfloat16").to(dev)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g, device=dev) * 0.05)
    ops.reset_launch_counts()
    with torch.inference_mode():
        a, b = m(x), m(x)
        assert ops.launch_counts()["conv3d_k3"] == 2
        assert m._prepared[2][0].shape == (27, 32, 32)
    with torch.no_grad():
        m.weight.mul_(-1.0)
    with torch.inference_mode():
        c = m(x)
    torch.cuda.synchronize()
    want = conv_k3.conv3d_k3_reference(x, m.weight)
    tol = dict(rtol=2.0 ** -7, atol=2e-3 * want.float().abs().max().item())
    torch.testing.assert_close(c.float(), want.float(), **tol)
    torch.testing.assert_close(a.float(), -want.float(), **tol)
    assert torch.equal(a, b)
