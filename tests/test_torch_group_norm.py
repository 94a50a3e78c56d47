"""The GroupNorm kernel's route and arithmetic on the CPU: which calls the
kernel would take (``kernel_route``), the custom op a dispatch mode sees,
the launch plan, and a model of the kernel's statistics (chunk moments
merged with Chan's formula in the apply pass's order, then x * scale +
shift) held to the plain version.  The kernel itself runs only
on the card (``test_torch_cuda.py``).  Imports no JAX.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rtpose_tpu_torch import ops
from rtpose_tpu_torch.models import GroupNorm8
from rtpose_tpu_torch.ops import build
from rtpose_tpu_torch.ops import group_norm as gn

torch.set_num_threads(min(4, torch.get_num_threads()))

# the flagship trunk's GroupNorm inputs a frame: (Z, Y, X), C
TRUNK_SHAPES = [((16, 64, 160), 32), ((8, 32, 80), 32), ((4, 16, 40), 64), ((4, 16, 40), 32),
                ((2, 8, 20), 64)]


def _affine(C, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(C, generator=g), torch.randn(C, generator=g)


class _Ops(TorchDispatchMode):
    """Records the operators that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["cpu", "float64", "float32", "grad", "c_not_8", "mode"])
def test_kernel_route_takes_the_plain_version(case):
    C = 12 if case == "c_not_8" else 32
    m = GroupNorm8(C)
    dtype = {"float64": torch.float64, "float32": torch.float32}.get(case, torch.bfloat16)
    x = torch.randn(2, 3, 4, 5, C).to(dtype)
    ops.reset_launch_counts()
    want = gn.group_norm_reference(x, m.weight, m.bias, m.groups, m.eps)
    if case == "mode":
        with torch.no_grad(), _Ops() as rec:
            assert build.dispatch_mode_active()
            assert not gn.kernel_route(x, m.weight, m.bias, m.groups)
            got = m(x)
        assert "rtpose.group_norm.default" in rec.names
    elif case == "grad":
        assert not gn.kernel_takes(x, m.weight, m.bias, m.groups)
        got = m(x)
        assert got.grad_fn is not None
    else:
        with torch.no_grad():
            assert gn.kernel_takes(x, m.weight, m.bias, m.groups) == (case == "cpu")
            assert not gn.kernel_route(x, m.weight, m.bias, m.groups)
            got = m(x)
    assert got.dtype == dtype and torch.equal(got, want)
    assert ops.launch_counts()["group_norm"] == 0


def test_custom_op_cpu_is_the_plain_version_and_fakes_its_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode
    x = torch.randn(2, 3, 5, 7, 64).to(torch.bfloat16)
    w, b = _affine(64, 1)
    assert torch.equal(torch.ops.rtpose.group_norm(x, w, b, 8, 1e-5),
                       gn.group_norm_reference(x, w, b, 8, 1e-5))
    with FakeTensorMode():
        out = torch.ops.rtpose.group_norm(torch.empty((2, 3, 5, 7, 64), dtype=torch.bfloat16),
                                          torch.empty(64), torch.empty(64), 8, 1e-5)
    assert out.shape == (2, 3, 5, 7, 64) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("zyx,C", TRUNK_SHAPES + [((16, 64, 160), 128)])
def test_plan_fills_the_card_with_whole_sweeps(B, zyx, C):
    S = zyx[0] * zyx[1] * zyx[2]
    chunks, rows = gn.plan(B, S, C, 132)
    sweep = gn.THREADS // (C // 8)
    assert rows % sweep == 0 and (chunks - 1) * rows < S <= chunks * rows
    assert B * chunks <= gn.BLOCKS_PER_SM * 132 + B
    if S >= gn.MIN_SWEEPS * sweep * gn.BLOCKS_PER_SM * 132:   # enough rows to fill the card
        assert B * chunks >= 132


@pytest.mark.parametrize("shape,sms", [((2, 3, 5, 7, 32), 3), ((1, 8, 32, 40, 32), 132),
                                       ((3, 4, 6, 10, 128), 5), ((2, 9, 24), 2),
                                       ((1, 2, 8, 20, 64), 132), ((8, 2, 8, 20, 64), 132)])
def test_kernel_statistics_model_matches_plain_float32(shape, sms):
    """The kernel's order of work in float32 within 1e-6 of ``GroupNorm8``
    taken in float64.  (``GroupNorm8``'s own float32 version is not held
    there: its means over 40,960 values at (1, 8, 32, 40), where the model
    passes more than 32 chunks, drift by ~3e-5.)"""
    C = shape[-1]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(shape, generator=g) * 3 + 1
    m = GroupNorm8(C)
    with torch.no_grad():
        m.weight.copy_(_affine(C, 3)[0])
        m.bias.copy_(_affine(C, 3)[1])
        exact = m.double()(x.double())
        got = gn.kernel_reference(x, m.weight, m.bias, m.groups, m.eps, sms)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), exact, rtol=1e-6, atol=1e-6)
