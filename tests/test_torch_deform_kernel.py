"""The deformable conv's two routes on the CPU: a CPU call takes the plain
route (no kernel launch, its chunks counted); the kernel's weight layout
(``prepare``); and the kernel's arithmetic in stock ops
(``kernel_reference``: float32 sampling, one rounding of each column to
bf16, float32 contraction) is no further from the float32 function than
the plain bf16 route.  The kernel itself runs only on the card
(``test_torch_cuda.py``).  Imports no JAX.
"""

import pytest
import torch

from rtpose_tpu_torch import ops
from rtpose_tpu_torch.ops import deform_conv as dc


def _inputs(B, H, W, C, Cout, dg, offsets, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g).to(torch.bfloat16)
    if offsets == "conv":     # as the deformable head's 1x1 offset conv gives them
        off = x.float() @ (torch.randn(C, dg * 18, generator=g) * 0.05)
    elif offsets == "edge":   # samples exactly on -1, H, W and half a pixel off them
        off = (torch.randint(-8, 9, (B, H, W, dg * 18), generator=g)
               + 0.5 * torch.randint(0, 2, (B, H, W, dg * 18), generator=g)).float()
    else:                     # uniform in +-offsets pixels
        off = (torch.rand(B, H, W, dg * 18, generator=g) * 2 - 1) * offsets
    w = (torch.randn(3, 3, C, Cout, generator=g) / (9 * C) ** 0.5).to(torch.bfloat16)
    return x, off, w


def test_cpu_call_takes_the_plain_route():
    x, off, w = _inputs(2, 5, 7, 64, 128, 2, 3.0)
    dc.reset()
    ops.reset_launch_counts()
    assert not dc.kernel_route(x, off, w, None, None, 1, 1, 2)
    with torch.inference_mode():
        dc.deform_conv2d(x, off, w, deformable_groups=2)
    assert dc.counts() == dict(calls=1, chunks=1, samples=2 * 5 * 7 * 9 * 2,
                               column_elems=2 * 5 * 7 * 9 * 64)
    assert ops.launch_counts()["deform_conv2d"] == 0


@pytest.mark.parametrize("C,Cout", [(64, 128), (128, 128), (256, 256)])
def test_prepare_lays_out_one_step_per_row(C, Cout):
    w = torch.randn(3, 3, C, Cout)
    wr = dc.prepare(w)
    assert tuple(wr.shape) == (9, C // 64, Cout, 64) and wr.is_contiguous()
    tap, q, co, j = torch.meshgrid(*(torch.arange(n) for n in wr.shape), indexing="ij")
    assert torch.equal(wr, w[tap // 3, tap % 3, 64 * q + j, co])


@pytest.mark.parametrize("offsets", ["conv", 6.0, "edge", 40.0])
@pytest.mark.parametrize("shape", [(2, 9, 13, 128, 128, 4), (3, 7, 11, 64, 128, 8)])
def test_kernel_arithmetic_is_no_coarser_than_the_plain_route(shape, offsets):
    B, H, W, C, Cout, dg = shape
    x, off, w = _inputs(B, H, W, C, Cout, dg, offsets)
    with torch.inference_mode():
        want = dc.deform_conv2d(x.float(), off, w.float(), deformable_groups=dg)
        plain = dc.deform_conv2d(x, off, w, deformable_groups=dg)
        fused = dc.kernel_reference(x, off, w, 1, dg)
    assert fused.dtype == plain.dtype == torch.bfloat16
    ef, ep = (fused.float() - want).abs(), (plain.float() - want).abs()
    assert ef.max() <= ep.max() and ef.mean() <= ep.mean()
