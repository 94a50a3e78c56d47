"""The trilinear resize's routes and arithmetic on the CPU: which calls the
kernel would take (``kernel_route``), the custom op a dispatch mode sees,
the plain version against the code it replaced, the launch plan, and a
model of the kernel's arithmetic (``kernel_reference``: the blend along x,
then y, then z in float32, the addend's and the slice's epilogues) held to
the plain version at every resize of the flagship's and the feat64 trunk's
forward.  The kernel itself runs only on the card (``test_torch_cuda.py``).
Imports no JAX.
"""

import os
import re

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from rtpose_tpu_torch import ops
from rtpose_tpu_torch.models.hrnet3d import HRNet3D, MODEL_CONFIGS, resize_calls
from rtpose_tpu_torch.ops import build
from rtpose_tpu_torch.ops import interpolate as rs

torch.set_num_threads(min(4, torch.get_num_threads()))

GRID = (16, 64, 160)


def _named(backbone_cfg):
    calls = resize_calls(backbone_cfg, GRID)
    stage = [f"fuse{k}" for k in range(len(calls) - 3)] + ["final1", "final2", "final3"]
    return list(zip(stage, calls))


FLAGSHIP = _named("hr_tiny_feat32_zyx_l4_in32")
PHASE = _named("hr_tiny_feat64_zyx_l4_in64")
CALLS = [pytest.param(*c, id=f"flagship-{n}") for n, c in FLAGSHIP] + \
        [pytest.param(*c, id=f"phase-{n}") for n, c in PHASE]


def _bf16(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 3).to(torch.bfloat16)


def _old_resize(x, size):
    """The resize as the port wrote it before the kernel."""
    if tuple(x.shape[1:4]) == tuple(size):
        return x
    out = F.interpolate(x.permute(0, 4, 1, 2, 3), size=tuple(size), mode="trilinear",
                        align_corners=True)
    return out.permute(0, 2, 3, 4, 1).contiguous()


def _bf16_ulps(got, want):
    """The largest |got - want| in bf16 ulps of ``want`` (the spacing at
    |want|, at least at 2^-8 of the largest |want|)."""
    w = want.float().abs()
    w = w.clamp_min(w.max().item() * 2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


class _Ops(TorchDispatchMode):
    """Records the operators that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_resize_calls_are_the_thirteen_of_a_forward():
    """``resize_calls`` lists a forward's resizes: 1, 3 and 6 in the fuses of
    stages 2-4, then the final fuse's 3, the widths the rows' own."""
    for calls, chans in ((FLAGSHIP, (32, 32, 64, 64)), (PHASE, (64, 64, 128, 128))):
        assert len(calls) == 13 and sum(add for _, (*_, add) in calls) == 10
        grids = [(16, 64, 160), (8, 32, 80), (4, 16, 40), (2, 8, 20)]
        assert [c for _, c in calls][:4] == [(grids[1], grids[0], chans[0], True),
                                             (grids[1], grids[0], chans[0], True),
                                             (grids[2], grids[0], chans[0], True),
                                             (grids[2], grids[1], chans[1], True)]
        assert [c for _, c in calls][-3:] == [(grids[j], grids[0], chans[j], False)
                                              for j in (1, 2, 3)]


@pytest.mark.parametrize("case", ["bf16", "float32", "float64", "c_not_8", "grad",
                                  "addend_grad", "strided", "same_size", "mode"])
def test_kernel_route_takes_the_plain_version_on_the_cpu(case):
    C = 12 if case == "c_not_8" else 16
    dtype = {"float32": torch.float32, "float64": torch.float64}.get(case, torch.bfloat16)
    x = _bf16((2, 3, 4, 5, C), 1).to(dtype)
    size = (3, 4, 5) if case == "same_size" else (5, 7, 9)
    a = _bf16((2, *size, C), 2).to(dtype)
    if case == "strided":
        x = _bf16((2, 3, 4, 5, 2 * C), 1)[..., ::2]
    if case == "grad":
        x.requires_grad_(True)
    if case == "addend_grad":
        a.requires_grad_(True)
    want = _old_resize(x, size) + a
    ops.reset_launch_counts()
    rs.reset()
    if case == "mode":
        with torch.no_grad(), _Ops() as rec:
            assert build.dispatch_mode_active()
            assert not rs.kernel_route(x, size, a)
            got = rs.resize_trilinear_align_corners(x, size, addend=a)
        assert "rtpose.resize_trilinear.default" in rec.names
    else:
        takes = case == "bf16"
        assert rs.kernel_takes(x, size, a) == takes
        assert not rs.kernel_route(x, size, a)
        got = rs.resize_trilinear_align_corners(x, size, addend=a)
        if case in ("grad", "addend_grad"):
            assert got.grad_fn is not None
            with torch.no_grad():
                assert rs.kernel_takes(x, size, a)
    assert got.dtype == dtype and torch.equal(got, want)
    assert rs.counts() == dict(kernel=0, plain=1)
    assert ops.launch_counts()["resize_trilinear"] == 0


def test_kernel_takes_checks_the_output_and_the_addend():
    x = _bf16((2, 3, 4, 5, 16), 3)
    size = (5, 7, 9)
    buf = torch.empty((2, *size, 48), dtype=torch.bfloat16)
    assert rs.kernel_takes(x, size, out=buf[..., 16:32])
    assert rs.kernel_takes(x, size, out=torch.empty((2, *size, 16), dtype=torch.bfloat16))
    assert not rs.kernel_takes(x, size, out=buf[..., 4:20])          # not 16-byte aligned
    assert not rs.kernel_takes(x, size, out=buf[..., ::3])           # channels not dense
    assert not rs.kernel_takes(x, size, out=buf[..., 16:32].float())
    assert not rs.kernel_takes(x, size, out=buf[:, :4, ..., 16:32])  # another shape
    assert not rs.kernel_takes(x, size, addend=buf[..., 16:32])      # not contiguous
    assert not rs.kernel_takes(x, size, addend=torch.empty((2, *size, 16)))
    # fewer than 2^31 elements in and out (meta tensors: no memory)
    big = torch.empty((1, 16, 64, 160, 16), dtype=torch.bfloat16, device="meta")
    assert rs.kernel_takes(big, (64, 256, 640))
    assert not rs.kernel_takes(big, (256, 512, 1280))
    # an input row wider than the shared memory a block may take
    wide = torch.empty((1, 2, 2, rs.SMEM_BYTES // 64 + 1, 8), dtype=torch.bfloat16,
                       device="meta")
    assert not rs.kernel_takes(wide, (3, 3, 3))


def test_slice_stride_reads_a_channel_slice_of_a_channels_last_buffer():
    buf = torch.empty((2, 3, 4, 5, 192), dtype=torch.bfloat16)
    assert rs._slice_stride(buf[..., 32:64]) == 192
    assert rs._slice_stride(buf) == 192
    assert rs._slice_stride(buf[..., :4]) == 192
    assert rs._slice_stride(buf[:, :, :2]) is None
    assert rs._slice_stride(buf.transpose(1, 2)) is None
    assert rs._slice_stride(buf[..., 1::2]) is None
    assert rs._slice_stride(buf[0]) is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_route_is_the_old_code_bit_for_bit(dtype):
    x = _bf16((2, 4, 8, 20, 32), 4).to(dtype)
    a = _bf16((2, 8, 16, 40, 32), 5).to(dtype)
    size = (8, 16, 40)
    old = _old_resize(x, size)
    assert torch.equal(rs.resize_reference(x, size), old)
    assert torch.equal(rs.resize_reference(x, size, addend=a), a + old)
    buf = torch.zeros((2, *size, 96), dtype=dtype)
    got = rs.resize_reference(x, size, out=buf[..., 32:64])
    assert torch.equal(buf[..., 32:64], old) and torch.equal(got, old)
    assert not buf[..., :32].any() and not buf[..., 64:].any()
    # the entry point on the CPU, and a resize to the same size
    assert torch.equal(rs.resize_trilinear_align_corners(x, size, addend=a), a + old)
    assert rs.resize_trilinear_align_corners(x, x.shape[1:4]) is x


def test_custom_op_cpu_is_the_plain_version_and_fakes_its_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode
    x = _bf16((2, 3, 5, 7, 64), 6)
    a = _bf16((2, 6, 10, 14, 64), 7)
    assert torch.equal(torch.ops.rtpose.resize_trilinear(x, [6, 10, 14], a),
                       a + _old_resize(x, (6, 10, 14)))
    with FakeTensorMode():
        out = torch.ops.rtpose.resize_trilinear(
            torch.empty((2, 3, 5, 7, 64), dtype=torch.bfloat16), [6, 10, 14], None)
    assert out.shape == (2, 6, 10, 14, 64) and out.dtype == torch.bfloat16


def test_dispatch_mode_writes_the_slice_through_the_custom_op():
    x = _bf16((1, 2, 4, 8, 16), 8)
    buf = torch.zeros((1, 4, 8, 16, 48), dtype=torch.bfloat16)
    with torch.no_grad(), _Ops() as rec:
        rs.resize_trilinear_align_corners(x, (4, 8, 16), out=buf[..., 16:32])
    assert "rtpose.resize_trilinear.default" in rec.names
    assert torch.equal(buf[..., 16:32], _old_resize(x, (4, 8, 16)))


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("zin,zout,C,add", CALLS)
def test_plan_covers_whole_rows_within_the_shared_memory(B, zin, zout, C, add):
    threads, rows, smem = rs.plan(B, zin, zout, C, 132)
    items = zout[2] * C // 8
    assert threads % 32 == 0 and threads <= rs.MAX_THREADS
    assert items % threads == 0 or threads >= items
    assert 1 <= rows <= zout[1] and smem <= rs.SMEM_BYTES
    # the input rows any block of `rows` output rows reads
    i0, i1, _, _ = rs._axis(zin[1], zout[1])
    span = max(int(i1[min(s + rows, zout[1]) - 1] - i0[s]) + 1 for s in range(0, zout[1], rows))
    assert smem == 2 * span * zin[2] * C * 2


def test_axis_is_atens_float32_arithmetic():
    """ATen's source index for align_corners: a float32 scale (in - 1) /
    (out - 1) times the output index, its floor, the next index clamped at
    the edge; the weights sum to one and the ends land on the ends."""
    for n_in, n_out in ((8, 16), (2, 16), (4, 16), (20, 160), (32, 64), (5, 1), (1, 7)):
        i0, i1, l0, l1 = rs._axis(n_in, n_out)
        assert i0.min() >= 0 and i1.max() <= n_in - 1 and (i1 - i0).max() <= 1
        assert (l0 + l1 == 1).all() and (l1 >= 0).all() and (l1 < 1).all()
        assert i0[0] == 0 and l1[0] == 0
        if n_out > 1:
            assert i0[-1] + l1[-1] == pytest.approx(n_in - 1, abs=1e-5)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("zin,zout,C,add", CALLS)
def test_kernel_model_within_one_ulp_of_the_plain_version(B, zin, zout, C, add):
    """The kernel's arithmetic against ``F.interpolate`` on the CPU: the same
    float32 value rounded once, the two sums a few float32 ulps apart, so
    at most one bf16 ulp, and nearly every element bit-equal."""
    x = _bf16((B, *zin, C), 9)
    got = rs.kernel_reference(x, zout)
    want = rs.resize_reference(x, zout)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_ulps(got, want) <= 1.0
    assert (got == want).float().mean().item() > 0.999


@pytest.mark.parametrize("zin,zout,C", [((8, 32, 80), GRID, 32), ((2, 8, 20), (4, 16, 40), 64),
                                         ((3, 5, 7), (5, 9, 13), 8)])
def test_kernel_model_epilogues_are_the_two_operations(zin, zout, C):
    """``bf16(addend + bf16(resize))``: the addend's epilogue equals the
    resize followed by the separate bf16 add it replaces, bit for bit (in
    either order of the terms)."""
    x, a = _bf16((2, *zin, C), 10), _bf16((2, *zout, C), 11)
    r = rs.kernel_reference(x, zout)
    got = rs.kernel_reference(x, zout, addend=a)
    assert torch.equal(got, a + r) and torch.equal(got, r + a)


def _parent_forward(model, x):
    """``HRNet3D.forward`` as the parent wrote it (the fuse's sum as
    separate adds, the final fuse a ``torch.cat``), on the same modules."""
    x = x.to(model.dtype)
    net = model.backbone
    y_list = [net.layer1(x)]
    for k, sname in enumerate(net.stage_names, start=1):
        trans, n_pre = getattr(net, f"transition{k}"), len(y_list)
        x_list = [(y_list[i] if layer is None else layer(y_list[-1])) if i < n_pre
                  else layer(y_list[-1]) for i, layer in enumerate(trans)]
        for hrm in getattr(net, sname):
            feats = [branch(h) for branch, h in zip(hrm.branches, x_list)]
            out = []
            for i, row in enumerate(hrm.fuse_layers):
                y = feats[0] if i == 0 else row[0](feats[0])
                for j in range(1, hrm.num_branches):
                    if j == i:
                        y = y + feats[j]
                    elif j > i:
                        y = y + _old_resize(row[j](feats[j]), feats[i].shape[1:4])
                    else:
                        y = y + row[j](feats[j])
                out.append(torch.relu(y))
            x_list = out
        y_list = x_list
    top = y_list[0]
    cat = torch.cat([top, *(_old_resize(f, top.shape[1:4]) for f in y_list[1:])], dim=-1)
    return model.final_conv(cat)


@pytest.mark.parametrize("cfg,cin,dtype", [("hr_tiny_feat32_zyx_l4_in32", 32, "bfloat16"),
                                           ("hr_tiny_feat64_zyx_l4_in64", 64, "bfloat16"),
                                           ("hr_tiny_feat16_zyx_l4", 16, "float32")])
def test_hrnet3d_on_the_cpu_equals_the_parents_forward(cfg, cin, dtype):
    """The fuse's adds moved into the resize's call and the final concat
    written slice by slice leave the CPU forward bit-equal; a forward counts
    13 resizes on the plain route and launches nothing; the gradient flows
    through the concat's slices as through ``torch.cat``."""
    from rtpose_tpu_torch.models import init_weights
    chans = MODEL_CONFIGS[cfg]["stage4"]["num_channels"]
    model = init_weights(HRNet3D(cfg, final_conv_in=sum(chans), dtype=dtype, in_channels=cin),
                         torch.Generator().manual_seed(12))
    x = torch.randn((2, 8, 16, 32, cin), generator=torch.Generator().manual_seed(13))
    rs.reset()
    ops.reset_launch_counts()
    with torch.no_grad():
        got = model(x)
        assert rs.counts() == dict(kernel=0, plain=13)
        want = _parent_forward(model, x)
    assert got.shape == (2, 8, 16, 32, 128) and torch.equal(got, want)
    assert ops.launch_counts()["resize_trilinear"] == 0
    xg = x.clone().requires_grad_(True)
    model(xg).float().square().mean().backward()
    g_new, xg.grad = xg.grad, None
    _parent_forward(model, xg).float().square().mean().backward()
    assert torch.equal(g_new, xg.grad)


def _c_signature(src):
    """The argument kinds of a source's ``extern "C"`` function: p (pointer)
    or i (int) or f (float)."""
    text = open(os.path.join(build.CSRC_DIR, src)).read()
    args = re.search(r'extern "C" int \w+\(([^)]*)\)', text).group(1)
    kinds = []
    for a in args.split(","):
        a = a.strip()
        kinds.append("p" if "*" in a else "f" if a.startswith("float") else "i")
    return kinds


@pytest.mark.parametrize("library", sorted(build.KERNELS))
def test_kernel_argtypes_match_the_c_signature(library):
    """Each library's ctypes argument types (``build.KERNELS``) name its C
    function's arguments one for one: a pointer, an int or a float."""
    src, _, argtypes, _ = build.KERNELS[library]
    kind = {build._P: "p", build._I: "i", build._F: "f"}
    assert [kind[t] for t in argtypes] == _c_signature(src)
