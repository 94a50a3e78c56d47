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
from torch.utils.flop_counter import FlopCounterMode

from rtpose_tpu_torch import ops
from rtpose_tpu_torch.models.layers import TorchConv3d
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


def _conv(co=32, stride=1, dtype="bfloat16", device="cpu", w=None):
    m = TorchConv3d(32, co, stride=stride, bias=False, dtype=dtype)
    if w is not None:
        with torch.no_grad():
            m.weight.copy_(w)
    return m.to(device)


def test_dispatch_rule():
    """``TorchConv3d``: bf16, kernel 3, stride 1, 32 -> 32 goes to K3, with
    and without grad (the plain version on the CPU, launching nothing; the
    kernel or an error elsewhere); other shapes to F.conv3d."""
    _, _, _, xt, wt = _case(B=1, Z=3, Y=5, X=6, seed=2)
    want = _f32(conv_k3.conv3d_k3_reference(xt, wt))
    m = _conv(w=wt)
    ops.reset_launch_counts()
    with torch.no_grad():
        np.testing.assert_array_equal(_f32(m(xt)), want)
    np.testing.assert_array_equal(_f32(m(xt).detach()), want)      # Conv3dK3
    assert not any(ops.launch_counts().values())
    meta = torch.empty(xt.shape, dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            _conv(device="meta")(meta)
        # not the kernel's shape: stride 2, f32, other channel counts -> F.conv3d
        assert _conv(stride=2, device="meta")(meta).shape == (1, 2, 3, 3, 32)
        assert _conv(dtype=None, device="meta")(meta.float()).shape == meta.shape
        assert _conv(co=16, device="meta")(meta).shape == (1, 3, 5, 6, 16)


def test_torchconv3d_reaches_the_custom_op_only_under_a_dispatch_mode():
    """Under a ``TorchDispatchMode`` (``FlopCounterMode``) a no-grad K3 conv
    goes through ``torch.ops.rtpose.conv3d_k3``, which the mode counts;
    outside one it takes the plain version and the op is not called; the
    two outputs are bit-equal."""
    _, _, _, xt, wt = _case(B=1, Z=3, Y=5, X=6, seed=6)
    m = _conv(w=wt)
    with torch.no_grad():
        with FlopCounterMode(display=False) as counter:
            under = m(xt)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            outside = m(xt)
    assert set(counter.get_flop_counts()["Global"]) == {torch.ops.rtpose.conv3d_k3}
    names = {e.name for e in prof.events()}
    assert "rtpose::conv3d_k3" not in names and "aten::convolution" in names, names
    assert torch.equal(under, outside)


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


def _unprepare(wr):
    """The kernel's (9, 4, 3, 32, 8) weights back to torch layout (Co, Ci, 3, 3, 3)."""
    return wr.permute(0, 1, 4, 2, 3).reshape(3, 3, 32, 3, 32).permute(4, 2, 3, 0, 1)


def test_prepare_lays_weights_out_for_the_kernel():
    """``prepare`` gives the kernel's (9, 4, 3, 32, 8)
    [dy * 3 + dx][ci // 8][dz][co][ci % 8] bf16 weights and float32 bias;
    unpacking them gives back the torch weights, and ``prepare_flipped``'s
    give back ``flip_transpose``; ``launch`` on a CPU tensor is the plain
    version on them."""
    _, _, b, xt, wt = _case(B=1, Z=3, Y=5, X=6, seed=5)
    wr, br = conv_k3.prepare(wt, torch.from_numpy(b))
    assert wr.shape == (9, 4, 3, 32, 8) and wr.dtype == torch.bfloat16 and wr.is_contiguous()
    assert br.dtype == torch.float32
    # (kz, ky, kx) = (1, 2, 0), ci = 8 * 2 + 5, co = 7
    assert wr[2 * 3 + 0, 2, 1, 7, 5].item() == wt[7, 21, 1, 2, 0].to(torch.bfloat16).item()
    np.testing.assert_array_equal(_f32(_unprepare(wr)), _f32(wt.to(torch.bfloat16)))
    wf = conv_k3.prepare_flipped(wt)
    assert wf.shape == (9, 4, 3, 32, 8) and wf.is_contiguous()
    np.testing.assert_array_equal(_f32(_unprepare(wf)),
                                  _f32(conv_k3.flip_transpose(wt).to(torch.bfloat16)))
    assert torch.equal(conv_k3.launch(xt, wr, br),
                       conv_k3.conv3d_k3_reference(xt, wt, torch.from_numpy(b)))


# the main path's shapes (eval B=1, training B=8, full and half resolution)
# and the ragged and degenerate shapes the card tests run
PLAN_SHAPES = [(1, 16, 64, 160), (1, 8, 32, 80), (8, 16, 64, 160), (8, 8, 32, 80),
               (2, 5, 13, 37), (3, 1, 1, 1), (1, 3, 7, 21), (2, 8, 32, 80),
               (1, 70000, 2, 3), (1, 2, 300, 300)]


def _segments(p, Z):
    """The (block, b, x0, y0, za, zb, plo, phi) runs each block walks, as
    the kernel's ``segment_at`` cuts its contiguous range of tile-planes."""
    for blk, col, za, zb in conv_k3.segments(p.tiles, p.grid, Z):
        t, ix = divmod(col, p.nx)
        b, iy = divmod(t, p.ny)
        yield blk, b, ix * p.tx, iy * p.ty, za, zb, max(za - 1, 0), min(zb, Z - 1)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_output_once_and_fits(shape):
    """The launch plan's tile-planes, cut into one contiguous range per
    block, write every output voxel exactly once; the tile fits its wgmma
    blocks, the last block's taps stay inside a stage, the TMA box is at
    most 256 wide, and weights + ring + barriers fit in 227 KB."""
    B, Z, Y, X = shape
    p = conv_k3.plan(B, Z, Y, X, sms=132)
    assert p.wp == p.tx + 2 and p.nbw in (1, 2) and conv_k3.MIN_STAGES <= p.stages <= conv_k3.MAX_STAGES
    rows = 2 * p.nbw * 64
    assert p.ty * p.wp <= rows and p.wp <= 256 and p.ty + 2 <= 256
    assert p.positions % 8 == 0 and p.positions >= (p.ty + 2) * p.wp
    assert p.positions >= rows + 2 * p.wp + 2          # max position read is rows + 2 wp + 1
    assert p.smem == conv_k3.WEIGHT_BYTES + p.stages * 64 * p.positions + 8 * (2 * p.stages + 3)
    assert p.smem <= conv_k3.SMEM_LIMIT
    assert p.nx == -(-X // p.tx) and p.ny == -(-Y // p.ty) and p.tiles == B * p.ny * p.nx * Z
    assert p.grid == min(132, p.tiles)
    planes = [0] * p.grid
    for blk, *_, za, zb, plo, phi in _segments(p, Z):
        assert 0 <= plo <= za < zb <= Z and zb - 1 <= phi <= Z - 1
        planes[blk] += phi - plo + 1
    assert max(planes) == p.max_planes
    if Z > 1000:                                        # count tile-planes, not voxels
        assert sum(zb - za for *_, za, zb, _, _ in _segments(p, Z)) == p.tiles
        return
    count = np.zeros((B, Z, Y, X), np.int32)
    for _, b, x0, y0, za, zb, plo, phi in _segments(p, Z):
        count[b, za:zb, y0:y0 + p.ty, x0:x0 + p.tx] += 1
    assert (count == 1).all()


def test_plan_main_path_shapes():
    """At the flagship shapes the plan fills the card, one range per SM,
    and the busiest block reads at most two input planes per output plane
    of the average block (each run of a column reads its two neighbour
    planes too); the training batch at full resolution takes four 64-row
    blocks a tile."""
    for shape in [(1, 16, 64, 160), (8, 16, 64, 160), (8, 8, 32, 80)]:
        p = conv_k3.plan(*shape, sms=132)
        assert p.grid == 132
        assert p.max_planes <= 2 * -(-p.tiles // p.grid)
    assert conv_k3.plan(8, 16, 64, 160, sms=132).nbw == 2


def _emulate_kernel(x, wr, bias, p):
    """The kernel's arithmetic and addressing in float32 torch: for each
    block's runs of a column, stages laid out as the TMA writes them
    ([c8][position][8 channels], zeros outside the volume, the slack
    positions past the box left as garbage); for input plane p and tap
    (dy, dx), K-step ks, the A operand read at flat position offset
    dy * wp + dx of c8 planes 2 ks and 2 ks + 1, the B operand the
    prepared [tap][c8][dz][co][8] weights as 96 columns (dz, co); columns
    of dz 0, 1, 2 added into the running sums of outputs p + 1, p, p - 1 in
    three rotating sets; output p - 1 stored after plane p when it is the
    run's, output Z - 1 after the last plane; valid rows only."""
    B, Z, Y, X, _ = x.shape
    xf = x.float()
    wf = wr.float()                                    # (9, 4, 3, 32, 8)
    out = torch.full(x.shape, float("nan"))
    rows = 2 * p.nbw * 64
    m = torch.arange(rows)
    ty, tx = m // p.wp, m % p.wp
    valid = (ty < p.ty) & (tx < p.tx)
    hy = p.ty + 2

    def store(b, x0, y0, z, acc):
        acc = acc + (0 if bias is None else bias.float())
        yy, xx = y0 + ty[valid], x0 + tx[valid]
        keep = (yy < Y) & (xx < X)
        out[b, z, yy[keep], xx[keep]] = acc[valid][keep]

    for _, b, x0, y0, za, zb, plo, phi in _segments(p, Z):
        sets = torch.zeros(3, rows, 32)
        for pz in range(plo, phi + 1):
            s = torch.full((4, p.positions, 8), 1e30)   # garbage beyond the box
            box = torch.zeros(hy, p.wp, 32)
            ys = slice(max(y0 - 1, 0), min(y0 - 1 + hy, Y))
            xs = slice(max(x0 - 1, 0), min(x0 - 1 + p.wp, X))
            box[ys.start - (y0 - 1):ys.stop - (y0 - 1),
                xs.start - (x0 - 1):xs.stop - (x0 - 1)] = xf[b, pz, ys, xs]
            s[:, :hy * p.wp] = box.reshape(hy * p.wp, 4, 8).transpose(0, 1)
            r = (pz - plo) % 3
            for dy in range(3):
                for dx in range(3):
                    off = dy * p.wp + dx
                    for ks in range(2):
                        a = torch.cat([s[2 * ks + k, off:off + rows] for k in (0, 1)],
                                      dim=1)            # (rows, 16): ci 16 ks .. 16 ks + 15
                        bm = torch.cat([wf[dy * 3 + dx, 2 * ks + k].reshape(96, 8)
                                        for k in (0, 1)], dim=1)   # (96 = (dz, co), 16)
                        d = a @ bm.T
                        sets[(r + 1) % 3] += d[:, :32]
                        sets[r] += d[:, 32:64]
                        sets[(r + 2) % 3] += d[:, 64:]
            if za <= pz - 1 < zb:
                store(b, x0, y0, pz - 1, sets[(r + 2) % 3])
            sets[(r + 2) % 3] = 0
        if zb == Z:
            store(b, x0, y0, Z - 1, sets[(Z - 1 - plo) % 3])
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("shape,with_bias", [((2, 5, 13, 37), True), ((1, 3, 7, 21), False),
                                             ((3, 1, 1, 1), True), ((1, 4, 9, 70), False)])
def test_kernel_indexing_emulation_matches_reference(shape, with_bias):
    """The emulated kernel (``_emulate_kernel``, its launch plan with a
    small SM count so blocks split columns along z) matches the plain
    version at ragged shapes: the padded-row shifted-tap GEMM over the
    prepared weights, with dz folded into N, is the conv."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(*shape, 32)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(32, 32, 3, 3, 3)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32)) if with_bias else None
    wr, br = conv_k3.prepare(w, b)
    p = conv_k3.plan(*shape, sms=7)
    got = _emulate_kernel(x, wr, br, p).float()
    want = conv_k3.conv3d_k3_reference(x, w, b).float()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=BF16_ULP,
                               atol=2e-3 * want.abs().max().item())
