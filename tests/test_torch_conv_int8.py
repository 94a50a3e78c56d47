"""The int8 K3 conv (``rtpose_tpu_torch/ops/conv_k3_int8.py``) on the CPU:
its launch plan, its prepared weight layout, and an emulation of the
kernel's addressing (``_emulate_kernel_int8``) against the plain version
and against the JAX package's int8 conv (``rtpose_tpu/ops/quant.py``).

Tolerances: none for the integers and the port's outputs.  The emulation
sums int8 products exactly in int64, as the kernel does in int32, and its
epilogue is the plain version's float32 operations, so it is held bit for
bit (``torch.equal``) to ``conv3d_k3_int8_reference``, and its integer
sums equal JAX's int32 accumulators.  The dequantized float32 output
against JAX's ``conv3d_int8``: one float32 ulp (each package rounds its
own weight scales and their product with the activation scale; XLA may
contract the epilogue into one FMA)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtpose_tpu.ops import quant as jq
from rtpose_tpu_torch.ops import conv_k3
from rtpose_tpu_torch.ops import conv_k3_int8 as ck8
from rtpose_tpu_torch.ops import library  # noqa: F401  (registers torch.ops.rtpose)
from rtpose_tpu_torch.ops import quant


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs six workers at once: keep this file's CPU work to two
    threads, as the other port test files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _int8(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(-128, 128, size=shape)
                            .astype(np.int8))


def _case(shape, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    xq = _int8((*shape, 32), seed)
    wq = _int8((32, 32, 3, 3, 3), seed + 1).clamp(-127, 127)
    scale = torch.from_numpy((rng.random(32) * 1e-3).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=32).astype(np.float32)) if with_bias else None
    return xq, wq, scale, b


# ------------------------------------------------------------ weight layout

# the wgmma's accumulator layout: thread t holds columns 8 g + 2 (t % 4) + e
# of each 32-column group, and the kernel's epilogue stores them as
# channels 8 (t % 4) + 2 g + e: column n holds this output channel
KERNEL_CHANNEL = [8 * ((n // 2) % 4) + 2 * (n // 8) + n % 2 for n in range(32)]


def test_prepare_roundtrip_and_layout():
    """``prepare`` lays (Co, Ci, kz, ky, kx) out as [ky * 3 + kx][ci // 16]
    [kz][n][ci % 16], row n the weights of the channel the kernel's
    epilogue stores from accumulator column n; ``unprepare`` gives the
    weights back."""
    wq = _int8((32, 32, 3, 3, 3), 3)
    wk = ck8.prepare(wq)
    assert tuple(wk.shape) == ck8.PREPARED_SHAPE == (9, 2, 3, 32, 16)
    assert wk.dtype == torch.int8 and wk.is_contiguous()
    assert list(ck8.N_CHANNEL) == KERNEL_CHANNEL
    # (kz, ky, kx) = (2, 0, 1), ci = 16 + 5, co = 13 = 8 * 1 + 2 * 2 + 1: column 8 * 2 + 2 + 1
    assert wk[0 * 3 + 1, 1, 2, 19, 5].item() == wq[13, 21, 2, 0, 1].item()
    assert torch.equal(ck8.unprepare(wk), wq)


@pytest.mark.parametrize("old", [(27, 32, 32), (9, 4, 3, 32, 8)])
def test_other_prepared_layouts_refused(old):
    """A prepared weight of another layout (the (27, 32, 32) of earlier
    artifacts, or the bf16 kernel's shape) raises wherever a prepared
    weight enters: ``unprepare``, ``launch``, the custom op on the CPU and
    its fake implementation."""
    xq, wq, scale, _ = _case((1, 2, 3, 4), False)
    wk = torch.zeros(old, dtype=torch.int8)
    with pytest.raises(ValueError, match="prepared"):
        ck8.unprepare(wk)
    with pytest.raises(ValueError, match="prepared"):
        ck8.launch(xq, wk, scale)
    with pytest.raises(ValueError, match="prepared"):
        torch.ops.rtpose.conv3d_k3_int8(xq, wk, scale, None, torch.bfloat16)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), pytest.raises(ValueError, match="prepared"):
        torch.ops.rtpose.conv3d_k3_int8(torch.empty((1, 2, 3, 4, 32), dtype=torch.int8),
                                        torch.empty(old, dtype=torch.int8), torch.empty(32),
                                        None, torch.bfloat16)


def test_launch_takes_only_cuda_tensors():
    """The kernel takes only CUDA tensors: ``launch`` runs the plain version
    on a CPU tensor and refuses any other device."""
    xq, wq, scale, _ = _case((1, 2, 3, 4), False)
    wk = ck8.prepare(wq)
    assert torch.equal(ck8.launch(xq, wk, scale), ck8.conv3d_k3_int8_reference(xq, wq, scale))
    with pytest.raises(ValueError, match="CUDA"):
        ck8.launch(xq.to("meta"), wk.to("meta"), scale.to("meta"))


# ------------------------------------------------------------ launch plan

# the main path's shapes (eval B=1, serving B=8, full and half resolution),
# the ragged and degenerate ones the card runs, and small Y / X
PLAN_SHAPES = [(1, 16, 64, 160), (1, 8, 32, 80), (8, 16, 64, 160), (8, 8, 32, 80),
               (2, 5, 13, 37), (3, 1, 1, 1), (1, 3, 7, 21), (1, 70000, 2, 3),
               (2, 3, 2, 5), (1, 4, 1, 200), (1, 2, 300, 300), (32, 16, 64, 160)]


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
    p = ck8.plan(B, Z, Y, X, sms=132)
    assert p.wp == p.tx + 2 and p.nbw in (1, 2)
    assert conv_k3.MIN_STAGES <= p.stages <= conv_k3.MAX_STAGES
    rows = 2 * p.nbw * 64
    assert p.ty * p.wp <= rows and p.wp <= 256 and p.ty + 2 <= 256
    assert p.positions % 8 == 0 and p.positions >= (p.ty + 2) * p.wp
    assert p.positions >= rows + 2 * p.wp + 2          # max position read is rows + 2 wp + 1
    assert p.smem == ck8.WEIGHT_SMEM + p.stages * 32 * p.positions + 8 * (2 * p.stages + 5)
    assert p.smem <= conv_k3.SMEM_LIMIT
    assert p.nx == -(-X // p.tx) and p.ny == -(-Y // p.ty) and p.tiles == B * p.ny * p.nx * Z
    assert p.grid == min(132, p.tiles)
    planes = [0] * p.grid
    for blk, *_, za, zb, plo, phi in _segments(p, Z):
        assert 0 <= plo <= za < zb <= Z and zb - 1 <= phi <= Z - 1
        planes[blk] += phi - plo + 1
    assert max(planes) == p.max_planes
    if B * Z * Y * X > 2_000_000:                       # count tile-planes, not voxels
        assert sum(zb - za for *_, za, zb, _, _ in _segments(p, Z)) == p.tiles
        return
    count = np.zeros((B, Z, Y, X), np.int32)
    for _, b, x0, y0, za, zb, plo, phi in _segments(p, Z):
        count[b, za:zb, y0:y0 + p.ty, x0:x0 + p.tx] += 1
    assert (count == 1).all()


def test_plan_main_path_shapes():
    """At the flagship shapes the plan fills the card, one range per SM,
    and the busiest block reads at most two input planes per output plane
    of the average block; every candidate it chose from fits."""
    for shape in [(1, 16, 64, 160), (8, 16, 64, 160), (8, 8, 32, 80)]:
        p = ck8.plan(*shape, sms=132)
        assert p.grid == 132
        assert p.max_planes <= 2 * -(-p.tiles // p.grid)
        found = ck8.candidates(*shape, 132)
        assert p in [c[1] for c in found] and all(c[1].smem <= conv_k3.SMEM_LIMIT for c in found)


# ------------------------------------------------------------ kernel emulation

GARBAGE = 77    # what a stage holds past the TMA box: read only by dropped rows


def _emulate_kernel_int8(xq, wk, scale, bias, p, out_dtype):
    """The kernel's addressing in int64 torch, then its epilogue.  For each
    block's runs of a column: stages laid out as the TMA writes them
    ([c16][position][16 channels], zeros outside the volume, the slack
    positions past the box garbage); for input plane p and tap (dy, dx),
    the A operand read at flat position offset dy * wp + dx of both c16
    planes (one K-step of 32 channels), the B operand the prepared
    [tap][c16][dz][n][16] weights as 96 columns (dz, n), column n stored
    as channel ``KERNEL_CHANNEL[n]``; columns of dz 0, 1, 2 added into the
    running sums of outputs p + 1, p, p - 1 in three rotating sets; output
    p - 1 stored after plane p when it is the run's, output Z - 1 after the
    last plane; valid rows only.  Returns the int64
    sums and ``float32(acc) * scale (+ bias)`` in ``out_dtype``, and checks
    that every output voxel was stored exactly once."""
    B, Z, Y, X, _ = xq.shape
    xi, wi = xq.long(), wk.long()                      # wi: (9, 2, 3, 32, 16)
    acc_out = torch.zeros((B, Z, Y, X, 32), dtype=torch.int64)
    stored = torch.zeros((B, Z, Y, X), dtype=torch.int64)
    rows = 2 * p.nbw * 64
    m = torch.arange(rows)
    ty, tx = m // p.wp, m % p.wp
    valid = (ty < p.ty) & (tx < p.tx)
    hy = p.ty + 2

    def store(b, x0, y0, z, acc):
        yy, xx = y0 + ty[valid], x0 + tx[valid]
        keep = (yy < Y) & (xx < X)
        acc_out[b, z, yy[keep], xx[keep]] = acc[valid][keep]
        stored[b, z, yy[keep], xx[keep]] += 1

    for _, b, x0, y0, za, zb, plo, phi in _segments(p, Z):
        sets = torch.zeros((3, rows, 32), dtype=torch.int64)
        for pz in range(plo, phi + 1):
            s = torch.full((2, p.positions, 16), GARBAGE, dtype=torch.int64)
            box = torch.zeros((hy, p.wp, 32), dtype=torch.int64)
            ys = slice(max(y0 - 1, 0), min(y0 - 1 + hy, Y))
            xs = slice(max(x0 - 1, 0), min(x0 - 1 + p.wp, X))
            box[ys.start - (y0 - 1):ys.stop - (y0 - 1),
                xs.start - (x0 - 1):xs.stop - (x0 - 1)] = xi[b, pz, ys, xs]
            s[:, :hy * p.wp] = box.reshape(hy * p.wp, 2, 16).transpose(0, 1)
            r = (pz - plo) % 3
            for dy in range(3):
                for dx in range(3):
                    off = dy * p.wp + dx
                    a = torch.cat([s[k, off:off + rows] for k in (0, 1)], dim=1)  # (rows, ci)
                    bm = torch.cat([wi[dy * 3 + dx, k].reshape(96, 16) for k in (0, 1)],
                                   dim=1)                # (96 = (dz, co), ci)
                    d = (a @ bm.T).reshape(rows, 3, 32)[:, :, KERNEL_CHANNEL].reshape(rows, 96)
                    sets[(r + 1) % 3] += d[:, :32]
                    sets[r] += d[:, 32:64]
                    sets[(r + 2) % 3] += d[:, 64:]
            if za <= pz - 1 < zb:
                store(b, x0, y0, pz - 1, sets[(r + 2) % 3])
            sets[(r + 2) % 3] = 0
        if zb == Z:
            store(b, x0, y0, Z - 1, sets[(Z - 1 - plo) % 3])
    assert (stored == 1).all()
    assert acc_out.abs().max() < 2 ** 24               # float32(acc) exact, as in the kernel
    out = acc_out.to(torch.int32).float() * scale
    if bias is not None:
        out = out + bias
    return acc_out, out.to(out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,with_bias", [
    ((2, 5, 13, 37), True), ((1, 3, 7, 21), False), ((3, 1, 1, 1), True),
    ((1, 4, 9, 70), False), ((2, 3, 2, 5), True), ((1, 6, 1, 3), False)])
def test_kernel_emulation_bit_equal_to_reference(shape, with_bias, out_dtype):
    """The emulated kernel (``_emulate_kernel_int8`` on its launch plan for
    a card of 7 SMs, so blocks split columns along z) equals the plain
    version bit for bit at ragged and small shapes: the padded-row
    shifted-tap GEMM over the prepared weights, with dz folded into N, is
    the conv, and the epilogue is the plain version's."""
    xq, wq, scale, b = _case(shape, with_bias, seed=len(shape) + shape[-1])
    p = ck8.plan(*shape, sms=7)
    _, got = _emulate_kernel_int8(xq, ck8.prepare(wq), scale, b, p, out_dtype)
    want = ck8.conv3d_k3_int8_reference(xq, wq, scale, b, out_dtype)
    assert got.dtype == want.dtype == out_dtype
    assert torch.equal(got, want)
    assert torch.equal(ck8.conv3d_k3_int8(xq, wq, scale, b, out_dtype), want)   # CPU: plain


@pytest.mark.parametrize("nbw,tx", [(1, 14), (2, 30), (2, 62)])
def test_kernel_emulation_other_candidates(nbw, tx):
    """Every tile the plan may choose computes the same conv: candidates
    other than the chosen one, emulated, equal the plain version."""
    shape = (1, 3, 11, 70)
    xq, wq, scale, b = _case(shape, True, seed=11)
    _, p = ck8.candidate(*shape, 5, tx, nbw)
    _, got = _emulate_kernel_int8(xq, ck8.prepare(wq), scale, b, p, torch.bfloat16)
    assert torch.equal(got, ck8.conv3d_k3_int8_reference(xq, wq, scale, b))


def test_kernel_emulation_matches_jax_int8_conv():
    """On the same numpy-seeded float input and weights, quantized by each
    package: the emulated kernel's integer sums equal the int32
    accumulators of the JAX package's int8 conv (``lax.conv_general_dilated``
    on its quantized operands, as ``conv3d_int8`` computes them), and its
    float32 output is within one ulp of ``conv3d_int8``'s."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 4, 6, 16, 32)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 32, 32)) * 0.3).astype(np.float32)   # DHWIO
    b = rng.normal(size=(32,)).astype(np.float32)
    act_scale = float(np.abs(x).max()) / 127.0
    xq_j = jq._quantize_act(jnp.asarray(x), act_scale)
    wq_j, _ = jq._quantize_weight(jnp.asarray(w))
    acc_j = jax.lax.conv_general_dilated(
        xq_j, wq_j, (1, 1, 1), [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), preferred_element_type=jnp.int32)
    want = jq.conv3d_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1, act_scale,
                          folded=False, out_dtype=jnp.float32)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    wq, scale, bt, wk = quant.prepare(wt, torch.from_numpy(b), act_scale, 1)
    xq = quant._quantize_act(torch.from_numpy(x), act_scale)
    acc, got = _emulate_kernel_int8(xq, wk, scale, bt, ck8.plan(2, 4, 6, 16, sms=3),
                                    torch.float32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    want = np.asarray(want)
    assert np.all(np.abs(got.numpy() - want) <= np.spacing(np.abs(want)))
