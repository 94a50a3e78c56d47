"""The benchmark's plain deformable-head reference (``benchmark/reference/dcn.py``)
against the definition, and the port against the reference, on the CPU.

* The reference's deformable conv against a per-sample loop over output
  positions, groups and taps written from ``det3d/ops/dcn``'s definition
  in float64: fractional and integer offsets, taps with a corner off the
  map, taps whose moved centre leaves the map or lies on its open edge.
  Tolerance 1e-5 of the output's range: float32 against float64, one
  contraction of at most 72 terms.
* The port's ``ops.deform_conv.deform_conv2d``, its ``DCNSepHead`` and its
  whole dense forward (``RadarPoseNet.forward``) against the reference on
  the seeded weights the benchmark draws (``INIT``: the offset convs from
  N(0, 0.05^2)) at a small grid of the configuration's widths.  Float32:
  1e-4 of the output's range (the same arithmetic summed in other orders).
  bf16, the configuration's compute dtype: ``BF16_TOL`` of the range,
  each set from readings here with room (the test's comments give them):
  inputs, weights, bilinear weights and each of the weighting's seven
  products and sums round to bf16 (2^-9 relative each), and the trunk's
  convs, GroupNorms and resizes add theirs layer by layer.
* A port that ignores the offsets (zero offsets: each deformable conv a
  plain conv) fails every one of these comparisons, in float32 and in bf16.
"""

import json
import math
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import data
from benchmark.reference import dcn as ref
from benchmark.tests.tiny import TINY_ROI
from rtpose_tpu_torch.api import assemble
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.models import dcn_head
from rtpose_tpu_torch.ops import deform_conv as dc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "benchmark", "configs", "hrradarpose_dcn.json")
SEED = 2 ** 33 + 17

# the largest gap over the range read here (seed SEED), and the tolerance
# set from it with room: deform_conv2d at 128 channels 0.0068 -> 0.02; the
# head's heatmap 0.0043 and regression 0.0056 -> 0.02; the whole forward's
# heatmap 0.0182 and regression 0.0213 (the bf16 trunk's error on top) ->
# 0.05.  Ignoring the offsets reads 0.41-1.92 on each, float32 and bf16.
BF16_TOL = {"deform_conv2d": 0.02, "head": 0.02, "forward": 0.05}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the cores: cap torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gap(got, want) -> float:
    """The largest gap over the reference's range (max |want|)."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _loop_deform(x, off, w, groups):
    """Deformable conv v1 by its definition, one output position, group
    and tap at a time, in float64."""
    N, C, H, W = x.shape
    Cout, _, kh, kw = w.shape
    K, Cg = kh * kw, C // groups
    xd, wd = x.double(), w.double()
    out = torch.zeros((N, Cout, H, W), dtype=torch.float64)
    for n in range(N):
        for y in range(H):
            for xo in range(W):
                col = torch.zeros((C, kh, kw), dtype=torch.float64)
                for g in range(groups):
                    cs = slice(g * Cg, (g + 1) * Cg)
                    for k in range(K):
                        i, j = divmod(k, kw)
                        py = y - 1 + i + float(off[n, (g * K + k) * 2, y, xo])
                        px = xo - 1 + j + float(off[n, (g * K + k) * 2 + 1, y, xo])
                        if not (-1 < py < H and -1 < px < W):
                            continue            # the moved centre left the map
                        y0, x0 = math.floor(py), math.floor(px)
                        ly, lx = py - y0, px - x0
                        for yy, xx, wt in ((y0, x0, (1 - ly) * (1 - lx)),
                                           (y0, x0 + 1, (1 - ly) * lx),
                                           (y0 + 1, x0, ly * (1 - lx)),
                                           (y0 + 1, x0 + 1, ly * lx)):
                            if 0 <= yy < H and 0 <= xx < W:     # a corner off the map: 0
                                col[cs, i, j] += wt * xd[n, cs, yy, xx]
                out[n, :, y, xo] = (wd * col[None]).sum(dim=(1, 2, 3))
    return out


def _planted(seed, N=2, C=8, H=5, W=6, Cout=3, groups=4):
    """x, offsets of up to 1.5 pixels with planted cases, weights (NCHW)."""
    g = torch.Generator().manual_seed(seed)
    K = 9
    x = torch.randn((N, C, H, W), generator=g)
    off = (torch.rand((N, groups * K * 2, H, W), generator=g) * 3 - 1.5)
    off[0, 0:2, 0, 0] = torch.tensor([-5.0, 0.3])        # tap 0 far above the map
    off[0, 2:4, 0, 1] = torch.tensor([-0.5, 0.25])       # tap 1 with its upper corners off
    off[0, 0:2, 0, 2] = torch.tensor([0.0, 0.4])         # tap 0 on the open edge y = -1
    off[1, -2:, H - 1, W - 1] = torch.tensor([0.6, 2.7])  # the last tap leaving on the right
    off[1, 8:10, 2, 3] = torch.tensor([1.0, -2.0])       # integer offsets
    w = torch.randn((Cout, C, 3, 3), generator=g) / math.sqrt(K * C)
    return x, off, w


def test_the_reference_deform_conv_is_the_definition():
    x, off, w = _planted(0)
    want = _loop_deform(x, off, w, groups=4)
    got = ref.deform_conv2d(x, off, w, groups=4)
    assert got.dtype == torch.float32
    assert _gap(got, want) < 1e-5
    # the planted cases: the tap above the map adds nothing, the others do
    lone = torch.zeros_like(w)
    lone[:, 0:2, 0, 0] = 1.0                              # group 0, tap 0 alone
    assert float(ref.deform_conv2d(x, off, lone, groups=4)[0, :, 0, 0].abs().max()) == 0.0
    assert _gap(ref.deform_conv2d(x, off, lone, groups=4),
                _loop_deform(x, off, lone, groups=4)) < 1e-5


def _port_deform(x, off, w, dtype):
    """The port's deform_conv2d on NCHW operands, in ``dtype`` (offsets stay
    float32, as the offset conv gives them), back to NCHW float32."""
    out = dc.deform_conv2d(x.permute(0, 2, 3, 1).to(dtype), off.permute(0, 2, 3, 1),
                           w.permute(2, 3, 1, 0).to(dtype), deformable_groups=4)
    return out.permute(0, 3, 1, 2).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offsets", ["given", "ignored"])
def test_the_port_deform_conv_against_the_reference(dtype, offsets):
    """At the head's width (128 channels, 4 groups): the port within its
    tolerance, and a port that ignores the offsets far outside it."""
    g = torch.Generator().manual_seed(SEED)
    N, C, H, W = 3, 128, 6, 10
    x = torch.randn((N, C, H, W), generator=g)
    off = torch.randn((N, 72, H, W), generator=g)
    w = torch.randn((C, C, 3, 3), generator=g) * math.sqrt(2.0 / (9 * C))
    want = ref.deform_conv2d(x, off, w)
    got = _port_deform(x, torch.zeros_like(off) if offsets == "ignored" else off, w, dtype)
    tol = 1e-4 if dtype == torch.float32 else BF16_TOL["deform_conv2d"]
    assert (_gap(got, want) <= tol) == (offsets == "given"), _gap(got, want)


def _config(dtype: str) -> dict:
    """The benchmark's configuration at the small grid, computing in ``dtype``."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    ds = cfg["DATASET"]
    ds["ROI"][ds["RDR_CUBE"]["ROI_TYPE"]] = dict(TINY_ROI)
    cfg["test_cfg"]["pc_range"] = [TINY_ROI[a][0] for a in "xyz"]
    for part in ("backbone", "pose_head"):
        cfg["model"][part]["dtype"] = dtype
    return cfg


def _models(dtype: str):
    """The port and the reference, both on the benchmark's seeded weights."""
    cfg = _config(dtype)
    weights = data.make_weights(cfg, SEED, "cpu")
    port = assemble(Config(cfg)).model
    port.load_state_dict(weights)
    net = ref.load(ref.build(cfg["model"], 32, "cpu"), weights)
    return port.eval(), net.eval()


@pytest.fixture
def ignore_offsets(monkeypatch):
    def forward(self, x):
        return F.relu(self.conv_adaption(x, torch.zeros_like(self.conv_offset(x))))

    def on():
        monkeypatch.setattr(dcn_head.FeatureAdaption, "forward", forward)
    return on


def _cube(seed, shape=(1, 8, 16, 32, 32)):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offsets", ["given", "ignored"])
def test_the_port_dcn_head_against_the_reference(dtype, offsets, ignore_offsets):
    port, net = _models(dtype)
    with torch.no_grad():
        feat = net.features(_cube(1))                    # (B, C, Z, Y, X) float32
        hm_want, reg_want = net.pose_head.tasks[0](feat)
        if offsets == "ignored":
            ignore_offsets()
        got = port.pose_head(feat.permute(0, 2, 3, 4, 1).to(getattr(torch, dtype)))[0]
    tol = 1e-4 if dtype == "float32" else BF16_TOL["head"]
    gaps = (_gap(got["hm"].permute(0, 4, 1, 2, 3), hm_want),
            _gap(got["reg"].permute(0, 4, 1, 2, 3), reg_want))
    if offsets == "given":
        assert max(gaps) <= tol, gaps
    else:
        assert min(gaps) > tol, gaps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offsets", ["given", "ignored"])
def test_the_port_dense_forward_against_the_reference(dtype, offsets, ignore_offsets):
    port, net = _models(dtype)
    x = _cube(2)
    with torch.no_grad():
        hm_want, reg_want = net.dense(x)
        if offsets == "ignored":
            ignore_offsets()
        got = port(x)[0]
    tol = 1e-4 if dtype == "float32" else BF16_TOL["forward"]
    gaps = (_gap(got["hm"].permute(0, 4, 1, 2, 3), hm_want),
            _gap(got["reg"].permute(0, 4, 1, 2, 3), reg_want))
    if offsets == "given":
        assert max(gaps) <= tol, gaps
    else:
        assert min(gaps) > tol, gaps


def test_the_reference_leaves_tf32_as_it_found_it():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = setting
            with ref.NoTF32():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32 is setting
            assert torch.backends.cudnn.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
