"""The benchmark's plain int8 reference (``benchmark/reference/int8.py``)
against the definition of the int8 conv and against the port's int8 path
(``ops/quant.py`` under ``int8_mode``, the CPU's plain versions), at the
flagship's widths on a small grid, GRID (8, 16, 32): X % 32 == 0, so the
final fuse's int8 concat + 1x1 site exists.

* The reference's int8 conv equals the definition computed in integers
  (int64 sums; round half to even written out), half-way ties and sums
  past 2^24 included, and the port's ``quant.conv3d_int8`` bit for bit.
* The reference's sites are the port's 51 (``engine.convert.site_paths``
  under the calibration's scales), name for name.
* Each site of the port's int8 forward, on the seeded weights the
  benchmark draws and the port's calibrated scales: the reference's int8
  conv of the port's own input at that site equals the port's output.
  Tolerance: none, bit for bit (read: 0 at all 51 sites), since both
  compute the same integers and the same float32 epilogue.  The bf16 float
  path and the int8 path with every scale doubled differ at every site.
  Whole forwards are not compared here: a one-ulp difference between the
  two GroupNorms changes a few quantized elements at the first site, and
  the changes grow site by site (the heatmaps read 6-9 % of their range
  apart here, the bf16 path 8-13 %), so the whole forward is held by the
  cell's check on the card (``limits/hrradarpose_doppler_int8.serve_b8.json``).
* The reference's own calibration (``calibrate``) on the same frames holds
  the port's 51 scales within the cell's ``scale_ulps`` limit, and a
  clipped statistic, a site left uncalibrated and two sites' scales swapped
  read far above it.
* The counters count what the shapes ask for: 51 site calls a forward, 14
  at the K3 shape, all on the ``plain`` route on the CPU, one final-fuse
  concat + 1x1, the activation elements the sites quantize, and one
  ``int8.site`` span a site.
"""

import json
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import data, serve_artifact
from benchmark.reference import int8 as ref
from benchmark.tests.tiny import TINY_ROI
from rtpose_tpu_torch import export
from rtpose_tpu_torch.api import assemble
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.models.layers import TorchConv3d
from rtpose_tpu_torch.ops import conv_k3_int8, quant
from rtpose_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "benchmark", "configs", "hrradarpose_doppler_int8.json")
TRAFFIC = os.path.join(ROOT, "benchmark", "traffic", "serve_b8.json")
SEED = 2 ** 33 + 23
GRID = (8, 16, 32)          # TINY_ROI's
SITES = 51
SITE_GAP = 2.0 ** -8      # the largest gap of a site's output over its range
LIMITS = os.path.join(ROOT, "benchmark", "limits", "hrradarpose_doppler_int8.serve_b8.json")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the cores: cap torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _half_even(v: torch.Tensor) -> torch.Tensor:
    """Round half to even, written out (float64 in, float64 out)."""
    r = torch.floor(v)
    frac = v - r
    return r + (frac > 0.5) + ((frac == 0.5) & (torch.remainder(r, 2) == 1))


def _definition(x, w, bias, stride, scale, out_dtype):
    """``rtpose_tpu/ops/quant.py``'s int8 conv on NCDHW ``x`` (the conv's
    input, already in its dtype): the integer sums in int64."""
    xq = _half_even(x.double() * float(torch.tensor(1.0 / scale, dtype=torch.float32)))
    xq = xq.clamp(-127, 127).long()
    absmax = w.abs().amax(dim=(1, 2, 3, 4))
    sw = torch.where(absmax > 0, (absmax.double() / 127).float(), torch.ones_like(absmax))
    wq = _half_even((w / sw.view(-1, 1, 1, 1, 1)).double()).clamp(-127, 127).long()
    k = w.shape[-1]
    p = k // 2
    xp = F.pad(xq, (p, p, p, p, p, p))
    B, _, Z, Y, X = xq.shape
    Zo, Yo, Xo = ((n + 2 * p - k) // stride + 1 for n in (Z, Y, X))
    acc = torch.zeros((B, w.shape[0], Zo, Yo, Xo), dtype=torch.int64)
    for dz in range(k):
        for dy in range(k):
            for dx in range(k):
                tap = xp[:, :, dz:dz + stride * (Zo - 1) + 1:stride,
                         dy:dy + stride * (Yo - 1) + 1:stride,
                         dx:dx + stride * (Xo - 1) + 1:stride]
                acc += torch.einsum("bczyx,oc->bozyx", tap, wq[:, :, dz, dy, dx])
    out = acc.float() * (sw * torch.tensor(scale, dtype=torch.float32)).view(1, -1, 1, 1, 1)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1, 1)
    return out.to(out_dtype), acc


@pytest.mark.parametrize("k,stride,cin,cout,extreme", [
    (3, 1, 32, 32, False),      # the K3 shape
    (3, 2, 32, 64, False),      # a strided transition
    (1, 1, 192, 128, False),    # the final fuse's concat + 1x1
    (3, 1, 64, 64, True),       # every product +-127^2: sums past 2^24
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_reference_int8_conv_is_the_definition(k, stride, cin, cout, extreme, out_dtype):
    g = torch.Generator().manual_seed(k * 100 + cin)
    scale = 2.0 ** -4
    shape = (1, cin, 4, 6, 10)
    if extreme:
        x = torch.full(shape, 127 * scale)
        w = torch.full((cout, cin, k, k, k), 0.25)
    else:
        # half of the elements exactly half-way between two int8 steps
        ties = (torch.randint(-140, 140, shape, generator=g) + 0.5) * scale
        x = torch.where(torch.rand(shape, generator=g) < 0.5, ties,
                        torch.randn(shape, generator=g) * 3)
        w = torch.randn((cout, cin, k, k, k), generator=g) * 0.1
        w[0] = 0.0                                          # absmax 0: scale 1
    x = x.to(torch.bfloat16).float()
    b = torch.randn((cout,), generator=g)
    got = ref.int8_conv(x, w, b, stride, scale, out_dtype)
    want, acc = _definition(x, w, b, stride, scale, out_dtype)
    if extreme:
        assert int(acc.abs().max()) > 2 ** 24
    assert torch.equal(got, want.float())
    port = quant.conv3d_int8(x.to(out_dtype).permute(0, 2, 3, 4, 1), w, b, stride, scale)
    assert torch.equal(port.permute(0, 4, 1, 2, 3).float(), got)


def _config() -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    ds = cfg["DATASET"]
    ds["ROI"][ds["RDR_CUBE"]["ROI_TYPE"]] = dict(TINY_ROI)
    cfg["test_cfg"]["pc_range"] = [TINY_ROI[a][0] for a in "xyz"]
    return cfg


@pytest.fixture(scope="module")
def flagship():
    """The port and the int8 reference on the benchmark's seeded weights,
    two prepared frames and the port's scales calibrated on them."""
    cfg = _config()
    with open(TRAFFIC) as f:
        tr = json.load(f)
    tr["frames"], tr["pose"]["margin_vox_zyx"] = 2, [2, 3, 6]
    weights = data.make_weights(cfg, SEED, "cpu")
    asm = assemble(Config(cfg))
    asm.model.load_state_dict(weights)
    asm.model.eval()
    x = serve_artifact.prepared_frames(cfg, tr, SEED, "cpu")
    assert tuple(x.shape[1:4]) == GRID
    scales = export.calibrate_predict(asm, [x], exclude=tuple(cfg["int8"]["exclude"]))
    net = ref.load(ref.build(cfg["model"], 32, "cpu"), weights).eval()
    return dict(cfg=cfg, asm=asm, x=x, scales=scales, net=net,
                ref_scales=serve_artifact.reference_scales(asm.model, scales))


def test_the_reference_sites_are_the_ports(flagship):
    assert len(flagship["scales"]) == SITES
    assert ref.sites(flagship["net"]) == [n for n, m in flagship["asm"].model.named_modules()
                                          if n in flagship["ref_scales"]]
    assert set(ref.sites(flagship["net"])) == set(flagship["ref_scales"])
    with pytest.raises(KeyError, match="differ from the sites"):
        ref.set_scales(flagship["net"], dict(list(flagship["ref_scales"].items())[1:]))


def _site_io(model, scales, sites, x):
    """One forward of the port's ``model`` on ``x``, int8 with ``scales``
    (None: the bf16 float path): each of ``sites`` (module names)'s input,
    in the conv's dtype, and output, on the first frame."""
    seen = {}

    def hook(name):
        def keep(m, args, out):
            seen[name] = (args[0][:1].to(m.dtype or args[0].dtype), out[:1])
        return keep

    hooks = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n in sites]
    try:
        with torch.inference_mode():
            if scales is None:
                model(x)
            else:
                with quant.int8_mode(scales, exclude=quant.DEFAULT_EXCLUDE):
                    model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _site_gap(flagship, scales):
    """The port's forward with ``scales`` (None: the bf16 float path), each
    site against the reference's int8 conv (at the port's scales) of the
    port's own input there: the largest gap over the output's range."""
    seen = _site_io(flagship["asm"].model, scales, flagship["ref_scales"], flagship["x"])
    assert len(seen) == SITES
    net = ref.set_scales(flagship["net"], flagship["ref_scales"])
    mods = dict(net.named_modules())
    gap = 0.0
    for name, (x, out) in seen.items():
        m = mods[name]
        want = ref.int8_conv(x.float().permute(0, 4, 1, 2, 3), m.weight, m.bias, m.stride,
                             m.act_scale, m.out_dtype).permute(0, 2, 3, 4, 1)
        gap = max(gap, float((out.float() - want).abs().max() / want.abs().max()))
    return gap, seen


def test_each_port_site_is_the_reference_int8_conv(flagship):
    assert _site_gap(flagship, flagship["scales"])[0] == 0.0


@pytest.mark.parametrize("control", ["bf16", "double_scale"])
def test_the_controls_fail_at_the_sites(flagship, control):
    """Read here: the bf16 path 0.0412, the doubled scales 0.0991."""
    scales = None if control == "bf16" else {k: 2 * v for k, v in flagship["scales"].items()}
    assert _site_gap(flagship, scales)[0] > SITE_GAP


def test_the_reference_calibrates_the_ports_scales(flagship):
    """The reference's own calibration on the same frames holds the port's
    51 scales within the cell's limit (read here: 2 ulps), and a
    calibration fault reads far above it: a clipped statistic in place of
    the absmax, a site left at scale 1, two sites' scales swapped."""
    own, bounds = ref.calibrate(flagship["net"], [flagship["x"]])
    assert set(own) == set(flagship["ref_scales"]) and flagship["net"].pose_head.tasks[0] \
        .reg[0].act_scale is None
    limit = json.load(open(LIMITS))["limits"]["scale_ulps"]
    assert serve_artifact.scale_ulps(flagship["ref_scales"], bounds) <= limit
    clipped = serve_artifact.reference_scales(flagship["asm"].model, export.calibrate_predict(
        flagship["asm"], [flagship["x"]], quantile=0.999))
    names = list(flagship["ref_scales"])
    uncalibrated = dict(flagship["ref_scales"], **{names[7]: 1.0})
    a, b = "backbone.backbone.stage2.0.branches.1.0.conv2.conv", "pose_head.tasks.0.hm.0"
    swapped = dict(flagship["ref_scales"], **{a: flagship["ref_scales"][b],
                                              b: flagship["ref_scales"][a]})
    for faulty in (clipped, uncalibrated, swapped):
        assert serve_artifact.scale_ulps(faulty, bounds) > 4 * limit


def test_the_counters_count_what_the_shapes_ask_for(flagship, monkeypatch):
    k3_calls = []
    launch = conv_k3_int8.launch

    def counting(xq, *args, **kwargs):
        k3_calls.append(tuple(xq.shape))
        return launch(xq, *args, **kwargs)

    monkeypatch.setattr(conv_k3_int8, "launch", counting)
    quant.reset()
    trace.enable()
    trace.take()
    try:
        _, seen = _site_gap(flagship, flagship["scales"])
        spans = trace.take()
    finally:
        trace.disable()
    c = quant.counts()
    assert c == dict(sites=SITES, k3_kernel=0, int_mm=0, plain=SITES, concat_1x1=1,
                     quant_elems=len(flagship["x"]) * sum(x.numel() for x, _ in seen.values()))
    assert len(k3_calls) == 14 and all(s[-1] == 32 for s in k3_calls)
    assert [s[0] for s in spans].count("int8.site") == SITES
    quant.reset()
    assert set(quant.counts().values()) == {0}
