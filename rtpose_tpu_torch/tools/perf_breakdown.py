"""Per-segment timing of the flagship forward and train step on the card.

Counterpart of ``tools/perf_breakdown.py``.  It splits the inference path
(backbone / hm tower / peak argmax / sparse reg patches / the whole
``predict_sparse``; again under int8, and int8 with the resizes quantized)
and the train step (target assignment / loss forward / forward + backward /
optimizer / the whole step) into segments, each with its device time, its
host time and its operation count, so that the utilization of every segment
shows and a segment's share of a step can be read apart.  ``--backbone``
times the HRNet stages alone and ``--head`` the hm tower's convs.

Each group is a function returning ``{segment: {"ms", "host_ms", "gflop",
"util", "launches"}}``:

* ``ms`` — device time a call: the device operations (kernels, memcpy and
  memset) of ``iters`` calls in a ``torch.profiler`` trace after warm-up,
  summed and divided by ``iters``; a trace that may have lost operations
  is refused (``SegmentTimer.device_ms``).  The JAX tool takes the slope between
  two lengths of a chained ``lax.scan`` instead; both leave out the host's
  dispatch.  None off the card (no device to measure);
* ``host_ms`` — time a call between CUDA events around ``iters`` eager calls
  (the host clock on the CPU): above ``ms`` by what the card waits on the
  host's dispatch;
* ``gflop`` — ``utils.flops.estimate_flops`` of one call: two operations per
  multiply-add over each conv's full window and each matmul, whatever route
  a conv takes (not XLA's count: see ``utils/flops.py``);
* ``util`` — ``gflop`` over ``ms`` against the H100's dense bf16 peak of
  989 TFLOP/s (``BF16_PEAK``), None where either is missing;
* ``launches`` — each hand kernel's launches a call, from the wrappers'
  counts (``ops.launch_counts``).

Eager PyTorch elides nothing, so no call feeds a scalar back into the next as
the JAX tool's do; every call runs all of its work (the forward + backward
segment produces every gradient, the optimizer updates the parameters).

The port runs the canonical layout: the JAX tool's X-folded variants are a
TPU device the port does not carry, so each pair of JAX rows of one conv
(``gather`` and ``fold4``) is one row here, and the backbone rows time the
canonical modules.

Run::

    python -m rtpose_tpu_torch.tools.perf_breakdown [--train] [--infer] [--int8]
        [--backbone] [--head] [-B 8] [--iters 10] [--tiny] [--device {cuda,cpu}]

With no group flag it runs ``--train`` and ``--infer``, as the JAX tool.
``--tiny`` takes a (8, 16, 32) grid, for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import time
from contextlib import nullcontext
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import ops
from ..api import Assembly, assemble, resolve_device
from ..config import Config
from ..core.decode import flat_argmax
from ..engine import (bind_sites, create_train_state, make_loss_fn, make_train_step,
                      targets_from_batch)
from ..models import GNConv, ResNetBlock, init_weights
from ..models.hrnet3d import MODEL_CONFIGS, HighResolutionModule, concat_resized
from ..models.layers import conv3d
from ..ops import quant
from ..solver import AdamOneCycle, make_one_cycle_fns
from ..utils.flops import estimate_flops

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP = os.path.join(REPO, "configs", "cruw_pose", "hr3d_one_hm_doppler.py")
BF16_PEAK = 989e12      # H100 SXM, dense bf16 (NVIDIA's data sheet)
TINY_GRID = (8, 16, 32)  # small enough for the CPU, at least 5 a side for the 5^3 patches
WARMUP = 2
TRACE_EDGE_S = 0.05     # idle card between the traced calls and the trace window's edges
SENTINELS, SPIN_CYCLES = 64, 1000   # spin kernels on either side of a trace's calls
SPIN_KERNEL = "spin_kernel"         # torch.cuda._sleep's kernel
INFER_KEYS = ("backbone", "hm", "argmax", "reg", "full")


def flagship(tiny: bool = False, dtype: Optional[str] = None) -> Assembly:
    """The flagship's assembly (``__graft_entry__._flagship``): the model on
    the CPU with unset weights; ``tiny`` swaps the grid for ``TINY_GRID``,
    ``dtype`` the backbone's and head's compute dtype."""
    cfg = Config.fromfile(FLAGSHIP)
    if dtype is not None:
        cfg.model["backbone"]["dtype"] = dtype
        cfg.model["pose_head"]["dtype"] = dtype
    asm = assemble(cfg)
    if tiny:
        asm = dataclasses.replace(
            asm, input_shape_zyxc=(*TINY_GRID, asm.input_shape_zyxc[-1]),
            target_spec=dataclasses.replace(asm.target_spec, grid_zyx=TINY_GRID),
            decode_spec=dataclasses.replace(asm.decode_spec, grid_zyx=TINY_GRID))
    return asm


class SegmentTimer:
    """Times segments on ``device``: ``WARMUP`` calls, then ``iters`` calls
    between CUDA events and ``iters`` more under ``torch.profiler`` (the
    host clock and no trace on the CPU), then one under the FLOP counter."""

    def __init__(self, device: torch.device, iters: int = 10, batch: int = 1):
        self.device, self.iters, self.batch = device, iters, batch

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def host_ms(self, fn: Callable) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(self.iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / self.iters
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        self._sync()
        start.record()
        for _ in range(self.iters):
            fn()
        end.record()
        self._sync()
        return start.elapsed_time(end) / self.iters

    def device_ms(self, fn: Callable) -> Optional[float]:
        """Device time a call, every device operation of the trace counted:
        kernels, memcpy and memset.  None off the card.

        The profiler keeps only the device activity inside its window on
        the host's clock, and on the H100 traces taken late in a process
        lost their first device operations (20 of a backbone trace's ~3,800
        after the hundreds of traces of ``chip_smoke.py``'s earlier phases;
        the cause is not established).  So the card idles
        ``TRACE_EDGE_S`` on either side, ``SENTINELS`` spin kernels
        (``torch.cuda._sleep``, left out of the sum) come before the calls
        and as many after, and a trace that kept no more than ``SENTINELS``
        of them may have lost the calls' own operations: it is refused."""
        if self.device.type != "cuda":
            return None
        from torch.profiler import ProfilerActivity, profile

        def sentinels():
            for _ in range(SENTINELS):
                torch.cuda._sleep(SPIN_CYCLES)

        self._sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_EDGE_S)
            sentinels()
            for _ in range(self.iters):
                fn()
            sentinels()
            self._sync()
            time.sleep(TRACE_EDGE_S)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kept = sum(e.count for e in events if SPIN_KERNEL in e.key)
        if kept <= SENTINELS:
            raise RuntimeError(f"perf_breakdown: the trace kept {kept} of its {2 * SENTINELS} "
                               f"sentinel kernels, so it may have lost the calls' own")
        return sum(e.self_device_time_total for e in events
                   if SPIN_KERNEL not in e.key) / 1e3 / self.iters

    def segment(self, name: str, fn: Callable, count_flops: bool = True) -> dict:
        """Time ``fn``, count its operations and launches; print its row."""
        calls = 0

        def counted():
            nonlocal calls
            calls += 1
            return fn()

        before = ops.launch_counts()
        for _ in range(WARMUP):
            counted()
        host = self.host_ms(counted)
        dev = self.device_ms(counted)
        gflop = None
        if count_flops:
            gflop = (estimate_flops(counted) or 0.0) / 1e9
        self._sync()
        after = ops.launch_counts()
        rec = dict(ms=dev, host_ms=host, gflop=gflop, util=utilization(gflop, dev),
                   launches={k: (after[k] - before[k]) / calls for k in after})
        print_row(name, rec, self.batch)
        return rec


def utilization(gflop: Optional[float], ms: Optional[float]) -> Optional[float]:
    if not gflop or not ms:
        return None
    return gflop * 1e9 / (ms * 1e-3) / BF16_PEAK


def derived(a: dict, b: dict) -> dict:
    """The row of ``a`` minus ``b`` (backward alone = forward + backward minus
    the forward)."""
    def sub(x, y):
        return None if x is None or y is None else x - y
    ms, gf = sub(a["ms"], b["ms"]), sub(a["gflop"], b["gflop"])
    return dict(ms=ms, host_ms=a["host_ms"] - b["host_ms"], gflop=gf,
                util=utilization(gf, ms),
                launches={k: a["launches"][k] - b["launches"][k] for k in a["launches"]})


def total(rows) -> dict:
    """The sum of rows' times, operations and launches."""
    rows = list(rows)
    ms = None if any(r["ms"] is None for r in rows) else sum(r["ms"] for r in rows)
    gf = sum(r["gflop"] or 0.0 for r in rows)
    return dict(ms=ms, host_ms=sum(r["host_ms"] for r in rows), gflop=gf,
                util=utilization(gf, ms),
                launches={k: sum(r["launches"][k] for r in rows) for k in rows[0]["launches"]})


def _fmt(v, spec, missing="not measured"):
    return missing if v is None else format(v, spec)


def print_row(name: str, rec: dict, batch: int) -> None:
    ms = rec["ms"]
    util = None if rec["util"] is None else 100 * rec["util"]
    print(f"{name:<34} {_fmt(ms, '9.4f')} ms device  {rec['host_ms']:9.4f} ms host  "
          f"{_fmt(rec['gflop'], '8.2f', 'n/a')} GFLOP  util {_fmt(util, '5.1f', 'n/a')}%  "
          f"({_fmt(None if ms is None else ms / batch, '.4f')} ms/frame)")


def random_input(rng: np.random.Generator, shape, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(rng.random(shape, np.float32)).to(device=device, dtype=dtype)


# -- inference ---------------------------------------------------------------

def infer_calls(model, x: torch.Tensor) -> Dict[str, Callable]:
    """The inference segments' callables: each segment on the previous ones'
    outputs, computed once here (call under the context the segments run
    in, and under ``torch.inference_mode``): the feature map, the head's
    shared feature, the heatmap, and the peak indices the argmax gives at
    the heatmap's grid.  The hm segment holds the head's shared conv (none
    in the flagship); the reg segment reads the shared feature."""
    feat = model.extract_feat(x)
    shared = model.shared(feat)
    hm = model.pose_head.heads(shared, branch="hm")[0]["hm"]
    B, Z, Y, X, C = hm.shape
    flat = flat_argmax(hm.reshape(B, -1, C)[..., 0])
    z, y, xx = flat // (Y * X), (flat % (Y * X)) // X, flat % X
    return dict(backbone=lambda: model.extract_feat(x),
                hm=lambda: model.pose_head(feat, branch="hm")[0]["hm"],
                argmax=lambda: flat_argmax(hm.reshape(B, -1, C)[..., 0]),
                reg=lambda: model._reg_patches(shared, z, y, xx, (Z, Y, X)),
                full=lambda: model.predict_sparse(x))


INFER_NAMES = dict(backbone="backbone(extract_feat)", hm="hm tower", argmax="peak argmax",
                   reg="sparse reg patches", full="FULL predict_sparse")


def infer_segments(model, x: torch.Tensor, timer: SegmentTimer, label: str = "bf16",
                   ctx: Callable = nullcontext) -> dict:
    """The inference segments under ``ctx`` (``nullcontext``: the model's
    own dtype; ``quant.int8_mode``: int8), and ``sum``, the four segments'
    sum, beside ``full``."""
    print(f"\n== inference segments ({label}) ==")
    out = {}
    with ctx(), torch.inference_mode():
        calls = infer_calls(model, x)
        for key in INFER_KEYS:
            out[key] = timer.segment(INFER_NAMES[key], calls[key],
                                     count_flops=key != "argmax")
    out["sum"] = total(out[k] for k in INFER_KEYS[:-1])
    print(f"  sum of segments: {_fmt(out['sum']['ms'], '.4f')} ms device, "
          f"{out['sum']['host_ms']:.4f} ms host")
    return out


def speedups(base: dict, other: dict, label: str) -> dict:
    """Per segment, ``base`` time over ``other`` time (device ms; the host
    clock off the card)."""
    key = "ms" if base["full"]["ms"] is not None else "host_ms"
    out = {}
    for k in INFER_KEYS:
        if other[k][key]:
            out[k] = base[k][key] / other[k][key]
            print(f"  {label} speedup {k:<10} {out[k]:.2f}x"
                  + ("" if key == "ms" else " (host clock)"))
    return out


def int8_segments(model, x: torch.Tensor, xcal: torch.Tensor, timer: SegmentTimer,
                  base: dict) -> dict:
    """The inference segments under int8 (scales from one calibration batch
    ``xcal``, the default exclusions), then with the final-fuse resizes
    quantized too (``INT8_RESIZE_EXCLUDE``), each with its speedups over
    ``base`` (``infer_segments``)."""
    bind_sites(model)
    out = {}
    for label, exclude in (("int8", quant.DEFAULT_EXCLUDE),
                           ("int8+resize", quant.INT8_RESIZE_EXCLUDE)):
        scales = quant.calibration_scales(model.predict_sparse, [xcal], exclude=exclude)
        print(f"# {label}: {len(scales)} calibrated sites")
        segs = infer_segments(model, x, timer, label,
                              lambda s=scales, e=exclude: quant.int8_mode(s, exclude=e))
        segs["sites"] = len(scales)
        segs["speedup"] = speedups(base, segs, label)
        out[label] = segs
    return out


# -- training ----------------------------------------------------------------

def train_batch(asm: Assembly, x: torch.Tensor) -> dict:
    """The JAX tool's batch: ``x``, and one pose a frame with all 15 joints
    at ``pc_range_min + (1, 2, 1)`` m."""
    B = x.shape[0]
    pelvis = np.asarray(asm.target_spec.pc_range_min_xyz, np.float32) + \
        np.array([1.0, 2.0, 1.0], np.float32)
    return {"rdr_tensor": x,
            "poses": torch.from_numpy(np.tile(pelvis, (B, 1, 15, 1))).to(x.device),
            "num_poses": torch.ones((B,), dtype=torch.int32, device=x.device)}


def train_calls(asm: Assembly, model, batch: dict) -> Dict[str, Callable]:
    """The train segments' callables on ``model`` (its parameters float32;
    ``asm`` gives the target spec, so ``model`` may be a copy of its model):
    ``targets`` (assignment on the device), ``loss_fwd`` (the sparse loss,
    no gradient), ``fwd_bwd`` (loss and backward: every parameter's
    ``.grad``), ``optimizer`` (one ``AdamOneCycle`` step on the gradients
    of the last ``fwd_bwd``, with the clip at 35 and the NaN guard on its
    loss that the train step applies, ``make_one_cycle_fns(1000, 2e-3)``)
    and ``full`` (``make_train_step``'s whole step, targets included).  The
    loss segments take the targets assigned here, so ``targets`` is timed
    apart from them."""
    spec, head = asm.target_spec, model.pose_head
    params = [p for p in model.parameters() if p.requires_grad]
    lr_fn, mom_fn = make_one_cycle_fns(1000, 2e-3)
    opt = AdamOneCycle(params, lr_fn, mom_fn)
    loss_fn = make_loss_fn(model, head, spec, sparse_reg=True)
    with torch.no_grad():
        batch_t = dict(batch, **targets_from_batch(batch, spec))
    step0 = torch.zeros((), dtype=torch.int64, device=batch["rdr_tensor"].device)

    def loss_fwd():
        with torch.no_grad():
            return loss_fn(batch_t, step0)[0]

    last = {}

    def fwd_bwd():
        for p in params:
            p.grad = None
        last["loss"] = loss = loss_fn(batch_t, step0)[0]
        loss.backward()
        return loss

    def optimizer():
        return opt.step(finite=torch.isfinite(last["loss"].detach()))

    def targets():
        with torch.no_grad():
            return targets_from_batch(batch, spec)

    step = make_train_step(model, head, spec, opt, lr_fn=lr_fn, sparse_reg=True)
    state = create_train_state(model, opt)

    def full():
        return step(state, batch)[1]["loss"]

    return dict(targets=targets, loss_fwd=loss_fwd, fwd_bwd=fwd_bwd, optimizer=optimizer,
                full=full, opt=opt, state=state)


def train_segments(asm: Assembly, model, batch: dict, timer: SegmentTimer) -> dict:
    """The train segments, ``backward`` (forward + backward minus the
    forward), ``sum`` (targets, forward + backward and optimizer) and
    ``steps_per_s`` of the whole step."""
    print("\n== train segments ==")
    calls = train_calls(asm, model, batch)
    out = dict(targets=timer.segment("target assign", calls["targets"], count_flops=False))
    out["loss_fwd"] = timer.segment("loss forward (sparse)", calls["loss_fwd"])
    out["fwd_bwd"] = timer.segment("loss fwd+bwd", calls["fwd_bwd"])
    out["backward"] = derived(out["fwd_bwd"], out["loss_fwd"])
    print_row("  -> backward alone", out["backward"], timer.batch)
    out["optimizer"] = timer.segment("optimizer (adam+clip+guard)", calls["optimizer"],
                                     count_flops=False)
    out["full"] = timer.segment("FULL train step", calls["full"])
    out["sum"] = total(out[k] for k in ("targets", "fwd_bwd", "optimizer"))
    key = "ms" if out["full"]["ms"] is not None else "host_ms"
    out["steps_per_s"] = 1e3 / out["full"][key]
    print(f"  sum of segments: {_fmt(out['sum']['ms'], '.4f')} ms device, "
          f"{out['sum']['host_ms']:.4f} ms host; steps/s {out['steps_per_s']:.2f}"
          + ("" if key == "ms" else " (host clock)"))
    return out


# -- backbone and head internals ---------------------------------------------

def _seeded(module: torch.nn.Module, device) -> torch.nn.Module:
    return init_weights(module, torch.Generator().manual_seed(0)).to(device)


class FinalFuse(torch.nn.Module):
    """The final fuse without its 1x1 conv: every branch resized to the
    first's grid (trilinear, align corners), concatenated on channels."""

    def forward(self, xs):
        return concat_resized(xs[0], list(xs[1:]))


def backbone_segments(asm: Assembly, batch: int, rng: np.random.Generator,
                      timer: SegmentTimer, dtype=torch.bfloat16) -> dict:
    """The backbone's parts on seeded weights and random inputs at their
    branch shapes: layer1's ``ResNetBlock``, each stage's
    ``HighResolutionModule``, the two strided ``GNConv`` transitions that
    make a new branch, and the final fuse's resizes and concat; and ``sum``."""
    print("\n== backbone per-stage (seeded weights) ==")
    mc = MODEL_CONFIGS[asm.model_cfg["backbone"]["backbone_cfg"]]
    z, y, x, _ = asm.input_shape_zyxc
    dev = timer.device

    def inputs(chans):
        return [random_input(rng, (batch, z >> i, y >> i, x >> i, c), dev, dtype)
                for i, c in enumerate(chans)]

    def time_module(name, module, xs, as_list):
        module = _seeded(module, dev)
        with torch.inference_mode():
            return timer.segment(name, lambda: module(xs if as_list else xs[0]))

    out = {}
    c2 = mc["stage2_inplanes"]
    out["layer1"] = time_module("layer1 (ResNetBlock full-res)",
                                ResNetBlock(c2, c2, dtype=dtype), inputs([c2]), False)
    for sname in ("stage2", "stage3", "stage4"):
        scfg = mc.get(sname)
        if scfg is None:
            continue
        mod = HighResolutionModule(scfg["num_branches"], scfg["num_blocks"],
                                   scfg["num_channels"], dtype=dtype)
        out[sname] = time_module(f"{sname} ({scfg['num_branches']}br)", mod,
                                 inputs(scfg["num_channels"]), True)
    s4 = mc.get("stage4", mc["stage3"])
    for i, (src, dst) in enumerate([(mc["stage2"]["num_channels"][-1],
                                     mc["stage3"]["num_channels"][-1]),
                                    (mc["stage3"]["num_channels"][-1],
                                     s4["num_channels"][-1])]):
        lvl = i + 1
        xs = [random_input(rng, (batch, z >> lvl, y >> lvl, x >> lvl, src), dev, dtype)]
        out[f"transition{i + 2}"] = time_module(
            f"transition{i + 2} (s2 GNConv)",
            GNConv(src, dst, kernel=3, stride=2, relu=True, dtype=dtype), xs, False)
    out["final_fuse"] = time_module("final fuse (resizes+concat)", FinalFuse(),
                                    inputs(s4["num_channels"]), True)
    out["sum"] = total(out.values())
    print(f"  sum of stages: {_fmt(out['sum']['ms'], '.4f')} ms device, "
          f"{out['sum']['host_ms']:.4f} ms host")
    return out


def head_segments(asm: Assembly, batch: int, rng: np.random.Generator,
                  timer: SegmentTimer) -> dict:
    """The hm tower's convs on a random bf16 feature map: conv0 (C128 -> 32,
    bf16), the output conv C32 -> 1 in float32 and in bf16, and the C32 -> 8
    padding probe (the output conv's weights tiled 8 times), on the ReLU of
    conv0's output.  Weights are normal draws of ``rng`` in the JAX tool's
    (kz, ky, kx, ci, co) order."""
    print("\n== hm tower internals (seeded weights) ==")
    z, y, x, _ = asm.input_shape_zyxc
    cin, hc = asm.model_cfg["pose_head"]["in_channels"], 32
    dev = timer.device
    feat = random_input(rng, (batch, z, y, x, cin), dev, torch.bfloat16)

    def torch_layout(w):   # (kz, ky, kx, ci, co) -> (co, ci, kz, ky, kx)
        return torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous().to(dev)

    w0 = torch_layout(rng.normal(size=(3, 3, 3, cin, hc)).astype(np.float32)).bfloat16()
    w1 = torch_layout(rng.normal(size=(3, 3, 3, hc, 1)).astype(np.float32))
    w8 = w1.bfloat16().repeat(8, 1, 1, 1, 1)
    out = {}
    with torch.inference_mode():
        out["conv0"] = timer.segment("conv0 C128->32", lambda: conv3d(feat, w0, None))
        h32 = torch.relu(conv3d(feat, w0, None))
        h32f = h32.float()
        out["out_f32"] = timer.segment("out C32->1 f32", lambda: conv3d(h32f, w1, None))
        w1b = w1.bfloat16()
        out["out_bf16"] = timer.segment("out C32->1 bf16", lambda: conv3d(h32, w1b, None))
        out["out8_bf16"] = timer.segment("out C32->8 bf16 (pad probe)",
                                         lambda: conv3d(h32, w8, None))
    return out


# -- the tool ----------------------------------------------------------------

def smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="per-segment timing of the flagship "
                                            "(PyTorch port)")
    p.add_argument("--train", action="store_true")
    p.add_argument("--infer", action="store_true")
    p.add_argument("--backbone", action="store_true",
                   help="per-stage breakdown inside the HRNet trunk")
    p.add_argument("--head", action="store_true",
                   help="hm-tower internals (conv0 / out-conv variants)")
    p.add_argument("--int8", action="store_true",
                   help="also time the inference segments under quant.int8_mode "
                        "(random-cube calibration), and with the resizes quantized")
    p.add_argument("-B", type=int, default=8)
    p.add_argument("--iters", type=int, default=10,
                   help="calls timed per segment (host clock, then the trace)")
    p.add_argument("--tiny", action="store_true", help=f"a {TINY_GRID} grid (the CPU)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the groups the flags ask for; returns {group: segments}."""
    args = parse_args(argv)
    any_flag = args.train or args.infer or args.backbone or args.head
    do_train = args.train or not any_flag
    do_infer = args.infer or not any_flag
    dev = resolve_device(args.device)
    B = args.B
    asm = flagship(tiny=args.tiny)
    z, y, x, c = asm.input_shape_zyxc
    card = (f"{torch.cuda.get_device_name(dev)} ({smi_line()})" if dev.type == "cuda"
            else "cpu")
    print(f"# device {card}  grid ({z},{y},{x},{c})  B={B}  iters {args.iters}")
    rng = np.random.default_rng(0)
    xb = random_input(rng, (B, z, y, x, c), dev)
    model = init_weights(asm.model, torch.Generator().manual_seed(0)).to(dev)
    timer = SegmentTimer(dev, args.iters, B)
    out = {}
    if args.backbone:
        out["backbone"] = backbone_segments(asm, B, rng, timer)
    if args.head:
        out["head"] = head_segments(asm, B, rng, timer)
    if do_infer:
        out["infer"] = infer_segments(model, xb, timer)
        if args.int8:
            xcal = random_input(rng, (B, z, y, x, c), dev)
            out.update(int8_segments(model, xb, xcal, timer, out["infer"]))
    if do_train:
        out["train"] = train_segments(asm, model, train_batch(asm, xb), timer)
    return out


if __name__ == "__main__":
    main()
