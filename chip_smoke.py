#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rtpose_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Phases, each fatal on failure (exit code != 0, no result line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from rtpose_tpu_torch/csrc (nvcc, in parallel);
  3. preprocess kernel (K1 batched / K2 single cube) against its plain
     version: a real ROI crop of a (32, 32, 128, 256) f16 cube, and the
     identity ROI at (8, 32, 16, 64, 160) in f16, bf16 and f32;
  4. conv kernel (K3) against its plain version at the main path's four
     shapes (B=1 and B=8, full and half resolution), a ragged one with
     bias and one with B * Z > 65535; two launches bit-identical (forward
     and grad-input); device times beside the plain version and bf16
     F.conv3d at the four shapes (kernel / library, TFLOP/s, share of the
     bound);
  5. the flagship eval path end to end: a synthetic ROI-only dataset of
     300 test frames at the flagship geometry, seeded random weights saved
     as .pth, and ``rtpose_tpu_torch.tools.test`` on configs/cruw_pose/
     hr3d_one_hm_doppler.py with --device_preprocess --speed_test (each
     speed window is the middle third: 100 frames at B=1);
  6. launch counts of that run: every kernel of the path launched
     (preprocess once per frame, conv 14 times per forward);
  7. four more speed windows, then one run under torch.profiler: device
     time and operations per frame, the card's idle share, and the
     kernels with the most device time;
  8. one frame through the port on the card (bf16 + kernels) against the
     same frame and weights through the port on the CPU in float32;
  9. the conv backward (``Conv3dK3``): grad-input through the K3 kernel on
     flipped, transposed weights, and the library grad-weight, against their
     plain versions at the training shapes (B=8, full and half resolution),
     a ragged shape with bias and B * Z > 65535; grad-input timed beside its
     plain version and cuDNN's bf16 grad-input at the four main-path shapes;
 10. ``TorchConv3d`` in grad mode on the card: its output has a ``grad_fn``
     and its gradients match autograd of the plain version;
 11. the flagship training path end to end: a synthetic ROI-only root of
     TRAIN_FRAMES train frames, ``rtpose_tpu_torch.tools.train`` on the
     flagship config with --device_preprocess --seed 0 --stop_epoch 2 (B=8,
     total_epochs sizing one-cycle), its launch counts (preprocess once per
     step, the conv 14 times per step forward and 14 backward), finite
     losses and no skipped step, ms/step and frames/s;
 12. one more training epoch under torch.profiler: device busy ms/step and
     the card's idle share;
 13. ``rtpose_tpu_torch.tools.test`` evaluates the trained checkpoint;
 14. one train step's loss and gradients on the card (bf16 + kernels)
     against the CPU in float32, same weights and sample, B=1.
Kernel times (``ms``, ``plain_ms``, ``library_ms``) are device times:
``CALLS`` calls captured in one CUDA graph, replayed between CUDA events,
so no host work falls in the window; ``wrapper_ms`` times the Python
wrapper called eagerly, host work included.
Prints a ``{"e2e": ...}`` line, a ``{"train": ...}`` line, a
``{"kernels": [...]}`` line, then the nvidia-smi line again, then
``{"ok": true, "device": {...}}`` as the last line.  Each kernel's
``launches`` is its count on its own path (eval for the preprocess and
forward conv kernels, training for the conv backward); ``train_launches``
gives every kernel's count on the training path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "configs", "cruw_pose", "hr3d_one_hm_doppler.py")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate, HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# K3 tolerance: the kernel and the plain version both accumulate in float32
# and round once to bf16; different summation orders can land a value on
# either side of a bf16 rounding boundary, so allow one bf16 ulp (2^-7
# relative) plus 2e-3 of the output range for cancellation near zero.
CONV_RTOL, CONV_ATOL_FRAC = 2.0 ** -7, 2e-3
# K1/K2: the same float32 ops in the same order -> equal up to 1e-6 relative
PRE_RTOL = 1e-6
# GPU (bf16 activations + kernels) vs CPU (float32): bf16 carries ~0.4 %
# per rounding through ~20 layers; a CPU run at a reduced grid showed
# heatmap-logit differences of ~1.5 % of the logit range and regression
# differences of ~1.3 % of max |reg|.  Allowed: 5 % of each.
E2E_FRAC = 0.05

# GPU (bf16 + kernels) vs CPU (float32) train step at B=1: loss within 2 %,
# global gradient norm within 5 %, cosine of the flattened gradients >= 0.99
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_MIN_COS = 0.02, 0.05, 0.99

FRAMES = 300    # test frames of the synthetic root (2 sequences x 150)
TRAIN_FRAMES = 96   # train frames of the training root (2 sequences x 48)
TRAIN_EPOCHS = 2    # --stop_epoch of the training run
K3_PER_STEP = 14    # stride-1 32->32 3x3x3 convs of the flagship forward
SPEED_RUNS = 5  # speed windows, each the middle third of the test frames
CALLS, REPLAYS = 20, 5   # device timing: calls per CUDA graph, replays


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_ms(fn) -> float:
    """Device time of one ``fn()``: CALLS calls captured in a CUDA graph
    (after a warm-up on a side stream, as graph capture requires), the
    graph replayed REPLAYS times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (CALLS * REPLAYS)
    del graph
    return ms


def wrapper_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time of one eager ``fn()``, host work included (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, rtol, atol):
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements out of tolerance, "
             f"max abs err {err.max().item():.3e}")
    return err.max().item()


def phase_build():
    from rtpose_tpu_torch.ops import build
    t0 = time.perf_counter()
    log = build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall")
    for name, rec in log.items():
        info = [l for l in rec["log"].splitlines() if "registers" in l or "spill" in l]
        print(f"[build] {name}: {rec['seconds']:.1f} s; " + " | ".join(l.strip() for l in info))


def phase_preprocess(dev):
    import torch
    from rtpose_tpu_torch.data.cruw_pose import CubeGeometry
    from rtpose_tpu_torch.data.synthetic import ROI1
    from rtpose_tpu_torch.ops import preprocess as pp

    gen = torch.Generator(device=dev).manual_seed(0)
    n0, n1 = 0.0, 10.0
    # a real crop: K2 (one cube) at the flagship ROI of a full cube
    roi = CubeGeometry.from_roi({k: list(v) for k, v in ROI1.items()}).roi_idx
    full = (torch.rand((32, 32, 128, 256), generator=gen, device=dev) * 12 - 1).half()
    got = pp.fused_preprocess(full, roi, n0, n1)
    want = pp.preprocess_reference(full, roi, n0, n1)
    if tuple(got.shape) != (16, 64, 160, 32):
        fail(f"preprocess crop shape {tuple(got.shape)}")
    err = check_close("preprocess crop f16", got, want, PRE_RTOL, 0.0)
    crop_ms = device_ms(lambda: pp.fused_preprocess(full, roi, n0, n1))
    crop_plain_ms = device_ms(lambda: pp.preprocess_reference(full, roi, n0, n1))
    print(f"[preprocess] K2 crop {roi} of (32, 32, 128, 256) f16: max err {err:.3e}, "
          f"{crop_ms:.4f} ms (plain {crop_plain_ms:.4f} ms, bound "
          f"{got.numel() * 6 / PEAK_BYTES * 1e3:.4f} ms)")
    # identity ROI at the batched flagship shape, all input dtypes (K1)
    errs = {}
    for dt in (torch.float16, torch.bfloat16, torch.float32):
        raw = (torch.rand((8, 32, 16, 64, 160), generator=gen, device=dev) * 12 - 1).to(dt)
        ident = (0, 15, 0, 63, 0, 159)
        errs[str(dt)] = check_close(f"preprocess {dt}",
                                    pp.fused_preprocess_batch(raw, ident, n0, n1),
                                    pp.preprocess_reference(raw, ident, n0, n1),
                                    PRE_RTOL, 0.0)
    print(f"[preprocess] identity ROI (8, 32, 16, 64, 160): max err {errs}")
    # timing at the main path's shape: B = 1 f16 identity ROI
    raw1 = (torch.rand((1, 32, 16, 64, 160), generator=gen, device=dev) * 12 - 1).half()
    ident = (0, 15, 0, 63, 0, 159)
    err1 = check_close("preprocess B1", pp.fused_preprocess_batch(raw1, ident, n0, n1),
                       pp.preprocess_reference(raw1, ident, n0, n1), PRE_RTOL, 0.0)
    ms = device_ms(lambda: pp.fused_preprocess_batch(raw1, ident, n0, n1))
    wrap_ms = wrapper_ms(lambda: pp.fused_preprocess_batch(raw1, ident, n0, n1))
    plain_ms = device_ms(lambda: pp.preprocess_reference(raw1, ident, n0, n1))
    raw8 = raw.half()
    ms8 = device_ms(lambda: pp.fused_preprocess_batch(raw8, ident, n0, n1))
    n = raw1.numel()
    bound = n * (2 + 4) / PEAK_BYTES * 1e3
    print(f"[preprocess] B1 f16: {ms:.4f} ms (wrapper {wrap_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms); B8 f16: {ms8:.4f} ms "
          f"(bound {8 * bound:.4f} ms)")
    return dict(name="preprocess", route="cuda",
                source="rtpose_tpu_torch/csrc/preprocess.cu",
                replaces="rtpose_tpu/ops/preprocess.py:173",
                max_abs_err=max([err, err1, *errs.values()]), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=None, wrapper_ms=wrap_ms, b8_ms=ms8, crop_ms=crop_ms,
                shape="(1, 32, 16, 64, 160) f16 -> f32")


# the shapes the main path gives K3: eval B=1 and training B=8, at full
# and half resolution of the flagship grid
K3_SHAPES = ((1, 16, 64, 160), (1, 8, 32, 80), (8, 16, 64, 160), (8, 8, 32, 80))


def k3_row(ms, plain_ms, lib_ms, x, **extra):
    """One K3 launch's numbers: device times, its bound (the larger of its
    operations over the bf16 tensor-core peak and its bytes, input and
    output once and the weights once, over the memory rate), TFLOP/s, the
    share of the bound and the ratio to the library call."""
    flops = 2 * 27 * 32 * 32 * (x.numel() // 32)
    bound = max(flops / PEAK_BF16_FLOPS, (2 * x.numel() * 2 + 27 * 32 * 32 * 2) / PEAK_BYTES) * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                gflop=flops / 1e9, tflops=flops / ms / 1e9, share_of_bound=bound / ms,
                kernel_over_library=ms / lib_ms, **extra)


def k3_print(tag, shape, r):
    print(f"[{tag}] {shape}: {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
          f"{100 * r['share_of_bound']:.1f} % of bound {r['bound_ms']:.4f} ms), plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, kernel / library "
          f"{r['kernel_over_library']:.3f}")


def phase_conv(dev):
    """K3's forward against its plain version at the main path's shapes, a
    ragged shape with bias and B * Z above 65535; two launches
    bit-identical; device times beside the plain version and bf16
    ``F.conv3d`` at the four main-path shapes."""
    import torch
    import torch.nn.functional as F
    from rtpose_tpu_torch.ops import conv_k3 as ck

    gen = torch.Generator(device=dev).manual_seed(1)
    w = (torch.randn((32, 32, 3, 3, 3), generator=gen, device=dev) * (2 / 864) ** 0.5)
    bias = torch.randn((32,), generator=gen, device=dev)
    errs = {}
    cases = [(shape, None) for shape in K3_SHAPES] + [((2, 5, 13, 37), bias),
                                                     ((1, 70000, 2, 3), bias)]
    for shape, b in cases:
        x = torch.randn((*shape, 32), generator=gen, device=dev).to(torch.bfloat16)
        want = ck.conv3d_k3_reference(x, w, b)
        errs[str(shape)] = check_close(
            f"conv {shape}", ck.conv3d_k3(x, w, b), want, CONV_RTOL,
            CONV_ATOL_FRAC * want.float().abs().max().item())
    print(f"[conv] max abs err by shape: {errs}")
    x = torch.randn((8, 16, 64, 160, 32), generator=gen, device=dev).to(torch.bfloat16)
    if not (torch.equal(ck.conv3d_k3(x, w, bias), ck.conv3d_k3(x, w, bias))
            and torch.equal(ck.grad_input(x, w), ck.grad_input(x, w))):
        fail("K3: two launches on the same inputs differ")
    print("[conv] two launches bit-identical at (8, 16, 64, 160), forward and grad-input")
    rows = {}
    wr, _ = ck.prepare(w)
    wb = w.to(torch.bfloat16)
    for shape in K3_SHAPES:
        x = torch.randn((*shape, 32), generator=gen, device=dev).to(torch.bfloat16)
        xc = x.permute(0, 4, 1, 2, 3)
        r = k3_row(device_ms(lambda: ck.launch(x, wr)),
                   device_ms(lambda: ck.conv3d_k3_reference(x, w)),
                   device_ms(lambda: F.conv3d(xc, wb, padding=1)), x,
                   wrapper_ms=wrapper_ms(lambda: ck.conv3d_k3(x, w)),
                   plan=ck.plan(*shape, ck._sm_count(dev.index or 0))._asdict())
        rows[str(shape)] = r
        k3_print("conv", shape, r)
    main = rows[str(K3_SHAPES[0])]
    return dict(name="conv3d_k3", route="cuda", source="rtpose_tpu_torch/csrc/conv_k3.cu",
                replaces="rtpose_tpu/ops/pallas_conv.py:176",
                max_abs_err=max(errs.values()), ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by="operations", library_ms=main["library_ms"],
                wrapper_ms=main["wrapper_ms"], shape="(1, 16, 64, 160, 32) bf16",
                deterministic=True, shapes=rows)


def phase_conv_bwd(dev):
    """K3's backward against its plain versions; device times of grad-input
    (the kernel on flipped weights) beside its plain version and cuDNN's
    bf16 grad-input at the four main-path shapes, and of the library
    grad-weight the port calls."""
    import torch
    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.ops import conv_k3 as ck

    gen = torch.Generator(device=dev).manual_seed(2)
    w = torch.randn((32, 32, 3, 3, 3), generator=gen, device=dev) * (2 / 864) ** 0.5
    bias = torch.randn((32,), generator=gen, device=dev)
    errs, gw_errs = {}, {}
    for shape, b in [((8, 16, 64, 160), None), ((8, 8, 32, 80), None),
                     ((2, 5, 13, 37), bias)]:
        x = torch.randn((*shape, 32), generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn((*shape, 32), generator=gen, device=dev).to(torch.bfloat16)
        xk = x.clone().requires_grad_()
        wk = w.clone().requires_grad_()
        bk = None if b is None else b.clone().requires_grad_()
        ops.reset_launch_counts()
        ck.Conv3dK3.apply(xk, wk, bk).backward(g)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts["conv3d_k3"] != 1 or counts["conv3d_k3_bwd"] != 1:
            fail(f"Conv3dK3 {shape}: launch counts {counts}")
        want = ck.conv3d_k3_reference(g, ck.flip_transpose(w))
        errs[str(shape)] = check_close(f"conv grad-input {shape}", xk.grad, want, CONV_RTOL,
                                       CONV_ATOL_FRAC * want.float().abs().max().item())
        gw_plain = torch.ops.aten.convolution_backward(
            g.float().permute(0, 4, 1, 2, 3), x.float().permute(0, 4, 1, 2, 3),
            w.to(torch.bfloat16).float(), None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
            [0, 0, 0], 1, [False, True, False])[1]
        if wk.grad.dtype != torch.float32:
            fail(f"conv grad-weight dtype {wk.grad.dtype}")
        gw_errs[str(shape)] = check_close(f"conv grad-weight {shape}", wk.grad, gw_plain,
                                          CONV_RTOL, CONV_ATOL_FRAC * gw_plain.abs().max().item())
        if b is not None:
            check_close("conv grad-bias", bk.grad, g.float().sum((0, 1, 2, 3)), 1e-5, 1e-3)
    g = torch.randn((1, 70000, 2, 3, 32), generator=gen, device=dev).to(torch.bfloat16)
    want = ck.conv3d_k3_reference(g, ck.flip_transpose(w))
    errs[str((1, 70000, 2, 3))] = check_close(
        "conv grad-input (1, 70000, 2, 3)", ck.grad_input(g, w), want, CONV_RTOL,
        CONV_ATOL_FRAC * want.float().abs().max().item())
    print(f"[conv bwd] grad-input max abs err by shape: {errs}; grad-weight: {gw_errs}")
    rows = {}
    wrf = ck.prepare_flipped(w)
    wb = w.to(torch.bfloat16)
    wft = ck.flip_transpose(w)
    for shape in K3_SHAPES:
        x = torch.randn((*shape, 32), generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn((*shape, 32), generator=gen, device=dev).to(torch.bfloat16)
        xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)

        def lib_grad(mask):
            return lambda: torch.ops.aten.convolution_backward(
                gc, xc, wb, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, mask)

        r = k3_row(device_ms(lambda: ck.launch(g, wrf)),
                   device_ms(lambda: ck.conv3d_k3_reference(g, wft)),
                   device_ms(lib_grad([True, False, False])), g,
                   wrapper_ms=wrapper_ms(lambda: ck.grad_input(g, w)),
                   grad_weight_ms=device_ms(lambda: ck.grad_weight(x, g, w)),
                   grad_weight_library_call_ms=device_ms(lib_grad([False, True, False])))
        rows[str(shape)] = r
        k3_print("conv bwd grad-input", shape, r)
        print(f"[conv bwd] {shape}: grad-weight (library, the port's call) "
              f"{r['grad_weight_ms']:.4f} ms; bare convolution_backward "
              f"{r['grad_weight_library_call_ms']:.4f} ms")
    main = rows[str(K3_SHAPES[2])]
    return dict(name="conv3d_k3_bwd", route="cuda", source="rtpose_tpu_torch/csrc/conv_k3.cu",
                replaces="rtpose_tpu/ops/pallas_conv.py:215",
                max_abs_err=max(errs.values()), ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by="operations", library_ms=main["library_ms"],
                wrapper_ms=main["wrapper_ms"], shape="(8, 16, 64, 160, 32) bf16 grad-input",
                grad_weight_ms=main["grad_weight_ms"],
                grad_weight_max_abs_err=max(gw_errs.values()), shapes=rows)


def phase_autograd(dev):
    """``TorchConv3d`` bf16 in grad mode on the card: the output carries a
    ``grad_fn`` and the input and weight gradients match autograd of the
    plain version."""
    import torch
    from rtpose_tpu_torch.models.layers import TorchConv3d
    from rtpose_tpu_torch.ops import conv_k3 as ck

    gen = torch.Generator(device=dev).manual_seed(3)
    m = TorchConv3d(32, 32, bias=False, dtype="bfloat16").to(dev)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=gen, device=dev) * 0.06)
    x = torch.randn((2, 16, 64, 160, 32), generator=gen, device=dev).requires_grad_()
    g = torch.randn((2, 16, 64, 160, 32), generator=gen, device=dev).to(torch.bfloat16)
    out = m(x)
    if out.grad_fn is None:
        fail("TorchConv3d in grad mode on the card returned a tensor without grad_fn")
    out.backward(g)
    xr = x.detach().clone().requires_grad_()
    wr = m.weight.detach().clone().requires_grad_()
    ck.conv3d_k3_reference(xr, wr).backward(g)
    if x.grad is None or m.weight.grad is None:
        fail("TorchConv3d in grad mode: no gradient reached the input or the weight")
    gx = check_close("TorchConv3d grad-input", x.grad, xr.grad, CONV_RTOL,
                     CONV_ATOL_FRAC * xr.grad.abs().max().item())
    gw = check_close("TorchConv3d grad-weight", m.weight.grad, wr.grad, CONV_RTOL,
                     CONV_ATOL_FRAC * wr.grad.abs().max().item())
    print(f"[autograd] TorchConv3d grad_fn {type(out.grad_fn).__name__}; grad-input max err "
          f"{gx:.3e}, grad-weight max err {gw:.3e} (max |gw| {wr.grad.abs().max().item():.3f})")


def write_inputs(tmp):
    """A synthetic root of FRAMES test frames at the flagship geometry, with
    each cube stored pre-cropped to the ROI (the shape the loader ships
    under --device_preprocess); a config that runs the flagship file as
    shipped and reads that root; a seeded random checkpoint."""
    import torch
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import generate_synthetic_dataset
    from rtpose_tpu_torch.engine import save_checkpoint
    from rtpose_tpu_torch.models import init_weights

    t0 = time.perf_counter()
    root = os.path.join(tmp, "data")
    generate_synthetic_dataset(root, num_seqs=2, frames_per_seq=1,
                               test_frames_per_seq=FRAMES // 2, seed=0, roi_only=True)
    os.environ["RTPOSE_DATA_ROOT"] = root
    cfg_path = os.path.join(tmp, "hr3d_one_hm_doppler_roi_only.py")
    with open(cfg_path, "w") as f:
        f.write(f"exec(compile(open({FLAGSHIP!r}).read(), {FLAGSHIP!r}, 'exec'))\n"
                "DATASET['DIR']['CUBES_ARE_ROI'] = True\n")
    print(f"[e2e] synthetic root of {FRAMES} test frames: {time.perf_counter() - t0:.1f} s")
    cfg = Config.fromfile(cfg_path)
    model = init_weights(assemble(cfg).model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        # He-init regression outputs are tens of voxels; scale them to the
        # sub-voxel offsets of a trained head (MPJPE on a realistic scale)
        model.pose_head.tasks[0].reg[-1].weight.mul_(0.01)
    ckpt = save_checkpoint(os.path.join(tmp, "random_seed0.pth"), model.state_dict(),
                           meta={"seed": 0})
    return cfg_path, cfg, ckpt


def test_argv(tmp, cfg_path, ckpt):
    return [cfg_path, "--checkpoint", ckpt, "--work_dir", os.path.join(tmp, "work"),
            "--testset", "--device_preprocess", "--speed_test"]


def phase_e2e(tmp, cfg_path, ckpt):
    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.tools import test as port_test

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = port_test.main(test_argv(tmp, cfg_path, ckpt))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[e2e] tools.test: {wall:.1f} s wall, launch counts {counts}")
    mpjpe = out["results"]["MPJPE"]
    if not (mpjpe == mpjpe and 0 < mpjpe < float("inf")):
        fail(f"MPJPE {mpjpe} is not a finite positive number")
    if out["sec_per_frame"] is None:
        fail("no speed-test time")
    if len(out["detections"]) != FRAMES:
        fail(f"{len(out['detections'])} frames decoded, expected {FRAMES}")
    if counts["preprocess"] != FRAMES:
        fail(f"preprocess kernel launched {counts['preprocess']} times, expected {FRAMES}")
    if counts["conv3d_k3"] != 14 * FRAMES:
        fail(f"conv kernel launched {counts['conv3d_k3']} times, expected {14 * FRAMES}")
    print(f"[e2e] MPJPE {mpjpe} mm, {out['sec_per_frame'] * 1e3:.3f} ms/frame at B=1")
    return out, counts


def phase_speed_and_trace(tmp, cfg_path, ckpt, first_ms):
    """SPEED_RUNS - 1 more speed windows of tools.test, then one run traced
    with torch.profiler (device activity only)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rtpose_tpu_torch.tools import test as port_test

    argv = test_argv(tmp, cfg_path, ckpt)
    speed = [first_ms] + [port_test.main(argv)["sec_per_frame"] * 1e3
                          for _ in range(SPEED_RUNS - 1)]
    window = (2 * FRAMES) // 3 - FRAMES // 3
    med = statistics.median(speed)
    print(f"[e2e] speed windows of {window} frames at B=1: {speed} ms/frame; "
          f"median {med}, spread {max(speed) - min(speed)}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        port_test.main(argv)
        torch.cuda.synchronize()
    traced_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        fail("the trace holds no device operation")
    busy = sum(e.self_device_time_total for e in ops) / 1e3 / FRAMES
    n_ops = sum(e.count for e in ops) / FRAMES
    print(f"[trace] {traced_wall:.1f} s traced run, {time.perf_counter() - t0:.1f} s to "
          f"read the trace; device busy {busy} ms/frame, {n_ops} device operations/frame")
    k3 = [e for e in ops if "conv3d_k3_kernel" in e.key]
    print(f"[trace] K3 kernel: {sum(e.self_device_time_total for e in k3) / 1e3 / FRAMES} "
          f"ms/frame in {sum(e.count for e in k3) / FRAMES} launches/frame")
    print(f"[trace] {'device operation':<80} {'ms/frame':>9} {'calls/frame':>11}")
    for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"[trace] {e.key[:80]:<80} {e.self_device_time_total / 1e3 / FRAMES:9.4f} "
              f"{e.count / FRAMES:11.2f}")
    return dict(frames=FRAMES, window_frames=window, speed_ms_per_frame=speed,
                speed_median_ms=med, device_busy_ms_per_frame=busy,
                k3_ms_per_frame=sum(e.self_device_time_total for e in k3) / 1e3 / FRAMES,
                device_ops_per_frame=n_ops, device_idle_share=1 - busy / med)


def phase_cpu_compare(cfg, ckpt, detections, dev):
    """One frame: card (bf16 + kernels) vs CPU (float32), same weights."""
    import copy

    import torch
    from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg
    from rtpose_tpu_torch.core.decode import decode_pose_sparse
    from rtpose_tpu_torch.engine import load_checkpoint, preprocess_raw
    from rtpose_tpu_torch.models import build_detector

    sd = load_checkpoint(ckpt)["state_dict"]
    asm = assemble(cfg)
    gpu = asm.model
    gpu.load_state_dict(sd)
    gpu = gpu.to(dev).eval()
    model_cfg = copy.deepcopy(dict(cfg.model))
    model_cfg["backbone"]["dtype"] = "float32"
    model_cfg["pose_head"]["dtype"] = "float32"
    cpu = build_detector(model_cfg)
    cpu.load_state_dict(sd)
    cpu.eval()

    ds = build_dataset_from_cfg(cfg.data, "test", device_preprocess=True)
    item = ds[0]
    raw = torch.from_numpy(item["rdr_raw"])[None]
    norm = (ds.norm_start, ds.norm_scale)
    spec = asm.decode_spec
    with torch.inference_mode():
        hm_g, reg_g, peak_g = gpu.predict_sparse(preprocess_raw(raw.to(dev), norm))
        kp_g = decode_pose_sparse(hm_g, reg_g, peak_g, spec)[0]
        x_c = preprocess_raw(raw, norm)
        feat_c = cpu.extract_feat(x_c)
        hm_c = cpu.pose_head(feat_c, branch="hm")[0]["hm"]
        B, Z, Y, X, _ = hm_c.shape
        p = peak_g.cpu()
        reg_c = cpu._reg_patches(feat_c, p // (Y * X), (p % (Y * X)) // X, p % X,
                                 (Z, Y, X))
        kp_c = decode_pose_sparse(hm_c, reg_c, p, spec)[0]
    hm_g, reg_g, kp_g = hm_g.float().cpu(), reg_g.float().cpu(), kp_g.cpu()
    span = (hm_c.max() - hm_c.min()).item()
    hm_err = check_close("heatmap logits card vs cpu", hm_g, hm_c, 0.0, E2E_FRAC * span)
    peak_c = int(hm_c.reshape(-1).argmax())
    gap = hm_c.max().item() - hm_c.reshape(-1)[int(p)].item()
    if gap > E2E_FRAC * span:
        fail(f"card peak {int(p)} is {gap:.3f} below the CPU max (peak {peak_c})")
    reg_tol = E2E_FRAC * reg_c.abs().max().item()
    reg_err = check_close("reg at peak card vs cpu", reg_g, reg_c, 0.0, reg_tol)
    vox = torch.tensor(spec.voxel_size_xyz)
    kp_err = (kp_g - kp_c).abs()
    if (kp_err > reg_tol * vox + 1e-5).any():
        fail(f"keypoints card vs cpu: max err {kp_err.max().item():.4f} m")
    key = f"{item['meta']['seq']}/{item['meta']['frame']}/{item['meta']['rdr_frame']}"
    kp_run = torch.tensor([q[1:4] for q in detections[key]["keypoints"]])
    run_err = (kp_run - kp_g[0]).abs()
    if (run_err > reg_tol * vox + 1e-5).any():
        fail(f"tools.test keypoints differ from the direct forward by {run_err.max().item()} m")
    run_err = run_err.max().item()
    print(f"[compare] frame {key}: peaks card {int(p)} cpu {peak_c}; logit range "
          f"{span:.3f}, max err {hm_err:.4f}; reg max err {reg_err:.4f} (max |reg| "
          f"{reg_c.abs().max().item():.3f}); keypoints max err {kp_err.max().item():.5f} m; "
          f"tools.test vs direct {run_err:.2e} m")


def write_train_inputs(tmp):
    """A synthetic root of TRAIN_FRAMES train frames (and 8 test frames) at
    the flagship geometry, cubes stored pre-cropped to the ROI, and a config
    that runs the flagship file as shipped, reads that root and saves a
    checkpoint after every epoch."""
    from rtpose_tpu_torch.data import generate_synthetic_dataset

    t0 = time.perf_counter()
    root = os.path.join(tmp, "train_data")
    generate_synthetic_dataset(root, num_seqs=2, frames_per_seq=TRAIN_FRAMES // 2,
                               test_frames_per_seq=4, seed=1, roi_only=True)
    cfg_path = os.path.join(tmp, "hr3d_one_hm_doppler_train_roi_only.py")
    with open(cfg_path, "w") as f:
        f.write(f"exec(compile(open({FLAGSHIP!r}).read(), {FLAGSHIP!r}, 'exec'))\n"
                f"DATASET['DIR']['ROOT_DIR'] = {root!r}\n"
                "DATASET['DIR']['CUBES_ARE_ROI'] = True\n"
                # a checkpoint after each epoch: the run stops after two
                "checkpoint_config = dict(interval=1)\n")
    print(f"[train] synthetic root of {TRAIN_FRAMES} train frames: "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg_path


def train_argv(cfg_path, work_dir, epochs):
    return [cfg_path, "--work_dir", work_dir, "--device_preprocess", "--seed", "0",
            "--stop_epoch", str(epochs)]


def phase_train(tmp, cfg_path):
    """The port's train CLI on the flagship config: launch counts, finite
    losses, no skipped step, ms/step."""
    import statistics

    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.tools import train as port_train

    work = os.path.join(tmp, "train_work")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = port_train.main(train_argv(cfg_path, work, TRAIN_EPOCHS))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = len(trainer.iter_seconds)
    hist = trainer.log_buffer.val_history
    losses, skipped = hist["loss"], hist["skipped"]
    print(f"[train] tools.train: {steps} steps in {wall:.1f} s wall, launch counts {counts}")
    if steps != TRAIN_EPOCHS * TRAIN_FRAMES // 8:
        fail(f"{steps} train steps, expected {TRAIN_EPOCHS * TRAIN_FRAMES // 8}")
    if len(losses) != steps or not all(v == v and abs(v) < float("inf") for v in losses):
        fail(f"train losses not all finite: {losses}")
    if any(v != 0.0 for v in skipped):
        fail(f"{int(sum(skipped))} train steps skipped")
    want = {"preprocess": steps, "conv3d_k3": K3_PER_STEP * steps,
            "conv3d_k3_bwd": K3_PER_STEP * steps}
    if counts != want:
        fail(f"training launch counts {counts}, expected {want}")
    ckpt = os.path.join(work, "checkpoints", f"epoch_{TRAIN_EPOCHS}.pth")
    if not os.path.isfile(ckpt):
        fail(f"no checkpoint {ckpt}")
    ms = [t * 1e3 for t in trainer.iter_seconds[2:]]      # after two warm-up steps
    med = statistics.median(ms)
    print(f"[train] losses {[round(v, 4) for v in losses]}")
    print(f"[train] ms/step after warm-up (host clock per iteration, B=8): median {med}, "
          f"spread {max(ms) - min(ms)}, min {min(ms)}, max {max(ms)}; "
          f"{8e3 / med} frames/s")
    return dict(steps=steps, batch=8, wall_s=wall, ms_per_step=ms, ms_per_step_median=med,
                ms_per_step_spread=max(ms) - min(ms), frames_per_s=8e3 / med,
                first_step_ms=trainer.iter_seconds[0] * 1e3, losses=losses,
                grad_norm_last=hist["grad_norm"][-1], launches=counts, checkpoint=ckpt)


def phase_train_trace(tmp, cfg_path, median_ms):
    """One more training epoch under torch.profiler: device busy ms/step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rtpose_tpu_torch.tools import train as port_train

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer = port_train.main(train_argv(cfg_path, os.path.join(tmp, "trace_work"), 1))
        torch.cuda.synchronize()
    traced_wall = time.perf_counter() - t0
    steps = len(trainer.iter_seconds)
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        fail("the training trace holds no device operation")
    busy = sum(e.self_device_time_total for e in ops) / 1e3 / steps
    n_ops = sum(e.count for e in ops) / steps
    print(f"[train trace] {steps} steps, {traced_wall:.1f} s traced; device busy {busy} "
          f"ms/step, {n_ops} device operations/step, idle share {1 - busy / median_ms}")
    k3 = [e for e in ops if "conv3d_k3_kernel" in e.key]
    print(f"[train trace] K3 kernel (forward and grad-input): "
          f"{sum(e.self_device_time_total for e in k3) / 1e3 / steps} ms/step in "
          f"{sum(e.count for e in k3) / steps} launches/step")
    print(f"[train trace] {'device operation':<80} {'ms/step':>9} {'calls/step':>10}")
    for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        print(f"[train trace] {e.key[:80]:<80} {e.self_device_time_total / 1e3 / steps:9.4f} "
              f"{e.count / steps:10.2f}")
    return dict(traced_steps=steps, device_busy_ms_per_step=busy,
                k3_ms_per_step=sum(e.self_device_time_total for e in k3) / 1e3 / steps,
                device_ops_per_step=n_ops, device_idle_share=1 - busy / median_ms)


def phase_train_eval(tmp, cfg_path, ckpt):
    """``tools.test`` evaluates the trained checkpoint as written."""
    from rtpose_tpu_torch.tools import test as port_test

    out = port_test.main([cfg_path, "--checkpoint", ckpt, "--work_dir",
                          os.path.join(tmp, "train_eval"), "--testset", "--device_preprocess"])
    mpjpe = out["results"]["MPJPE"]
    if not (mpjpe == mpjpe and 0 < mpjpe < float("inf")) or len(out["detections"]) != 8:
        fail(f"evaluating the trained checkpoint: MPJPE {mpjpe}, "
             f"{len(out['detections'])} frames")
    print(f"[train] tools.test on the trained checkpoint: MPJPE {mpjpe} mm over 8 frames")
    return mpjpe


def phase_train_compare(cfg_path, dev):
    """One train step's loss and gradients, B=1: card (bf16 + kernels)
    against CPU (float32), same seeded weights and sample."""
    import copy

    import torch
    from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.engine import make_loss_fn
    from rtpose_tpu_torch.models import build_detector, init_weights

    cfg = Config.fromfile(cfg_path)
    asm = assemble(cfg)
    model_cfg = copy.deepcopy(dict(cfg.model))
    model_cfg["backbone"]["dtype"] = "float32"
    model_cfg["pose_head"]["dtype"] = "float32"
    gpu = init_weights(asm.model, torch.Generator().manual_seed(0))
    cpu = build_detector(model_cfg)
    cpu.load_state_dict(gpu.state_dict())
    gpu = gpu.to(dev)
    ds = build_dataset_from_cfg(cfg.data, "train", device_preprocess=True)
    item = ds[0]
    norm = (ds.norm_start, ds.norm_scale)

    def loss_and_grads(model, device):
        batch = {k: torch.from_numpy(item[k])[None].to(device)
                 for k in ("rdr_raw", "poses")}
        batch["num_poses"] = torch.tensor([int(item["num_poses"])], device=device)
        loss_fn = make_loss_fn(model, model.pose_head, asm.target_spec, sparse_reg=True,
                               preprocess=norm)
        loss, losses = loss_fn(batch, torch.zeros((), dtype=torch.int64, device=device))
        loss.backward()
        g = torch.cat([p.grad.reshape(-1).float().cpu() for p in model.parameters()])
        return (float(loss.detach()), float(losses["hm_loss"][0].detach()),
                float(losses["loc_loss"][0].detach()), g)

    t0 = time.perf_counter()
    lg, hg, cg, gg = loss_and_grads(gpu, dev)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    lc, hc, cc, gc = loss_and_grads(cpu, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    ng, nc = gg.norm().item(), gc.norm().item()
    cos = float(torch.dot(gg.double(), gc.double()) / (gg.double().norm() * gc.double().norm()))
    rel_loss, rel_norm = abs(lg - lc) / abs(lc), abs(ng - nc) / nc
    print(f"[train compare] B=1 step: loss card {lg} cpu {lc} (rel {rel_loss:.2e}; hm {hg} / "
          f"{hc}, loc {cg} / {cc}); grad norm card {ng} cpu {nc} (rel {rel_norm:.2e}); "
          f"cosine {cos}; {t_gpu:.1f} s card, {t_cpu:.1f} s CPU")
    if not torch.isfinite(gg).all():
        fail("card gradients not finite")
    if rel_loss > TRAIN_LOSS_RTOL:
        fail(f"train loss card vs cpu off by {rel_loss:.3e} relative")
    if rel_norm > TRAIN_GNORM_RTOL:
        fail(f"grad norm card vs cpu off by {rel_norm:.3e} relative")
    if cos < TRAIN_MIN_COS:
        fail(f"gradient cosine card vs cpu {cos}")
    return dict(loss_rel_err=rel_loss, grad_norm_rel_err=rel_norm, grad_cosine=cos)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "rtpose_tpu_torch")) or not os.path.isfile(FLAGSHIP):
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from rtpose_tpu_torch.api import resolve_device

    t_all = time.perf_counter()
    smi = smi_line()
    print(f"[card] {smi}")
    dev = resolve_device("cuda")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    phase_build()
    kernels = [phase_preprocess(dev), phase_conv(dev), phase_conv_bwd(dev)]
    phase_autograd(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path, cfg, ckpt = write_inputs(tmp)
        out, counts = phase_e2e(tmp, cfg_path, ckpt)
        e2e = phase_speed_and_trace(tmp, cfg_path, ckpt, out["sec_per_frame"] * 1e3)
        phase_cpu_compare(cfg, ckpt, out["detections"], dev)
        train_cfg = write_train_inputs(tmp)
        train = phase_train(tmp, train_cfg)
        train.update(phase_train_trace(tmp, train_cfg, train["ms_per_step_median"]))
        train["trained_mpjpe_mm"] = phase_train_eval(tmp, train_cfg, train.pop("checkpoint"))
        train.update(phase_train_compare(train_cfg, dev))
    tc = train["launches"]
    kernels[0]["launches"] = counts["preprocess"]
    kernels[1]["launches"] = counts["conv3d_k3"]
    kernels[2]["launches"] = tc["conv3d_k3_bwd"]
    for k, name in zip(kernels, ("preprocess", "conv3d_k3", "conv3d_k3_bwd")):
        k["kernel_ms"] = k["ms"]
        k["train_launches"] = tc[name]
    e2e["mpjpe_mm"] = out["results"]["MPJPE"]
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"train": train}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
