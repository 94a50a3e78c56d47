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
  4b. the deformable-conv kernel (``ops.deform_conv``) at the deformable
     head's cell shape, (128, 64, 160, 128) -> 128 with 4 groups: against its
     arithmetic in stock ops, no coarser than the plain bf16 route against
     float32, two launches bit-identical; device time beside the plain
     route's and the bound;
  4c. the GroupNorm kernel (``ops.group_norm``) at the flagship trunk's five
     shapes at B=1 and B=8: against the plain bf16 route (one bf16 ulp plus
     2^-16 of the range), two launches bit-identical; device time beside the
     plain route's and its byte bound (6 bytes an element), each shape and
     the trunk's 48 calls summed;
  4d. the trilinear resize kernel (``ops.interpolate``) at the 13 resizes of
     a forward of the flagship trunk and of ``_phase``'s, at B=1 and B=8
     (the fuse's with their addend, the final fuse's into their slices of
     the concat): against ``F.interpolate`` (one bf16 ulp, the share of
     bit-equal elements printed), two launches bit-identical; device time of
     the 13 launches beside the plain route's (permute, ``F.interpolate``,
     copy, add or concat) and ``F.interpolate``'s alone, and the byte bound
     (input, addend and output once);
  5. the flagship eval path end to end: a synthetic ROI-only dataset of
     300 test frames at the flagship geometry, seeded random weights saved
     as .pth, and ``rtpose_tpu_torch.tools.test`` on configs/cruw_pose/
     hr3d_one_hm_doppler.py with --device_preprocess --speed_test (each
     speed window is the middle third: 100 frames at B=1);
  6. launch counts of that run: the eval step's CUDA graph engaged (one
     eager call, one capture, a replay for each other frame) and the
     wrappers passed by three forwards (eager, the capture's warm-up, the
     capture);
  7. four more speed windows, then one run under torch.profiler: device
     time and operations per frame, the card's idle share, the kernels
     with the most device time, and every kernel of the path launched
     (preprocess once per forward, conv 14 times, GroupNorm 48, the resize
     13), counted by symbol in the trace and checked against the wrappers
     and the graph replays;
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
     against the CPU in float32, same weights and sample, B=1;
 15. the device cache's content: ``DeviceCachedLoader`` against
     ``BatchLoader`` over one epoch on the card (same indices, bit-equal
     tensors), and bf16 / float8_e4m3fn caches equal to the cast of the same
     rows with the labels untouched; the cache's bytes;
 16. ``tools.train --device_cache``, per step: the losses against the host
     loader's run (phase 11) of the same seed, ms/step;
 17. ``tools.train --device_cache --fuse_epochs``: every step a replay of
     one captured CUDA graph (replays = steps; the wrappers' launch counts
     read the warm-up step and the capture and nothing else), finite
     losses, the first three steps' losses and the final parameters against
     phase 16's, ms/step (epoch time over steps), then one more fused epoch
     under torch.profiler: the kernels the replays launched, counted by
     name in the trace (preprocess once and the conv 28 times per step),
     device ms/step and the idle share; and the comparison's control: the
     same run with 1.2 times the config's peak lr must fall outside the
     tolerances that held the right one;
 18. ``tools.train --stream_cache_gb``: one epoch over four chunks, every
     sample once, at most two chunks resident, ms/step;
 19. ``tools.train --device_cache --profile 5``: the Chrome trace exists and
     holds the CUDA kernels;
 20. ``_skel_mp2`` (two people a frame) on a root of the port's generator:
     two training epochs at B=8 with --device_preprocess (1 preprocess, 14
     conv and 14 grad-input launches a step), one more traced, tools.test on
     the checkpoint (traced; 30 joints a frame, 14 conv launches a forward),
     one frame card vs CPU and the multi-peak decode of the same float32
     outputs on both, a bf16 tools.export artifact against the live model;
 21. ``_dcn`` (the deformable head) on the training root: one epoch at B=8
     (the same counts; training takes the deformable conv's plain route),
     one more traced (the deformable gather and its scatter-add backward by
     kernel), peak device memory, tools.test (traced; the deformable-conv
     kernel twice a forward), one frame card vs CPU;
 22. ``_phase`` (complex 64-channel cubes, B=1): one epoch, one more traced,
     tools.test (traced); no kernel launched (complex cubes opt out of the
     card preprocess, no conv has the K3 shape);
 23. ``_skel480x2`` (RepeatDataset x2) on the training root: one epoch of
     twice its child's steps;
 24. the LiDAR branch (``configs/lidar/voxelnet_pose.py``, VoxelNet on voxel
     batches) on a LiDAR-only root of the port's generator: two training
     epochs at B=8 (the conv 6 times a step forward and 6 grad-input, no
     preprocess), one more traced (device ms/step, idle share, the voxel
     scatter's ``index_add_``), two fused epochs over the device cache,
     tools.test on the checkpoint (traced, and three ``--speed_test``
     windows), the same with the double-flip TTA (4 forwards a
     frame), ``voxelize`` of the test clouds on the card against the CPU
     (equal, ``voxels`` bit for bit), one frame card vs CPU (seeded
     weights), a bf16 and an int8 tools.export artifact against the live
     model (the conv kernel, or the int8 one, 6 times a forward);
 25. data parallelism: ``python -m torch.distributed.run --standalone
     --nproc_per_node <cards>`` over this script's ``--dp_worker`` mode, one
     rank per card (NCCL): ``tools.train --multihost --device_preprocess``
     for two epochs at B=8 a rank (launch counts as phase 11; two
     all-reduces a step; the per-step losses and final parameters against
     phase 11's at one card), one more epoch of its steps traced (device
     ms of NCCL's kernels a step, the bytes all-reduced, K1 / K3 by name);
     the same with ``--device_cache --cache_shard --fuse_epochs`` (the
     capture holds three collectives a step; a traced fused epoch counts
     NCCL's kernels by name; against phase 16's run at one card), the
     sharded cache's batches against a replicated cache's bit for bit and
     its exchange's time; ``tools.test --multihost`` on the checkpoint:
     every test frame gathered, MPJPE equal to the one-process
     ``tools.test``; only rank 0 wrote logs and checkpoints; the ranks'
     parameters equal.  NCCL launches no kernel for a one-rank in-place
     sum, so at one card the traces hold no NCCL kernel, and none is
     expected;
 26. the rest of the JAX package's surface: ``tools.test`` on the flagship
     with ``DATASET.EVAL_BOX_AP`` and the host loader, once through the
     native C++ cube loader and once through the numpy path (box AP beside
     MPJPE, the same detections evaluated again by the port's evaluation
     and equal, eval ms/frame of both, no preprocess launch and 14 conv
     launches a frame; one cube of both host paths at most one ulp apart);
     ``boxes_iou3d`` / ``rotate_nms`` on 512 seeded boxes and ``circle_nms``,
     card against CPU (IoUs within 1e-5, equal keep lists); the RPN neck at
     the reference's default widths on a seeded (8, 16, 64, 160, 128)
     feature, train-mode forward and backward, card against CPU (outputs,
     running statistics, the input gradient's norm) and its device time;
     ``PolarToCart`` (2-D and 3-D), ``BEVFeatureExtractor``, ``RoIHead``
     and ``assign_roi_targets``, card against CPU; the LiDAR VoxelNet
     distilled into the flagship RadarPoseNet (final width 64) at B=2, the
     teacher frozen through ``utils.freeze``: three AdamW steps of
     ``distill_loss`` (per step 1 preprocess, 14 + 6 conv and 14 grad-input
     launches), the teacher bit-equal after them and the student moved, ms a
     step, the first loss against the CPU in float32 within phase 14's 2 %;
 27. the per-segment breakdown (``rtpose_tpu_torch.tools.perf_breakdown``)
     in a process of its own (``--breakdown_worker``) at full width on
     seeded weights: the inference segments (backbone, hm
     tower, peak argmax, sparse reg patches, the whole ``predict_sparse``)
     in bf16, int8 and int8 with the resizes at B=1 and B=8, the train
     segments (targets, loss forward, forward + backward, optimizer, the
     whole step), the backbone's stages and the hm tower's convs at B=8:
     device ms (the profiler's device operations over the calls), host ms,
     GFLOP and utilization per segment; each segment's K3 launches a call
     (14 a forward, 14 grad-input a step), the segments' sum against the
     whole predict, and ``utils.flops.estimate_flops`` on the card equal to
     the CPU's for ``predict_sparse`` (bf16, int8) and one loss forward +
     backward at B=1.
Kernel times (``ms``, ``plain_ms``, ``library_ms``) are device times:
``CALLS`` calls captured in one CUDA graph, replayed between CUDA events,
so no host work falls in the window; ``wrapper_ms`` times the Python
wrapper called eagerly, host work included.
Prints a ``{"e2e": ...}`` line, a ``{"train": ...}`` line, a
``{"serving": ...}`` line, a ``{"slices": ...}`` line (phases 20-24), a
``{"dp": ...}`` line (phase 25, rank 0's numbers), a ``{"rest": ...}`` line
(phase 26), a ``{"breakdown": ...}`` line (phase 27), a ``{"kernels": [...]}``
line, then the nvidia-smi line again, then ``{"ok": true, "device": {...}}`` as the last line.  Each kernel's
``launches`` is its wrapper's count on its own path (eval for the
preprocess and forward conv kernels, training for the conv backward; the
single-cube preprocess form is on no path of the port, as in the JAX
package: its count is read over the eval and training runs and is 0);
``train_launches`` gives every kernel's count on the per-step training
path.  The replays of a fused epoch pass no wrapper, so the fused path's
launches are kernels counted by name in the traced fused epoch
(``fused_trace_launches``; the conv's forward and grad-input are one kernel
symbol and are counted together).  ``path_launches`` gives each kernel's
count on each slice path's own runs (phases 20-24; the LiDAR path's TTA
eval and its two artifacts too), on phase 25's rank 0 and on phase 26's
box-AP evals and distillation steps.  The eval step's CUDA-graph replays
pass no wrapper either: a ``tools.test`` run's counts (phase 7's from its
traced run, the slices', phase 25's and 26's) add ``replays x
launches_per_replay`` to the wrappers' and are checked against K1's and
K3's launches counted by symbol in the run's CUDA-only trace
(``eval_launches``); a capture's warm-up is one forward more than the run's
frames or batches.
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
PEAK_INT8_OPS = 1979e12
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

# Losses of two training runs of the same seed and order (host loader, device
# cache, fused epochs).  The runs are not bit-equal: the trilinear upsample's
# backward adds with atomics, in an order that changes from run to run, and
# Adam turns a last-bit difference into a full lr step of some elements; on
# the steep first steps of the one-cycle ramp this grows (measured: single
# steps 6-28 % apart around steps 9-11, then together again).  Held: the
# first step (same weights, same batch) to 1e-3 relative; the next two, which
# see the first updates (lr, weight decay, the next batches) before the
# noise has grown, to 2 % (twelve runs on an H100 spread 0.37 % at step 1
# and 0.83 % at step 2); each epoch's mean loss (12 steps) to 3 % (the same
# runs: at most 0.81 %).  The JSON log's own interval records are not
# compared: the per-step loop averages the last 20 steps at an epoch's end,
# reaching into the epoch before, a fused epoch its own 12.
RUN_FIRST_LOSS_RTOL, RUN_EARLY_LOSS_RTOL, RUN_EPOCH_MEAN_RTOL = 1e-3, 0.02, 0.03
# Final parameters of two such runs: the distance between them, relative to
# the distance the reference run moved from the seeded weights.  Two
# per-step runs (host loader, device cache) measured 0.38-0.45 apart; a run
# that never updated reads 1.0, two unrelated directions ~1.4.  Held: every
# pair to 0.6, and the fused run to the noise of this very run: at most
# 1.5 times the host-vs-cache distance printed before it
RUN_PARAM_REL_DIST, RUN_PARAM_NOISE_FACTOR = 0.6, 1.5
STREAM_GB = 0.3    # --stream_cache_gb: chunks of 24 frames, four on the 96-frame root

# int8 serving.  The int8 K3 kernel equals its plain version bit for bit
# (the same exact integer sums, the same float32 multiply and add, one
# rounding): compared with torch.equal.  Card (bf16 activations + kernels)
# vs CPU (float32), both int8 with the same scales: the two round different
# activations to a different int8 value at the 51 sites, and the flips
# compound; CPU runs of the port at the tiny grid (8, 16, 32), bf16 against
# float32 both int8, differed by 7-9 % of the heatmap logit range and 3-13 %
# of max |reg| (int8 against float32 alone: 8-11 %).  Allowed: 25 % of each,
# and the bf16 peak of a frame within 25 % of the range of the int8 max.
INT8_E2E_FRAC = 0.25
INT8_SITES = 51     # int8 sites of the flagship at the default exclusion
# the bf16 artifact runs the live model's operations on the same weights
SERVE_ARTIFACT_ATOL_M = 1e-5
SERVE_BATCHES = (8, 32)   # throughput rows, and B of the tools.test artifacts
SERVE_CALLS = 10

FRAMES = 300    # test frames of the synthetic root (2 sequences x 150)
TRAIN_FRAMES = 96   # train frames of the training root (2 sequences x 48)
TRAIN_EPOCHS = 2    # --stop_epoch of the training run
K3_PER_STEP = 14    # stride-1 32->32 3x3x3 convs of the flagship forward
# GroupNorms of an eval forward (bf16, no grad: the GroupNorm kernel's); none
# in training, where the plain version keeps the gradient.  The flagship
# trunk's 48 (the LiDAR backbone's too); ``_phase`` adds its head's
# shared_conv GroupNorm, once (the sparse path applies it densely)
GN_PER_FORWARD = 48
GN_PHASE = 49
# trilinear resizes of an eval forward of a four-branch trunk (bf16, no
# grad: the resize kernel's): 1 + 3 + 6 in the fuses of stages 2-4, 3 in the
# final fuse; none in training, where the plain version keeps the gradient
RS_PER_FORWARD = 13
SPEED_RUNS = 5  # speed windows, each the middle third of the test frames
CALLS, REPLAYS = 20, 5   # device timing: calls per CUDA graph, replays
TRACE_EDGE_S = 0.1  # idle card between a traced epoch and its trace window's edges
TRACE_LEAD_S = 1.0  # idle card at either edge of a traced run (``cuda_trace``)
TRACE_SPINS = 256   # spin kernels ahead of a traced run (``cuda_trace``)


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
    k1 = dict(name="preprocess", route="cuda",
              source="rtpose_tpu_torch/csrc/preprocess.cu",
              replaces="rtpose_tpu/ops/preprocess.py:173",
              max_abs_err=max([err1, *errs.values()]), ms=ms,
              plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
              library_ms=None, wrapper_ms=wrap_ms, b8_ms=ms8,
              shape="(1, 32, 16, 64, 160) f16 -> f32")
    # K2, the single-cube form: the B = 1 launch of the same kernel through
    # ``fused_preprocess``; no path of the port (or of the JAX package) calls it
    k2 = dict(name="preprocess_single", route="cuda",
              source="rtpose_tpu_torch/csrc/preprocess.cu",
              replaces="rtpose_tpu/ops/preprocess.py:95", max_abs_err=err, ms=crop_ms,
              plain_ms=crop_plain_ms, bound_ms=got.numel() * 6 / PEAK_BYTES * 1e3,
              bound_by="bytes", library_ms=None, on_main_path=False,
              shape="(32, 32, 128, 256) f16, ROI crop -> (16, 64, 160, 32) f32")
    return k1, k2


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
    from rtpose_tpu_torch.ops import build
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
                   plan=ck.plan(*shape, build.sm_count(dev))._asdict())
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


def int8_row(ms, plain_ms, stock_ms, bf16_ms, xq, **extra):
    """One int8 K3 launch's numbers: device times, its bound (the larger of
    its int8 operations over the int8 tensor-core peak and its bytes, the
    int8 input and bf16 output once, weights and scales once, over the
    memory rate), TOPS and the share of the bound."""
    n = xq.numel() // 32
    ops = 2 * 27 * 32 * 32 * n
    nbytes = n * 32 + n * 32 * 2 + 27 * 32 * 32 + 32 * 4
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    return dict(ms=ms, plain_ms=plain_ms, stock_ms=stock_ms, k3_bf16_ms=bf16_ms,
                library_ms=None, bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gop=ops / 1e9, tops=ops / ms / 1e9, share_of_bound=bound / ms,
                kernel_over_stock=ms / stock_ms, kernel_over_bf16_k3=ms / bf16_ms, **extra)


# the cell hrradarpose_dcn.eval_b8's deformable convs: B * Z images, H, W, C
# (-> C), deformable groups
DEFORM_SHAPE = (128, 64, 160, 128)
DEFORM_GROUPS = 4


def phase_deform(dev):
    """The deformable-conv kernel at the cell's shape, offsets drawn as the
    head's offset conv gives them (1x1 weights N(0, 0.05^2)): against its
    arithmetic in stock ops (``kernel_reference``, one bf16 ulp plus 2e-3 of
    the output range), both and the plain bf16 route against float32 (the
    kernel no coarser), two launches bit-identical; device times of the
    kernel (``device_ms``) and of the plain route (CUDA events around eager
    calls: a graph of ``CALLS`` would hold their ~6 GB of columns each)
    beside the bound."""
    import torch
    from rtpose_tpu_torch.ops import deform_conv as dc

    B, H, W, C = DEFORM_SHAPE
    dg = DEFORM_GROUPS
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(DEFORM_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    off = (x.float() @ (torch.randn(C, dg * 18, generator=gen, device=dev)
                        * DCN_OFFSET_STD)).contiguous()
    w = (torch.randn(3, 3, C, C, generator=gen, device=dev) / (9 * C) ** 0.5).to(torch.bfloat16)

    def plain():
        with torch.enable_grad():
            return dc.deform_conv2d(x.detach().requires_grad_(), off, w,
                                    deformable_groups=dg).detach()

    with torch.inference_mode():
        got = dc.deform_conv2d(x, off, w, deformable_groups=dg)
        mirror = dc.kernel_reference(x, off, w, 1, dg)
        err = check_close("deform kernel", got, mirror, CONV_RTOL,
                          CONV_ATOL_FRAC * mirror.float().abs().max().item())
        if not torch.equal(got, dc.deform_conv2d(x, off, w, deformable_groups=dg)):
            fail("deform kernel: two launches on the same inputs differ")
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        want = dc.deform_conv2d(x.float(), off, w.float(), deformable_groups=dg)
        torch.backends.cuda.matmul.allow_tf32 = saved
    slow = plain()
    ek, ep = (got.float() - want).abs(), (slow.float() - want).abs()
    errs = dict(kernel_max=ek.max().item(), kernel_mean=ek.mean().item(),
                plain_max=ep.max().item(), plain_mean=ep.mean().item())
    if errs["kernel_max"] > errs["plain_max"] or errs["kernel_mean"] > errs["plain_mean"]:
        fail(f"deform kernel: coarser than the plain bf16 route against float32: {errs}")
    del got, mirror, want, slow, ek, ep
    with torch.inference_mode():
        ms = device_ms(lambda: dc.launch(x, off, w, 1, dg))
        wrap = wrapper_ms(lambda: dc.deform_conv2d(x, off, w, deformable_groups=dg), 20, 3)
    plain_ms = wrapper_ms(plain, 3, 1)
    positions = B * H * W
    flops = 2 * positions * 9 * C * C
    nbytes = x.numel() * 2 + off.numel() * 4 + positions * C * 2
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    print(f"[deform] ({B}, {H}, {W}, {C}) -> {C}, dg {dg}: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s, {100 * bound / ms:.1f} % of bound {bound:.4f} ms), wrapper {wrap:.4f} ms, "
          f"plain {plain_ms:.4f} ms; max err vs kernel_reference {err:.3e}; vs float32 {errs}")
    return dict(name="deform_conv2d", route="cuda", source="rtpose_tpu_torch/csrc/deform_conv.cu",
                replaces=None, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES
                else "bytes", library_ms=None, wrapper_ms=wrap, gflop=flops / 1e9,
                share_of_bound=bound / ms, vs_float32=errs, deterministic=True,
                shape=f"({B}, {H}, {W}, {C}) bf16, dg {dg} -> {C}")


# the flagship trunk's GroupNorm inputs a frame: (Z, Y, X), C, calls
GN_SHAPES = (((16, 64, 160), 32, 15), ((8, 32, 80), 32, 16), ((4, 16, 40), 64, 10),
             ((4, 16, 40), 32, 2), ((2, 8, 20), 64, 5))


def phase_group_norm(dev):
    """The GroupNorm kernel at each of the trunk's shapes, B=1 and B=8,
    inputs x 3 + 1 and a random affine: against the plain bf16 route (one
    bf16 ulp plus 2^-16 of the range), two launches bit-identical; device
    times of the kernel and the plain route (``device_ms``) beside the
    bound, 6 bytes an element (x read for the statistics, read again and
    written) over the memory rate; each shape, and the 48 calls of a
    trunk's forward summed."""
    import torch
    from rtpose_tpu_torch.models import GroupNorm8
    from rtpose_tpu_torch.ops import group_norm as gn

    rows, trunk = [], {}
    err = 0.0
    for B in (1, 8):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for zyx, C, calls in GN_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(11)
            x = (torch.randn((B, *zyx, C), generator=gen, device=dev) * 3 + 1).to(torch.bfloat16)
            m = GroupNorm8(C).to(dev)
            with torch.inference_mode():
                m.weight.copy_(torch.randn(C, generator=gen, device=dev))
                m.bias.copy_(torch.randn(C, generator=gen, device=dev))
                got = m(x)
                if not torch.equal(got, m(x)):
                    fail(f"GroupNorm kernel {(B, *zyx, C)}: two launches on the same inputs "
                         "differ")
                want = gn.group_norm_reference(x, m.weight, m.bias, m.groups, m.eps)
                err = max(err, check_close(f"GroupNorm kernel {(B, *zyx, C)}", got, want,
                                           CONV_RTOL,
                                           2.0 ** -16 * want.float().abs().max().item()))
                ms = device_ms(lambda: m(x))
                plain_ms = device_ms(lambda: gn.group_norm_reference(x, m.weight, m.bias,
                                                                     m.groups, m.eps))
            bound = x.numel() * 6 / PEAK_BYTES * 1e3
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound)):
                tot[k] += calls * v
            rows.append(dict(shape=(B, *zyx, C), calls=calls, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, share_of_bound=bound / ms))
            print(f"[group_norm] {(B, *zyx, C)} x {calls}: {ms:.4f} ms ({100 * bound / ms:.1f} % "
                  f"of bound {bound:.4f} ms), plain {plain_ms:.4f} ms")
        tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
        trunk[f"B{B}"] = tot
        print(f"[group_norm] trunk at B={B} (48 calls): {tot['ms']:.4f} ms "
              f"({100 * tot['share_of_bound']:.1f} % of bound {tot['bound_ms']:.4f} ms), plain "
              f"{tot['plain_ms']:.4f} ms; max err vs plain {err:.3e}")
    return dict(name="group_norm", route="cuda", source="rtpose_tpu_torch/csrc/group_norm.cu",
                replaces=None, max_abs_err=err, ms=trunk["B1"]["ms"],
                plain_ms=trunk["B1"]["plain_ms"], bound_ms=trunk["B1"]["bound_ms"],
                bound_by="bytes", library_ms=None, share_of_bound=trunk["B1"]["share_of_bound"],
                trunk=trunk, shapes=rows, deterministic=True,
                shape="the trunk's 48 GroupNorms of a forward (ms: B=1; trunk: B=1 and B=8)")


def bf16_ulps(got, want):
    """The largest |got - want| in bf16 ulps of ``want`` (the spacing at
    |want|, at least at 2^-8 of the largest |want|)."""
    import torch
    w = want.float().abs()
    w = w.clamp_min(w.max().item() * 2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def phase_resize(dev):
    """The resize kernel at the 13 resizes of a forward of the flagship
    trunk and of ``_phase``'s, B=1 and B=8, inputs and addends N(0, 9): each
    against ``F.interpolate`` (one bf16 ulp), the addend's epilogue equal to
    ``addend + resize`` and the final fuse's slices to the resize, two
    launches bit-identical, one launch counted a call; device times
    (``device_ms``) of each call and of the 13 together on the kernel, the
    plain route (``resize_reference``: permute, ``F.interpolate``, copy, add
    or slice copy) and ``F.interpolate`` alone on a channels-first input,
    beside the byte bound (input, addend and output once)."""
    import torch
    import torch.nn.functional as F
    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.models.hrnet3d import MODEL_CONFIGS, resize_calls
    from rtpose_tpu_torch.ops import interpolate as rs

    trunks, rows = {}, []
    worst, eq_min = 0.0, 1.0
    for model, cfg in (("flagship", "hr_tiny_feat32_zyx_l4_in32"),
                       ("phase", "hr_tiny_feat64_zyx_l4_in64")):
        chans = MODEL_CONFIGS[cfg]["stage4"]["num_channels"]
        for B in (1, 8):
            gen = torch.Generator(device=dev).manual_seed(13)

            def randn(*shape):
                return (torch.randn(shape, generator=gen, device=dev) * 3).to(torch.bfloat16)

            cat = torch.empty((B, 16, 64, 160, sum(chans)), dtype=torch.bfloat16, device=dev)
            c0, cases = chans[0], []
            for zin, zout, C, add in resize_calls(cfg, (16, 64, 160)):
                dst = None if add else cat[..., c0:c0 + C]
                c0 += 0 if add else C
                cases.append((randn(B, *zin, C), zout, randn(B, *zout, C) if add else None, dst))
            tot = dict(ms=0.0, bound_ms=0.0)
            with torch.inference_mode():
                for x, size, a, dst in cases:
                    tag = f"resize {model} {tuple(x.shape)} -> {size}"
                    if not rs.kernel_route(x, size, a, dst):
                        fail(f"{tag}: not on the kernel's route")
                    ops.reset_launch_counts()
                    got = rs.resize_trilinear_align_corners(x, size)
                    if not torch.equal(got, rs.resize_trilinear_align_corners(x, size)):
                        fail(f"{tag}: two launches on the same input differ")
                    lib = F.interpolate(x.permute(0, 4, 1, 2, 3), size=size, mode="trilinear",
                                        align_corners=True).permute(0, 2, 3, 4, 1)
                    u, eq = bf16_ulps(got, lib), (got == lib).float().mean().item()
                    worst, eq_min = max(worst, u), min(eq_min, eq)
                    if u > 1.0:
                        fail(f"{tag}: {u} bf16 ulps from F.interpolate")
                    if a is not None:
                        if not torch.equal(rs.resize_trilinear_align_corners(x, size, addend=a),
                                           a + got):
                            fail(f"{tag}: the addend's epilogue is not addend + resize")
                    else:
                        rs.resize_trilinear_align_corners(x, size, out=dst)
                        if not torch.equal(dst, got):
                            fail(f"{tag}: the slice written is not the resize")
                    if ops.launch_counts()["resize_trilinear"] != 3:
                        fail(f"{tag}: {ops.launch_counts()} launches, expected 3")
                    ms = device_ms(lambda: rs.resize_trilinear_align_corners(x, size, a, dst))
                    nbytes = 2 * (x.numel() + (1 if a is None else 2) * got.numel())
                    bound = nbytes / PEAK_BYTES * 1e3
                    tot["ms"] += ms
                    tot["bound_ms"] += bound
                    rows.append(dict(model=model, shape=tuple(x.shape), size=size,
                                     addend=a is not None, ms=ms, bound_ms=bound,
                                     share_of_bound=bound / ms, bf16_ulps=u, bit_equal=eq))
                    print(f"[resize] {tag}{' + addend' if a is not None else ''}: {ms:.4f} ms "
                          f"({100 * bound / ms:.1f} % of bound {bound:.4f} ms), {u} ulps, "
                          f"{100 * eq:.4f} % bit-equal to F.interpolate")
                tot["together_ms"] = device_ms(
                    lambda: [rs.resize_trilinear_align_corners(*c) for c in cases])
                tot["plain_ms"] = device_ms(lambda: [rs.resize_reference(*c) for c in cases])
                cf = [(x.permute(0, 4, 1, 2, 3).contiguous(), size) for x, size, _, _ in cases]
                tot["library_ms"] = device_ms(lambda: [
                    F.interpolate(x, size=size, mode="trilinear", align_corners=True)
                    for x, size in cf])
            tot["share_of_bound"] = tot["bound_ms"] / tot["together_ms"]
            trunks[f"{model}_B{B}"] = tot
            print(f"[resize] {model} at B={B} ({len(cases)} resizes): {tot['together_ms']:.4f} "
                  f"ms ({100 * tot['share_of_bound']:.1f} % of bound {tot['bound_ms']:.4f} ms; "
                  f"one at a time {tot['ms']:.4f}), plain {tot['plain_ms']:.4f} ms, "
                  f"F.interpolate {tot['library_ms']:.4f} ms")
    print(f"[resize] worst {worst} bf16 ulps, at least {100 * eq_min:.4f} % bit-equal")
    f1 = trunks["flagship_B1"]
    return dict(name="resize_trilinear", route="cuda",
                source="rtpose_tpu_torch/csrc/resize_trilinear.cu", replaces=None,
                max_bf16_ulps=worst, min_bit_equal_share=eq_min, ms=f1["together_ms"],
                plain_ms=f1["plain_ms"], bound_ms=f1["bound_ms"], bound_by="bytes",
                library_ms=f1["library_ms"], share_of_bound=f1["share_of_bound"],
                trunks=trunks, shapes=rows, deterministic=True,
                shape="the flagship trunk's 13 resizes of a forward (ms: B=1; trunks: "
                      "flagship and _phase, B=1 and B=8)")


def phase_conv_int8(dev):
    """The int8 K3 kernel against its plain version, bit for bit, at the main
    path's four shapes (bf16 and float32 out), ragged shapes with bias (one
    of them with small Y and X) and B * Z above 65535; two launches
    bit-identical; device times beside the plain version, the stock route
    (int8 im2col + ``torch._int_mm``) and the bf16 K3 kernel at the four
    shapes, with the launch plan chosen at each."""
    import torch
    from rtpose_tpu_torch.ops import build
    from rtpose_tpu_torch.ops import conv_k3 as ck
    from rtpose_tpu_torch.ops import conv_k3_int8 as ck8
    from rtpose_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(5)

    def rand_q(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    wq = rand_q((32, 32, 3, 3, 3))
    scale = torch.rand((32,), generator=gen, device=dev) * 1e-3
    bias = torch.randn((32,), generator=gen, device=dev)
    checked = []
    cases = [(shape, None) for shape in K3_SHAPES] + [((2, 5, 13, 37), bias),
                                                     ((2, 3, 2, 5), bias),
                                                     ((1, 70000, 2, 3), bias)]
    for shape, b in cases:
        xq = rand_q((*shape, 32))
        for dt in (torch.bfloat16, torch.float32):
            got = ck8.conv3d_k3_int8(xq, wq, scale, b, dt)
            torch.cuda.synchronize()
            if not torch.equal(got, ck8.conv3d_k3_int8_reference(xq, wq, scale, b, dt)):
                fail(f"int8 K3 {shape} {dt}: not bit-equal to its plain version")
            checked.append(f"{shape} {str(dt)[6:]}")
    xq = rand_q((8, 16, 64, 160, 32))
    if not torch.equal(ck8.conv3d_k3_int8(xq, wq, scale, bias),
                       ck8.conv3d_k3_int8(xq, wq, scale, bias)):
        fail("int8 K3: two launches on the same inputs differ")
    print(f"[int8 conv] bit-equal to the plain version: {checked}; two launches bit-identical")
    rows = {}
    wk = ck8.prepare(wq)
    w = torch.randn((32, 32, 3, 3, 3), generator=gen, device=dev) * 0.06
    wr, _ = ck.prepare(w)
    for shape in K3_SHAPES:
        xq = rand_q((*shape, 32))
        xb = torch.randn((*shape, 32), generator=gen, device=dev).to(torch.bfloat16)
        r = int8_row(device_ms(lambda: ck8.launch(xq, wk, scale)),
                     device_ms(lambda: ck8.conv3d_k3_int8_reference(xq, wq, scale)),
                     device_ms(lambda: quant.epilogue(quant.int8_conv_acc(xq, wq, 1), scale,
                                                      None, torch.bfloat16)),
                     device_ms(lambda: ck.launch(xb, wr)), xq,
                     wrapper_ms=wrapper_ms(lambda: ck8.conv3d_k3_int8(xq, wq, scale)),
                     plan=ck8.plan(*shape, build.sm_count(dev))._asdict())
        rows[str(shape)] = r
        print(f"[int8 conv] {shape}: {r['ms']:.4f} ms ({r['tops']:.1f} TOPS, "
              f"{100 * r['share_of_bound']:.1f} % of bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}), plain {r['plain_ms']:.4f} ms, stock im2col + _int_mm "
              f"{r['stock_ms']:.4f} ms, bf16 K3 {r['k3_bf16_ms']:.4f} ms; plan {r['plan']}")
    main = rows[str(K3_SHAPES[0])]
    return dict(name="conv3d_k3_int8", route="cuda", source="rtpose_tpu_torch/csrc/conv_k3_int8.cu",
                replaces="none: not a TPU kernel (the JAX package runs this int8 conv on XLA, "
                         "rtpose_tpu/ops/quant.py:191 conv3d_int8)",
                max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None,
                stock_ms=main["stock_ms"], k3_bf16_ms=main["k3_bf16_ms"],
                wrapper_ms=main["wrapper_ms"], shape="(1, 16, 64, 160, 32) int8 -> bf16",
                bit_equal=True, shapes=rows)


def throughput(fn, x, batch: int) -> dict:
    """Frames/s of ``fn(x)`` (forward + decode) at a fixed batch: SERVE_CALLS
    calls after two warm-ups, between CUDA events (host dispatch included
    where the card waits for it)."""
    import torch
    for _ in range(2):
        fn(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(SERVE_CALLS):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / SERVE_CALLS
    return dict(ms_per_batch=ms, frames_per_s=batch * 1e3 / ms)


def phase_serving(tmp, cfg_path, cfg, ckpt, dev):
    """The serving path: ``tools.export`` of the flagship's seeded weights as
    a bf16 and an int8 artifact (8 calibration batches, 51 sites),
    ``tools.test --exported --speed_test`` on each over the FRAMES-frame
    root with the launch counts per forward, the bf16 artifact's
    predictions against the live bf16 run, int8 against bf16 on one batch,
    one int8 frame on the card against the port's CPU int8 run in float32,
    throughput rows at SERVE_BATCHES, and a trace of one int8 batch."""
    import copy

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg
    from rtpose_tpu_torch.engine import bind_sites, load_checkpoint
    from rtpose_tpu_torch.export import export_predict, load_predict, make_predict_fn
    from rtpose_tpu_torch.models import build_detector
    from rtpose_tpu_torch.ops import quant
    from rtpose_tpu_torch.tools import export as port_export
    from rtpose_tpu_torch.tools import test as port_test

    work = os.path.join(tmp, "serving")
    os.makedirs(work, exist_ok=True)
    B = SERVE_BATCHES[0]
    paths = {k: os.path.join(work, f"flagship_{k}_b{B}.pt2") for k in ("bf16", "int8")}
    t0 = time.perf_counter()
    port_export.main([cfg_path, "--checkpoint", ckpt, "--out", paths["bf16"],
                      "--batch_size", str(B)])
    t_bf16 = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = port_export.main([cfg_path, "--checkpoint", ckpt, "--out", paths["int8"],
                            "--batch_size", str(B), "--int8", "--calib_batches", "8",
                            "--calib_split", "test"])
    t_int8 = time.perf_counter() - t0
    scales = res["int8_scales"]
    if len(scales) != INT8_SITES:
        fail(f"int8 export calibrated {len(scales)} sites, expected {INT8_SITES}")
    print(f"[serving] tools.export: bf16 {t_bf16:.1f} s, int8 {t_int8:.1f} s ({len(scales)} "
          f"sites); {os.path.getsize(paths['bf16'])} and {os.path.getsize(paths['int8'])} bytes")

    forwards = -(-FRAMES // B)
    runs, counts, wrapped = {}, {}, {}
    for kind in ("bf16", "int8"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = port_test.main([cfg_path, "--exported", paths[kind], "--work_dir",
                              os.path.join(work, kind), "--testset", "--speed_test"])
        wall = time.perf_counter() - t0
        counts[kind] = ops.launch_counts()
        # the loaded program replays a CUDA graph from its second call on: the
        # wrappers count the eager calls, and the capture's warm-up and capture
        g = out["eval_graphs"]
        wrapped[kind] = g["eager"] + 2 * g["captures"]
        if g["eager"] + g["captures"] + g["replays"] != forwards:
            fail(f"{kind} artifact: graph counts {g} over {forwards} forwards")
        runs[kind] = out
        if len(out["detections"]) != FRAMES or out["sec_per_frame"] is None:
            fail(f"{kind} artifact: {len(out['detections'])} frames decoded, no speed window")
        print(f"[serving] tools.test --exported {kind} (B={B}): {wall:.1f} s wall, "
              f"{out['sec_per_frame'] * 1e3:.3f} ms/frame, MPJPE {out['results']['MPJPE']} mm, "
              f"launch counts {counts[kind]}")
    want = {"bf16": dict(conv3d_k3=K3_PER_STEP * wrapped["bf16"], conv3d_k3_int8=0),
            "int8": dict(conv3d_k3=0, conv3d_k3_int8=K3_PER_STEP * wrapped["int8"])}
    for kind, w in want.items():
        got = {k: counts[kind][k] for k in w}
        if got != w or counts[kind]["preprocess"] != 0:
            fail(f"{kind} artifact: launch counts {counts[kind]}, expected {w} over "
                 f"{wrapped[kind]} wrapped forwards of {forwards}")

    # the bf16 artifact's predictions against the live bf16 model's
    live = port_test.main([cfg_path, "--checkpoint", ckpt, "--work_dir",
                           os.path.join(work, "live"), "--testset"])
    def kpts(det):
        return np.array([[p[1:4] for p in det[k]["keypoints"]] for k in sorted(det)])
    art_err = float(np.abs(kpts(runs["bf16"]["detections"]) - kpts(live["detections"])).max())
    if art_err > SERVE_ARTIFACT_ATOL_M:
        fail(f"bf16 artifact vs live bf16: keypoints apart by {art_err} m")
    int8_vs_bf16 = float(np.linalg.norm(kpts(runs["int8"]["detections"])
                                        - kpts(runs["bf16"]["detections"]), axis=-1).mean())
    print(f"[serving] bf16 artifact vs live bf16 (B={B}): max keypoint difference {art_err} m; "
          f"int8 vs bf16 artifact: mean keypoint distance {int8_vs_bf16 * 1e3:.2f} mm")

    # one batch on the card: int8 heatmap peaks against bf16's
    asm = assemble(cfg)
    asm.model.load_state_dict(load_checkpoint(ckpt)["state_dict"])
    asm.model.to(dev).eval()
    bind_sites(asm.model)
    ds = build_dataset_from_cfg(cfg.data, "test")
    # a dataset item is a transposed view; the kernels take contiguous inputs
    frames = [torch.from_numpy(np.ascontiguousarray(ds[i]["rdr_tensor"]))
              for i in range(max(SERVE_BATCHES))]
    xb = torch.stack(frames[:B]).to(dev)
    with torch.inference_mode():
        hm_b, _, peak_b = asm.model.predict_sparse(xb)
        with quant.int8_mode(scales):
            hm_q, _, peak_q = asm.model.predict_sparse(xb)
    hm_b, hm_q = hm_b.float().reshape(B, -1), hm_q.float().reshape(B, -1)
    span = (hm_q.max(1).values - hm_q.min(1).values)
    gap = (hm_q.max(1).values - hm_q.gather(1, peak_b[:, None])[:, 0]) / span
    same = int((peak_b == peak_q).sum())
    print(f"[serving] int8 vs bf16 on {B} frames: {same} peaks identical; bf16 peak below the "
          f"int8 max by at most {gap.max().item():.4f} of the int8 logit range (limit "
          f"{INT8_E2E_FRAC})")
    if gap.max().item() > INT8_E2E_FRAC:
        fail(f"int8 heatmap: the bf16 peak is {gap.max().item():.3f} of the range below its max")

    # one frame: int8 on the card (bf16 activations, kernels) vs the CPU in float32
    model_cfg = copy.deepcopy(dict(cfg.model))
    model_cfg["backbone"]["dtype"] = "float32"
    model_cfg["pose_head"]["dtype"] = "float32"
    cpu = build_detector(model_cfg)
    cpu.load_state_dict(load_checkpoint(ckpt)["state_dict"])
    cpu.eval()
    bind_sites(cpu)
    x1 = frames[0][None]
    t0 = time.perf_counter()
    with torch.inference_mode(), quant.int8_mode(scales):
        hm_g, reg_g, p = asm.model.predict_sparse(x1.to(dev))
        feat = cpu.extract_feat(x1)
        hm_c = cpu.pose_head(feat, branch="hm")[0]["hm"]
        _, Z, Y, X, _ = hm_c.shape
        p = p.cpu()
        reg_c = cpu._reg_patches(cpu.shared(feat), p // (Y * X), (p % (Y * X)) // X, p % X,
                                 (Z, Y, X))
    t_cpu = time.perf_counter() - t0
    hm_g, reg_g = hm_g.float().cpu(), reg_g.float().cpu()
    span1 = (hm_c.max() - hm_c.min()).item()
    hm_err = check_close("int8 heatmap card vs cpu", hm_g, hm_c, 0.0, INT8_E2E_FRAC * span1)
    gap1 = hm_c.max().item() - hm_c.reshape(-1)[int(p)].item()
    if gap1 > INT8_E2E_FRAC * span1:
        fail(f"int8: card peak {int(p)} is {gap1:.3f} below the CPU max")
    reg_err = check_close("int8 reg at peak card vs cpu", reg_g, reg_c, 0.0,
                          INT8_E2E_FRAC * reg_c.abs().max().item())
    print(f"[serving] int8 frame card vs CPU float32 ({t_cpu:.1f} s): heatmap max err "
          f"{hm_err:.4f} of range {span1:.3f} ({hm_err / span1:.4f}); peak {int(p)} below the "
          f"CPU max by {gap1 / span1:.4f} of the range; reg max err {reg_err:.4f} (max |reg| "
          f"{reg_c.abs().max().item():.3f})")

    # throughput of the predict path (forward + decode)
    rows = {}
    for batch in SERVE_BATCHES:
        x = torch.stack((frames * -(-batch // len(frames)))[:batch]).to(dev)
        live_fn = make_predict_fn(asm)
        row = {"live bf16": throughput(live_fn, x, batch)}
        for label, kw in (("bf16 artifact", {}), ("int8 artifact", dict(int8_scales=scales)),
                          ("int8 + final_dtype bfloat16 artifact",
                           dict(int8_scales=scales, final_dtype="bfloat16"))):
            kind = {"bf16 artifact": "bf16", "int8 artifact": "int8"}.get(label)
            t0 = time.perf_counter()
            if batch == B and kind:
                # the artifact tools.export wrote above, loaded as a server would
                fn, how = load_predict(paths[kind]), "load_s"
            else:
                fn = export_predict(asm, batch_size=batch, device="cuda", **kw).module()
                how = "export_s"
            row[label] = dict(**throughput(fn, x, batch), **{how: time.perf_counter() - t0})
        rows[str(batch)] = row
        for label, r in row.items():
            print(f"[serving] B={batch} {label}: {r['frames_per_s']:.1f} frames/s "
                  f"({r['ms_per_batch']:.3f} ms/batch)")
    # one int8 batch at B under torch.profiler: device time by operation.
    # Two forwards: the first is the profiler's warm-up and is not recorded
    int8_fn = make_predict_fn(asm, int8_scales=scales)
    int8_fn(xb)
    torch.cuda.synchronize()
    traced = []
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        for _ in range(2):
            int8_fn(xb)
            torch.cuda.synchronize()
            prof.step()
    wrapped = ops.launch_counts()["conv3d_k3_int8"] // 2
    if not traced:
        fail("the int8 trace recorded nothing")
    events = traced[0]
    # the step's own range shows on the device too: not an operation
    dev_ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    if not dev_ops:
        fail("the int8 trace holds no device operation")
    busy = sum(e.self_device_time_total for e in dev_ops) / 1e3
    k8 = [e for e in dev_ops if "conv3d_k3_int8_kernel" in e.key]
    k8_ms = sum(e.self_device_time_total for e in k8) / 1e3
    k8_n = sum(e.count for e in k8)
    int_mm = sum(e.count for e in events if e.key == "aten::_int_mm")
    print(f"[serving trace] one int8 batch at B={B}: device busy {busy} ms in "
          f"{sum(e.count for e in dev_ops)} device operations, int8 K3 kernel {k8_ms} ms in "
          f"{k8_n} launches in the trace, {wrapped} counted by its wrapper "
          f"({100 * k8_ms / busy:.1f} %), {int_mm} torch._int_mm calls")
    top = sorted(dev_ops, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    for e in top:
        print(f"[serving trace] {e.key[:80]:<80} {e.self_device_time_total / 1e3:9.4f} ms "
              f"{e.count:6d}")
    if wrapped != K3_PER_STEP or int_mm != INT8_SITES - K3_PER_STEP:
        fail(f"int8 forward: {wrapped} int8 kernel launches and {int_mm} _int_mm calls, "
             f"expected {K3_PER_STEP} and {INT8_SITES - K3_PER_STEP}")
    return dict(
        batch=B, int8_sites=len(scales), frames=FRAMES, forwards=forwards,
        artifact_bytes={k: os.path.getsize(v) for k, v in paths.items()},
        export_s=dict(bf16=t_bf16, int8=t_int8),
        ms_per_frame={k: runs[k]["sec_per_frame"] * 1e3 for k in runs},
        mpjpe_mm={k: runs[k]["results"]["MPJPE"] for k in runs},
        launches=counts, bf16_artifact_vs_live_max_m=art_err,
        int8_vs_bf16_mean_keypoint_mm=int8_vs_bf16 * 1e3,
        int8_vs_bf16_peaks_identical=same, int8_vs_bf16_peak_gap_max=gap.max().item(),
        card_vs_cpu_int8=dict(hm_err_frac=hm_err / span1, peak_gap_frac=gap1 / span1,
                              reg_err=reg_err, reg_max=reg_c.abs().max().item()),
        throughput=rows,
        trace=dict(device_busy_ms=busy, int8_kernel_ms=k8_ms, int8_kernel_share=k8_ms / busy,
                   int8_kernel_launches_traced=k8_n, int8_kernel_launches=wrapped,
                   int_mm_calls=int_mm, device_ops=sum(e.count for e in dev_ops),
                   top=[(e.key[:80], e.self_device_time_total / 1e3, e.count) for e in top]))


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
    counts, graphs = ops.launch_counts(), out["eval_graphs"]
    print(f"[e2e] tools.test: {wall:.1f} s wall, launch counts {counts}, eval graphs {graphs}")
    # B=1: one eager call, one capture, a replay for every other frame; the
    # wrappers see the eager call, the capture's warm-up and the capture
    if (graphs["eager"], graphs["captures"], graphs["replays"]) != (1, 1, FRAMES - 2):
        fail(f"eval graphs {graphs}, expected 1 eager call, 1 capture, {FRAMES - 2} replays")
    mpjpe = out["results"]["MPJPE"]
    if not (mpjpe == mpjpe and 0 < mpjpe < float("inf")):
        fail(f"MPJPE {mpjpe} is not a finite positive number")
    if out["sec_per_frame"] is None:
        fail("no speed-test time")
    if len(out["detections"]) != FRAMES:
        fail(f"{len(out['detections'])} frames decoded, expected {FRAMES}")
    if counts["preprocess"] != 3 or counts["conv3d_k3"] != 14 * 3 or counts["conv3d_k3_int8"]:
        fail(f"the wrappers counted {counts}, expected 3 forwards' 1 preprocess and 14 bf16 "
             "conv launches each")
    print(f"[e2e] MPJPE {mpjpe} mm, {out['sec_per_frame'] * 1e3:.3f} ms/frame at B=1")
    return out, counts


def phase_speed_and_trace(tmp, cfg_path, ckpt, first_ms):
    """SPEED_RUNS - 1 more speed windows of tools.test, then one run traced
    with torch.profiler (device activity only, ``cuda_trace``): its
    launches, checked against the trace by kernel symbol (``eval_launches``),
    are the e2e path's (a forward each frame and the capture's warm-up)."""
    import statistics

    from rtpose_tpu_torch import ops as port_ops
    from rtpose_tpu_torch.tools import test as port_test

    argv = test_argv(tmp, cfg_path, ckpt)
    speed = [first_ms] + [port_test.main(argv)["sec_per_frame"] * 1e3
                          for _ in range(SPEED_RUNS - 1)]
    window = (2 * FRAMES) // 3 - FRAMES // 3
    med = statistics.median(speed)
    print(f"[e2e] speed windows of {window} frames at B=1: {speed} ms/frame; "
          f"median {med}, spread {max(speed) - min(speed)}")
    port_ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, ops, symbols = cuda_trace(lambda: port_test.main(argv))
    traced_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not ops:
        fail("the trace holds no device operation")
    launches = eval_launches("e2e traced test", out, symbols)
    forwards = FRAMES + eval_captures(out)
    if (launches["preprocess"] != forwards or launches["conv3d_k3"] != 14 * forwards
            or launches["group_norm"] != GN_PER_FORWARD * forwards
            or launches["resize_trilinear"] != RS_PER_FORWARD * forwards):
        fail(f"e2e traced test: launches {launches}, expected {forwards} forwards' 1 "
             f"preprocess, 14 bf16 conv, {GN_PER_FORWARD} GroupNorm and {RS_PER_FORWARD} "
             "resize launches each")
    busy = sum(e.self_device_time_total for e in ops) / 1e3 / FRAMES
    n_ops = sum(e.count for e in ops) / FRAMES
    print(f"[trace] {traced_wall:.1f} s traced run, {time.perf_counter() - t0:.1f} s to "
          f"read the trace; device busy {busy} ms/frame, {n_ops} device operations/frame; "
          f"kernels by symbol {symbols}, by wrapper and graph replay {launches}")
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
                device_ops_per_frame=n_ops, device_idle_share=1 - busy / med,
                launches=launches, kernel_symbols=symbols)


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
        reg_c = cpu._reg_patches(cpu.shared(feat_c), p // (Y * X), (p % (Y * X)) // X, p % X,
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


def run_train(tag, argv, epochs, counted_steps=None):
    """One run of the port's train CLI, checked: ``epochs`` epochs of whole
    batches, finite losses, no skipped step, and the wrappers' launch counts:
    once (preprocess) or ``K3_PER_STEP`` times (conv forward, conv backward)
    for each of the ``counted_steps`` steps that passed the wrappers (every
    step of a per-step run, the default).  Returns the trainer, the launch counts and the run's record: its
    per-step losses, their mean per epoch (``epoch_means``) and its final
    parameters (flat, on the host)."""
    import torch

    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.tools import train as port_train

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = port_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = len(trainer.iter_seconds)
    hist = trainer.log_buffer.val_history
    losses, skipped = list(hist["loss"]), hist["skipped"]
    print(f"[{tag}] tools.train: {steps} steps in {wall:.1f} s wall, launch counts {counts}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if steps != epochs * TRAIN_FRAMES // 8:
        fail(f"{tag}: {steps} train steps, expected {epochs * TRAIN_FRAMES // 8}")
    if len(losses) != steps or not all(v == v and abs(v) < float("inf") for v in losses):
        fail(f"{tag}: train losses not all finite: {losses}")
    if any(v != 0.0 for v in skipped):
        fail(f"{tag}: {int(sum(skipped))} train steps skipped")
    counted = steps if counted_steps is None else counted_steps
    want = {"preprocess": counted, "preprocess_single": 0, "conv3d_k3": K3_PER_STEP * counted,
            "conv3d_k3_bwd": K3_PER_STEP * counted, "conv3d_k3_int8": 0,
            "deform_conv2d": 0, "group_norm": 0, "resize_trilinear": 0}
    if counts != want:
        fail(f"{tag}: training launch counts {counts}, expected {want}")
    print(f"[{tag}] losses {[round(v, 4) for v in losses]}")
    per_epoch = TRAIN_FRAMES // 8
    epoch_means = [sum(losses[e * per_epoch:(e + 1) * per_epoch]) / per_epoch
                   for e in range(epochs)]
    with open(trainer.json_log) as f:
        records = [json.loads(line) for line in f]
    if [r["epoch"] for r in records] != list(range(1, epochs + 1)):
        fail(f"{tag}: the JSON log does not hold one record per epoch: {records}")
    params = torch.cat([q.detach().reshape(-1).float().cpu()
                        for q in trainer.state.model.parameters()])
    return trainer, counts, dict(wall_s=wall, losses=losses, epoch_means=epoch_means,
                                 params=params,
                                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def step_times(tag, trainer):
    """ms/step of a per-step run: the host clock of each loop iteration
    after two warm-up steps."""
    import statistics

    ms = [t * 1e3 for t in trainer.iter_seconds[2:]]
    med = statistics.median(ms)
    print(f"[{tag}] ms/step after warm-up (host clock per iteration, B=8): median {med}, "
          f"spread {max(ms) - min(ms)}, min {min(ms)}, max {max(ms)}; {8e3 / med} frames/s")
    return dict(ms_per_step=ms, ms_per_step_median=med, ms_per_step_spread=max(ms) - min(ms),
                frames_per_s=8e3 / med, first_step_ms=trainer.iter_seconds[0] * 1e3)


def compare_runs(tag, run, ref, p0, noise_dist=None, control=False):
    """Two training runs of the same seed and order, held to the tolerances
    stated at ``RUN_FIRST_LOSS_RTOL`` and ``RUN_PARAM_REL_DIST``
    (``noise_dist``: the distance two per-step runs of the same call of
    this script were apart).  Returns how far apart they were: the losses' relative
    differences and the distance between their final parameters relative to
    the distance ``ref`` moved from ``p0``.  ``control``: ``run`` was made
    wrong on purpose, and it is a failure if every tolerance holds."""
    if len(run["epoch_means"]) != len(ref["epoch_means"]):
        fail(f"{tag}: {len(run['epoch_means'])} epochs vs {len(ref['epoch_means'])}")
    step_rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"])]
    rel = [abs(a - b) / abs(b) for a, b in zip(run["epoch_means"], ref["epoch_means"])]
    dist = float((run["params"] - ref["params"]).norm() / (ref["params"] - p0).norm())
    limit = RUN_PARAM_REL_DIST
    if noise_dist is not None:
        limit = min(limit, RUN_PARAM_NOISE_FACTOR * noise_dist)
    broken = []
    if step_rel[0] > RUN_FIRST_LOSS_RTOL:
        broken.append(f"first-step loss {run['losses'][0]} vs {ref['losses'][0]}")
    if max(step_rel[1:3]) > RUN_EARLY_LOSS_RTOL:
        broken.append(f"losses of steps 1-2 {run['losses'][1:3]} vs {ref['losses'][1:3]}")
    if max(rel) > RUN_EPOCH_MEAN_RTOL:
        broken.append(f"per-epoch losses {run['epoch_means']} vs {ref['epoch_means']}")
    if dist > limit:
        broken.append(f"final parameters apart by {dist:.3f} of the distance moved, "
                      f"limit {limit:.3f}")
    print(f"[{tag}] per-epoch losses {run['epoch_means']} vs {ref['epoch_means']} (rel {rel}); "
          f"first step rel {step_rel[0]:.2e}, steps 1-2 rel {step_rel[1:3]}, largest "
          f"single-step rel {max(step_rel):.3f} at step {step_rel.index(max(step_rel))}; final "
          f"parameters apart by {dist:.3f} of the distance moved (limit {limit:.3f})")
    if control:
        if not broken:
            fail(f"{tag}: a run made wrong on purpose stayed within every tolerance")
        print(f"[{tag}] out of tolerance, as it must be: {'; '.join(broken)}")
    elif broken:
        fail(f"{tag}: {'; '.join(broken)}")
    return dict(epoch_mean_rel=rel, first_step_rel=step_rel[0], early_step_rel=step_rel[1:3],
                max_step_rel=max(step_rel), param_rel_dist=dist, param_rel_dist_limit=limit)


def seeded_params(cfg_path):
    """The flat initial parameters of a ``--seed 0`` run."""
    import torch
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.models import init_weights

    model = init_weights(assemble(Config.fromfile(cfg_path)).model,
                         torch.Generator().manual_seed(0))
    return torch.cat([q.detach().reshape(-1).float() for q in model.parameters()])


def phase_train(tmp, cfg_path):
    """The port's train CLI on the flagship config with the host loader:
    launch counts, finite losses, no skipped step, ms/step."""
    work = os.path.join(tmp, "train_work")
    trainer, counts, run = run_train("train", train_argv(cfg_path, work, TRAIN_EPOCHS),
                                     TRAIN_EPOCHS)
    ckpt = os.path.join(work, "checkpoints", f"epoch_{TRAIN_EPOCHS}.pth")
    if not os.path.isfile(ckpt):
        fail(f"no checkpoint {ckpt}")
    info = dict(steps=len(run["losses"]), batch=8, wall_s=run["wall_s"],
                **step_times("train", trainer), losses=run["losses"],
                grad_norm_last=trainer.log_buffer.val_history["grad_norm"][-1],
                launches=counts, peak_device_memory_gb=run["peak_gb"], checkpoint=ckpt)
    return info, run


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


def phase_cache_content(cfg_path, dev):
    """``DeviceCachedLoader`` on the card against ``BatchLoader`` over one
    epoch of the training root: the same indices and bit-equal tensors with no
    ``cache_dtype``; compressed caches equal to ``cache_cast`` of the same
    rows cast back, labels untouched.  The raw f16 cubes (what the cache
    holds under --device_preprocess) shrink under float8_e4m3fn only; the
    bf16 cache is held on the float32 host-preprocessed cubes."""
    import numpy as np
    import torch
    from rtpose_tpu_torch.api import build_dataset_from_cfg
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import BatchLoader, DeviceCachedLoader
    from rtpose_tpu_torch.data.loader import cache_cast

    cfg = Config.fromfile(cfg_path)

    def check(ds, key, cache_dtype, batches):
        t0 = time.perf_counter()
        cached = DeviceCachedLoader(ds, batch_size=8, device=dev, shuffle=True, seed=0,
                                    cache_dtype=cache_dtype)
        built = time.perf_counter() - t0
        host = BatchLoader(ds, batch_size=8, shuffle=True, seed=0)
        if len(cached) != len(host):
            fail(f"cache {cache_dtype}: {len(cached)} batches, BatchLoader {len(host)}")
        compressed = cached.data[key].dtype != torch.from_numpy(np.asarray(ds[0][key])).dtype
        n = 0
        for h, d in zip(host, cached):
            if n == batches:
                break
            n += 1
            # the same samples in the same order: the index streams agree
            if d["meta"] != h["meta"] or int(d["valid"]) != int(h["valid"]):
                fail(f"cache {cache_dtype}: meta or valid differ in batch {n}")
            for k in (key, "poses", "num_poses"):
                want = torch.from_numpy(h[k])
                if k == key and compressed:
                    want = cache_cast(want, cached.data[k].dtype).to(want.dtype)
                got = d[k]
                if got.device.type != "cuda" or got.dtype != want.dtype:
                    fail(f"cache {cache_dtype}: {k} is {got.dtype} on {got.device}")
                if not torch.equal(torch.nan_to_num(got.cpu().float(), nan=-1.0),
                                   torch.nan_to_num(want.float(), nan=-1.0)):
                    fail(f"cache {cache_dtype}: {k} differs in batch {n}")
        print(f"[cache] {key} cache_dtype={cache_dtype}: stored {cached.data[key].dtype}, "
              f"{cached.nbytes} bytes on the card, built in {built:.1f} s, {n} batches equal "
              f"to BatchLoader's" + (" cast through the cache dtype" if compressed else ""))
        return cached.nbytes, compressed

    raw = build_dataset_from_cfg(cfg.data, "train", device_preprocess=True)
    nbytes, _ = check(raw, "rdr_raw", None, 12)
    _, c_bf16 = check(raw, "rdr_raw", "bfloat16", 2)
    n_f8, c_f8 = check(raw, "rdr_raw", "float8_e4m3fn", 12)
    if c_bf16 or not c_f8:
        fail("cache: f16 cubes must stay as they are under bfloat16 and shrink under float8")
    f32 = build_dataset_from_cfg(cfg.data, "train")
    n_f32_bf16, c = check(f32, "rdr_tensor", "bfloat16", 2)
    if not c:
        fail("cache: float32 cubes must shrink under bfloat16")
    return dict(bytes=nbytes, bytes_float8=n_f8, bytes_float32_cubes_as_bfloat16=n_f32_bf16)


def phase_train_cached(tmp, cfg_path, host_run, p0):
    """``--device_cache``, per step, against the host loader's run."""
    argv = train_argv(cfg_path, os.path.join(tmp, "cache_work"), TRAIN_EPOCHS)
    trainer, counts, run = run_train("device cache", argv + ["--device_cache"], TRAIN_EPOCHS)
    if not trainer.loader.device_resident or trainer.epoch_step is not None:
        fail("device cache: the run did not take the per-step loop over the cached loader")
    info = dict(**step_times("device cache", trainer), launches=counts,
                peak_device_memory_gb=run["peak_gb"],
                **compare_runs("device cache vs host loader", run, host_run, p0))
    return info, run


def phase_train_fused(tmp, cfg_path, cached_run, p0, noise_dist):
    """``--device_cache --fuse_epochs``: the graph path taken, the run against
    the per-step device-cache run, ms/step; then two more fused epochs,
    called as the trainer calls them, under torch.profiler (the first its
    warm-up): the kernels the second one's replays launched, counted by name
    in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.config import Config

    argv = train_argv(cfg_path, os.path.join(tmp, "fused_work"), TRAIN_EPOCHS)
    # the wrappers are passed by the warm-up step and by the capture: two steps' counts
    trainer, counts, run = run_train("fused", argv + ["--device_cache", "--fuse_epochs"],
                                     TRAIN_EPOCHS, counted_steps=2)
    es = trainer.epoch_step
    steps, per_epoch = len(run["losses"]), TRAIN_FRAMES // 8
    if es is None or es.graph is None:
        fail("fused: no CUDA graph was captured")
    if es.replays != steps:
        fail(f"fused: {es.replays} graph replays for {steps} steps")
    captured = {"preprocess": 1, "preprocess_single": 0, "conv3d_k3": K3_PER_STEP,
                "conv3d_k3_bwd": K3_PER_STEP, "conv3d_k3_int8": 0, "deform_conv2d": 0,
                "group_norm": 0, "resize_trilinear": 0}
    if es.launches_per_step != captured:
        fail(f"fused: the wrappers counted {es.launches_per_step} during the capture, "
             f"expected {captured}")
    by_epoch = [trainer.iter_seconds[e * per_epoch] * 1e3 for e in range(TRAIN_EPOCHS)]
    steady = by_epoch[-1]
    print(f"[fused] {es.replays} replays of one captured step (the wrappers counted "
          f"{es.launches_per_step} while it was captured); ms/step by epoch (epoch time over "
          f"its {per_epoch} steps; the first holds the warm-up step and the capture): "
          f"{by_epoch}; {8e3 / steady} frames/s")
    cmp = compare_runs("fused vs device cache per step", run, cached_run, p0, noise_dist)
    # two more epochs, replays only, under the profiler: the first is its
    # warm-up and is not recorded (a trace of one cold epoch once held 335 of
    # the 336 K3 launches), the second is the traced epoch.  The profiler
    # keeps only device activity that lies inside its window on the host's
    # clock, and an epoch that ran right up to the window's edges once lost
    # 4 of its 336 K3 launches: the card idles TRACE_EDGE_S on either side
    # of the traced epoch.
    loader = trainer.loader
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    recorded = []
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: recorded.append((p.key_averages(), p.events()))) as prof:
        for epoch in (TRAIN_EPOCHS, TRAIN_EPOCHS + 1):
            loader.set_epoch(epoch)
            idx = loader.fused_epoch()[0]
            torch.cuda.synchronize()
            time.sleep(TRACE_EDGE_S)
            t0 = time.perf_counter()
            _, metrics = es(trainer.state, loader.data, idx)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / per_epoch
            time.sleep(TRACE_EDGE_S)
            prof.step()
    if es.replays != steps + 2 * per_epoch:
        fail(f"fused: the two traced epochs made {es.replays - steps} replays")
    if any(ops.launch_counts().values()):
        fail(f"fused: replays passed the wrappers: {ops.launch_counts()}")
    if not torch.isfinite(metrics["loss"]).all() or float(metrics["skipped"].sum()) != 0.0:
        fail(f"fused: the traced epoch's losses {metrics['loss'].tolist()}")
    if not recorded:
        fail("the fused trace recorded nothing")
    averages, events = recorded[0]
    # the step's own range shows on the device too: not an operation
    dev_ops = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    if not dev_ops:
        fail("the fused trace holds no device operation")
    busy = sum(e.self_device_time_total for e in dev_ops) / 1e3 / per_epoch
    n_ops = sum(e.count for e in dev_ops) / per_epoch
    k3 = [e for e in dev_ops if "conv3d_k3_kernel" in e.key]
    traced = {"preprocess_kernel": sum(e.count for e in dev_ops if "preprocess_kernel" in e.key),
              "conv3d_k3_kernel": sum(e.count for e in k3)}
    want = {"preprocess_kernel": per_epoch, "conv3d_k3_kernel": 2 * K3_PER_STEP * per_epoch}
    if traced != want:
        # where they went missing: K3 launches after each preprocess launch,
        # in the order the card ran them, and the device span in the window
        kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.name.startswith("ProfilerStep")),
                         key=lambda e: e.time_range.start)
        by_replay = []
        for e in kernels:
            if "preprocess_kernel" in e.name or not by_replay:
                by_replay.append(0)
            by_replay[-1] += "conv3d_k3_kernel" in e.name
        fail(f"fused trace: kernels launched by {per_epoch} replays {traced}, expected {want}; "
             f"K3 launches per replay {by_replay}, {len(kernels)} device operations from "
             f"{kernels[0].time_range.start} to {kernels[-1].time_range.end} us of the trace")
    print(f"[fused trace] one epoch of {per_epoch} replays: kernels by name {traced} (the "
          f"wrappers counted {ops.launch_counts()}); device busy {busy} ms/step, {n_ops} "
          f"device operations/step, idle share {1 - busy / steady} of the untraced {steady} "
          f"ms/step (the traced epoch itself: {traced_ms} ms/step); K3 "
          f"{sum(e.self_device_time_total for e in k3) / 1e3 / per_epoch} ms/step")
    for e in sorted(dev_ops, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"[fused trace] {e.key[:80]:<80} "
              f"{e.self_device_time_total / 1e3 / per_epoch:9.4f} {e.count / per_epoch:10.2f}")
    # the comparison's own control: a fused run whose peak lr is 1.2 times the
    # config's must not pass for the per-step run
    lr_max = float(Config.fromfile(cfg_path).lr_config["lr_max"])
    wrong_argv = train_argv(cfg_path, os.path.join(tmp, "fused_wrong_lr_work"), TRAIN_EPOCHS)
    _, _, wrong = run_train("fused, lr_max x 1.2", wrong_argv + [
        "--device_cache", "--fuse_epochs", "--lr_max", str(1.2 * lr_max)],
        TRAIN_EPOCHS, counted_steps=2)
    control = compare_runs("control: fused with lr_max x 1.2 vs device cache per step", wrong,
                           cached_run, p0, noise_dist, control=True)
    return dict(replays=steps, ms_per_step_by_epoch=by_epoch, ms_per_step=steady,
                control_lr_max_x1_2=control,
                frames_per_s=8e3 / steady, wrapper_launches=counts,
                wrapper_launches_in_capture=es.launches_per_step,
                traced_epoch_replays=per_epoch, trace_launches=traced,
                peak_device_memory_gb=run["peak_gb"],
                device_busy_ms_per_step=busy, device_ops_per_step=n_ops,
                device_idle_share=1 - busy / steady, traced_epoch_ms_per_step=traced_ms,
                k3_ms_per_step=sum(e.self_device_time_total for e in k3) / 1e3 / per_epoch,
                **cmp)


def phase_train_stream(tmp, cfg_path):
    """``--stream_cache_gb``: one epoch over at least three chunks, every
    sample once, at most two chunks on the card."""
    argv = train_argv(cfg_path, os.path.join(tmp, "stream_work"), 1)
    trainer, counts, run = run_train("stream", argv + ["--stream_cache_gb", str(STREAM_GB)], 1)
    loader = trainer.loader
    if len(loader.chunks) < 3:
        fail(f"stream: {len(loader.chunks)} chunks")
    if sorted(int(i) for c in loader.chunks for i in c) != list(range(TRAIN_FRAMES)):
        fail("stream: the chunks do not hold every sample once")
    if not 1 <= loader.max_resident <= 2:
        fail(f"stream: {loader.max_resident} chunks were resident at once")
    loader.set_epoch(1)
    seen = [f"{m['seq']}/{m['frame']}" for b in loader for m in b["meta"]]
    if len(seen) != TRAIN_FRAMES or len(set(seen)) != TRAIN_FRAMES or loader.max_resident > 2:
        fail(f"stream: an epoch yielded {len(seen)} samples, {len(set(seen))} distinct, "
             f"{loader.max_resident} chunks resident")
    print(f"[stream] {len(loader.chunks)} chunks of {loader.samples_per_chunk} samples "
          f"({loader.chunk_nbytes} bytes each), at most {loader.max_resident} resident; every "
          f"sample once per epoch")
    return dict(**step_times("stream", trainer), chunks=len(loader.chunks),
                samples_per_chunk=loader.samples_per_chunk, chunk_bytes=loader.chunk_nbytes,
                max_resident_chunks=loader.max_resident, launches=counts,
                peak_device_memory_gb=run["peak_gb"])


def phase_train_profile(tmp, cfg_path):
    """``--profile 5``: the Chrome trace exists and holds the CUDA kernels of
    five steps."""
    work = os.path.join(tmp, "profile_work")
    run_train("profile", train_argv(cfg_path, work, 1) + ["--device_cache", "--profile", "5"], 1)
    path = os.path.join(work, "profile", "trace.json")
    if not os.path.isfile(path):
        fail(f"no trace {path}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k3 = [e for e in kernels if "conv3d_k3_kernel" in e.get("name", "")]
    print(f"[profile] {path}: {os.path.getsize(path)} bytes, {len(events)} events, "
          f"{len(kernels)} CUDA kernels, {len(k3)} of them K3")
    if len(k3) != 5 * 2 * K3_PER_STEP:
        fail(f"--profile 5: {len(k3)} K3 kernels in the trace, expected {5 * 2 * K3_PER_STEP}")
    return dict(trace_bytes=os.path.getsize(path), cuda_kernels=len(kernels), k3_kernels=len(k3))


# ---- the shipped configs beyond the flagship: two people a frame (_skel_mp2),
# the deformable head (_dcn), complex cubes (_phase), RepeatDataset (_skel480x2)

CFG_DIR = os.path.join(REPO, "configs", "cruw_pose")
MP2_FRAMES = (32, 8)      # train / test frames of the two-person root (4 steps an epoch)
PHASE_FRAMES = (6, 2)     # train / test frames of the complex root (B=1)
# spread of the offset convs' weights in phase 21's card-vs-CPU comparison:
# 128 features of unit scale give offsets of ~0.6 pixel
DCN_OFFSET_STD = 0.05
SLICE_TOP_OPS = 10


def slice_config(tmp, tag, name, root):
    """A config that runs ``configs/cruw_pose/<name>.py`` as shipped, reads
    ``root`` (cubes pre-cropped to the ROI) and saves a checkpoint after
    every epoch."""
    src = os.path.join(CFG_DIR, f"{name}.py")
    path = os.path.join(tmp, f"{name}_{tag}.py")
    with open(path, "w") as f:
        f.write(f"exec(compile(open({src!r}).read(), {src!r}, 'exec'))\n"
                f"DATASET['DIR']['ROOT_DIR'] = {root!r}\n"
                "DATASET['DIR']['CUBES_ARE_ROI'] = True\n"
                "checkpoint_config = dict(interval=1)\n")
    return path


# each hand kernel's symbol in a device trace -> the wrappers that launch it
KERNEL_SYMBOLS = {"preprocess_kernel": ("preprocess", "preprocess_single"),
                  "conv3d_k3_kernel": ("conv3d_k3", "conv3d_k3_bwd"),
                  "deform_conv2d_fwd_kernel": ("deform_conv2d",),
                  "group_norm_apply_kernel": ("group_norm",),
                  "upsample_trilinear3d_cl_kernel": ("resize_trilinear",)}


def cuda_trace(fn):
    """``fn()`` under a CUDA-only torch.profiler trace: its result, the
    trace's device operations (``key_averages``, the spin kernels out) and
    the hand kernels' launches by symbol (``KERNEL_SYMBOLS``).  Traces taken
    late in a process lost the device activity of their first ~0.1-0.2 s
    (phase 25's traced epoch its first step; phase 26's box-AP trace 39 of
    64 spin kernels queued 0.1 s in), so the card idles ``TRACE_LEAD_S`` at
    either edge and ``TRACE_SPINS`` spin kernels go first; a trace that kept
    no more than half of them fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_LEAD_S)
        for _ in range(TRACE_SPINS):
            torch.cuda._sleep(1000)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_LEAD_S)
    dev_ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spins = sum(e.count for e in dev_ops if "spin_kernel" in e.key)
    if spins <= TRACE_SPINS // 2:
        fail(f"a trace kept {spins} of its {TRACE_SPINS} spin kernels: it may have lost the "
             "traced run's first operations")
    dev_ops = [e for e in dev_ops if "spin_kernel" not in e.key]
    return out, dev_ops, {s: sum(e.count for e in dev_ops if s in e.key) for s in KERNEL_SYMBOLS}


def eval_launches(tag, out, symbols):
    """The kernels a traced ``tools.test`` run launched, by wrapper (reset
    just before the run), each checked against the run's trace (``symbols``,
    ``cuda_trace``'s count by kernel symbol).  A replay of the eval step's
    CUDA graphs (``engine.EvalGraphs``) passes no wrapper: the wrappers count
    each eager call, each capture's warm-up forward and each capture, which
    launches nothing and is replayed once, so a kernel launched the wrappers'
    count plus ``replays x launches_per_replay``; the trace has to hold that
    many of each symbol, and a kernel no symbol names (int8) no replay."""
    from rtpose_tpu_torch import ops

    counts, g = ops.launch_counts(), out["eval_graphs"]
    per, replays = ({}, 0) if g is None else (g["launches_per_replay"], g["replays"])
    launches = {k: v + replays * per.get(k, 0) for k, v in counts.items()}
    named = {k for ks in KERNEL_SYMBOLS.values() for k in ks}
    if (any(symbols[s] != sum(launches[k] for k in ks) for s, ks in KERNEL_SYMBOLS.items())
            or any(launches[k] != counts[k] for k in counts if k not in named)):
        fail(f"{tag}: the trace counted {symbols} by kernel symbol, the wrappers {counts} "
             f"and {replays} graph replays of {per} launches each")
    return launches


def eval_captures(out):
    """The eval step's graph captures in a ``tools.test`` run (0 for a step
    that is no ``engine.EvalGraphs``): each adds one warm-up forward."""
    return 0 if out["eval_graphs"] is None else out["eval_graphs"]["captures"]


def slice_counts(tag, counts, want):
    """The wrappers' launch counts of one run against ``want`` (every other
    kernel: 0)."""
    full = {k: 0 for k in counts}
    full.update(want)
    if counts != full:
        fail(f"{tag}: launch counts {counts}, expected {full}")


def slice_train(tag, argv, steps, per_step, counted_steps=None):
    """One tools.train run of a slice path, launch counts reset just before
    and read just after: ``steps`` steps, finite losses, none skipped, each
    kernel ``per_step[k]`` times a step (over ``counted_steps`` steps where
    the wrappers see fewer: a fused run's warm-up step and capture).
    Returns the trainer and its record."""
    import statistics

    import torch
    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.tools import train as port_train

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = port_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    hist = trainer.log_buffer.val_history
    losses = list(hist["loss"])
    n = len(trainer.iter_seconds)
    if n != steps or len(losses) != steps:
        fail(f"{tag}: {n} train steps, expected {steps}")
    if not all(v == v and abs(v) < float("inf") for v in losses) or any(hist["skipped"]):
        fail(f"{tag}: losses {losses}, skipped {hist['skipped']}")
    slice_counts(tag, counts, {k: v * (counted_steps or steps) for k, v in per_step.items()})
    ms = [t * 1e3 for t in trainer.iter_seconds[min(2, steps - 1):]]
    quartiles = statistics.quantiles(ms, n=4) if len(ms) > 1 else ms * 3
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] tools.train: {steps} steps in {wall:.1f} s wall, launch counts {counts}; "
          f"ms/step (host clock, {len(ms)} steps after warm-up) median {statistics.median(ms)}, "
          f"quartiles {quartiles[0]} / {quartiles[2]}, spread {max(ms) - min(ms)}; peak "
          f"device memory {peak:.2f} GB; losses {[round(v, 4) for v in losses]}")
    return trainer, dict(steps=steps, wall_s=wall, launches=counts, losses=losses,
                         timed_steps=len(ms), ms_per_step_median=statistics.median(ms),
                         ms_per_step_quartiles=(quartiles[0], quartiles[2]),
                         ms_per_step_spread=max(ms) - min(ms),
                         num_positive_mean=sum(hist["num_positive"]) / steps,
                         peak_device_memory_gb=peak)


def traced(tag, fn, n, unit):
    """``fn()`` under torch.profiler (device activity, ``cuda_trace``): device
    busy ms and operations per ``unit`` (``n`` of them), the top operations,
    the hand kernels' launches by symbol, and the
    deformable gather (``index_select``: ``vectorized_gather_kernel``) and
    its scatter-add backward (``index_add_``: ``indexFunc*``) where they
    ran."""
    t0 = time.perf_counter()
    out, ops, symbols = cuda_trace(fn)
    wall = time.perf_counter() - t0
    if not ops:
        fail(f"{tag}: the trace holds no device operation")
    busy = sum(e.self_device_time_total for e in ops) / 1e3 / n
    n_ops = sum(e.count for e in ops) / n

    def ms(pred):
        return sum(e.self_device_time_total for e in ops if pred(e.key)) / 1e3 / n

    k3 = ms(lambda k: "conv3d_k3_kernel" in k)
    gather = ms(lambda k: "gather_kernel" in k or "indexSelect" in k)
    scatter = ms(lambda k: "indexFunc" in k)
    print(f"[{tag} trace] {wall:.1f} s traced; device busy {busy} ms/{unit}, {n_ops} device "
          f"operations/{unit}; K3 {k3} ms/{unit}; index_select {gather} ms/{unit}, "
          f"index_add_ {scatter} ms/{unit}")
    top = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:SLICE_TOP_OPS]
    for e in top:
        print(f"[{tag} trace] {e.key[:80]:<80} {e.self_device_time_total / 1e3 / n:9.4f} "
              f"ms/{unit} {e.count / n:9.2f} calls/{unit}")
    return out, dict(device_busy_ms=busy, device_ops=n_ops, k3_ms=k3, index_select_ms=gather,
                     index_add_ms=scatter, kernel_symbols=symbols,
                     top=[(e.key[:80], e.self_device_time_total / 1e3 / n, e.count / n)
                          for e in top])


def slice_test(tag, cfg_path, ckpt, work, frames, per_forward, forwards, persons=1,
               extra=()):
    """tools.test on ``ckpt`` under the profiler, counts reset just before:
    every test frame decoded with ``15 * persons`` joints, a finite MPJPE,
    each kernel ``per_forward[k]`` times a forward."""
    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.tools import test as port_test

    ops.reset_launch_counts()
    out, trace = traced(f"{tag} test", lambda: port_test.main(
        [cfg_path, "--checkpoint", ckpt, "--work_dir", work, "--testset", *extra]),
        frames, "frame")
    counts = eval_launches(f"{tag} test", out, trace["kernel_symbols"])
    forwards += eval_captures(out)
    slice_counts(f"{tag} test", counts, {k: v * forwards for k, v in per_forward.items()})
    dets, mpjpe = out["detections"], out["results"]["MPJPE"]
    if len(dets) != frames or any(len(d["keypoints"]) != 15 * persons for d in dets.values()):
        fail(f"{tag} test: {len(dets)} frames, joints "
             f"{sorted({len(d['keypoints']) for d in dets.values()})}")
    if not (mpjpe == mpjpe and 0 < mpjpe < float("inf")):
        fail(f"{tag} test: MPJPE {mpjpe}")
    print(f"[{tag}] tools.test: {frames} frames, {15 * persons} joints each, MPJPE {mpjpe} mm, "
          f"launch counts {counts}")
    return out, dict(mpjpe_mm=mpjpe, launches=counts, trace=trace)


def card_and_cpu_models(cfg, sd, dev):
    """The config's model on the card (its bf16 compute and the kernels) and
    a float32 copy on the CPU, both with the state dict ``sd``."""
    import copy

    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.models import build_detector

    asm = assemble(cfg)
    asm.model.load_state_dict(sd)
    model_cfg = copy.deepcopy(dict(cfg.model))
    model_cfg["backbone"]["dtype"] = "float32"
    model_cfg["pose_head"]["dtype"] = "float32"
    cpu = build_detector(model_cfg)
    cpu.load_state_dict(sd)
    return asm, asm.model.to(dev).eval(), cpu.eval()


def seeded_state_dict(cfg, offset_std=0.0):
    """Seeded weights (seed 0, as phase 8's checkpoint); ``offset_std`` gives
    the deformable head's offset convs, which start at zero, weights of that
    spread (seed 1), so the comparison samples off the grid.  The card-vs-CPU
    comparisons of phases 20 and 21 run on these and not on the few-step
    checkpoints: trained that briefly, the regression shrinks until bf16's
    own rounding (the CPU's bf16 against its float32, the flagship's too)
    is of the order of E2E_FRAC of it."""
    import torch
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.models import init_weights
    from rtpose_tpu_torch.models.dcn_head import FeatureAdaption

    model = init_weights(assemble(cfg).model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FeatureAdaption) and offset_std:
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=g) * offset_std)
    return model.state_dict()


def card_vs_cpu_outputs(tag, gpu_out, cpu_out):
    """Dense head outputs of one frame, card (bf16) against CPU (float32):
    heatmap logits within E2E_FRAC of their range and the regression within
    E2E_FRAC of its largest magnitude, over the whole volume."""
    hm_g, hm_c = gpu_out["hm"].float().cpu(), cpu_out["hm"]
    reg_g, reg_c = gpu_out["reg"].float().cpu(), cpu_out["reg"]
    span = (hm_c.max() - hm_c.min()).item()
    hm_err = check_close(f"{tag}: heatmap logits card vs cpu", hm_g, hm_c, 0.0, E2E_FRAC * span)
    reg_max = reg_c.abs().max().item()
    reg_err = check_close(f"{tag}: regression card vs cpu", reg_g, reg_c, 0.0, E2E_FRAC * reg_max)
    print(f"[{tag} compare] one frame card (bf16) vs CPU (float32), seeded weights: logit "
          f"range {span:.3f}, max err {hm_err:.4f}; max |reg| {reg_max:.3f}, max err "
          f"{reg_err:.4f}")
    return dict(hm_err_frac=hm_err / span, reg_err_frac=reg_err / reg_max)


def phase_skel_mp2(tmp, dev):
    """``_skel_mp2`` (two people a frame, dense step, top-2 decode) on a root
    the port's generator writes: two training epochs at B=8 with
    --device_preprocess and one more traced, tools.test on the checkpoint
    (traced), one frame card vs CPU (seeded weights) and its multi-peak
    decode on the card vs the CPU on the same float32 outputs, a bf16
    tools.export artifact of the checkpoint against the live model."""
    import numpy as np
    import torch
    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.core.decode import decode_pose_multi
    from rtpose_tpu_torch.data import generate_synthetic_dataset
    from rtpose_tpu_torch.engine import load_checkpoint, preprocess_raw
    from rtpose_tpu_torch.export import load_predict, make_predict_fn
    from rtpose_tpu_torch.tools import export as port_export
    from rtpose_tpu_torch.tools import train as port_train

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "mp2_data")
    n_train, n_test = MP2_FRAMES
    generate_synthetic_dataset(root, num_seqs=2, frames_per_seq=n_train // 2,
                               test_frames_per_seq=n_test // 2, seed=5, pose_mode="skeleton",
                               persons_per_frame=2, roi_only=True)
    cfg_path = slice_config(tmp, "mp2", "hr3d_one_hm_doppler_skel_mp2", root)
    cfg = Config.fromfile(cfg_path)
    asm = assemble(cfg)
    if asm.multi_poses != 2 or asm.sparse_head:
        fail(f"mp2: multi_poses {asm.multi_poses}, sparse_head {asm.sparse_head}")
    per_step = dict(preprocess=1, conv3d_k3=K3_PER_STEP, conv3d_k3_bwd=K3_PER_STEP)
    work = os.path.join(tmp, "mp2_work")
    argv = [cfg_path, "--work_dir", work, "--device_preprocess", "--seed", "0"]
    steps = n_train // 8
    trainer, train = slice_train("mp2", argv + ["--stop_epoch", "2"], 2 * steps, per_step)
    if train["num_positive_mean"] <= 8:
        fail(f"mp2: {train['num_positive_mean']} positives a step of 8 two-person frames")
    _, train["trace"] = traced("mp2 train", lambda: port_train.main(
        [cfg_path, "--work_dir", os.path.join(tmp, "mp2_trace"), "--device_preprocess",
         "--seed", "0", "--stop_epoch", "1"]), steps, "step")
    ckpt = os.path.join(work, "checkpoints", "epoch_2.pth")
    out, test = slice_test("mp2", cfg_path, ckpt, os.path.join(tmp, "mp2_eval"), n_test,
                           dict(preprocess=1, conv3d_k3=K3_PER_STEP, group_norm=GN_PER_FORWARD,
                                resize_trilinear=RS_PER_FORWARD),
                           -(-n_test // 8),
                           persons=2, extra=["--device_preprocess"])

    # one frame: the card's forward and multi-peak decode against the CPU's
    _, gpu, cpu = card_and_cpu_models(cfg, seeded_state_dict(cfg), dev)
    ds = build_dataset_from_cfg(cfg.data, "test", max_poses=2, device_preprocess=True)
    raw = torch.from_numpy(ds[0]["rdr_raw"])[None]
    norm = (ds.norm_start, ds.norm_scale)
    with torch.inference_mode():
        pg = gpu(preprocess_raw(raw.to(dev), norm))[0]
        pc = cpu(preprocess_raw(raw, norm))[0]
        compare = card_vs_cpu_outputs("mp2", pg, pc)
        hm32, reg32 = pg["hm"].float(), pg["reg"].float()
        kg, sg = decode_pose_multi(hm32, reg32, asm.decode_spec, 2)
        kc, sc = decode_pose_multi(hm32.cpu(), reg32.cpu(), asm.decode_spec, 2)
    kp_err = check_close("mp2: multi decode card vs cpu (keypoints)", kg.cpu(), kc, 0.0, 1e-5)
    check_close("mp2: multi decode card vs cpu (scores)", sg.cpu(), sc, 1e-6, 0.0)
    compare["decode_kpts_err_m"] = kp_err
    print(f"[mp2 compare] multi decode of the same float32 outputs, card vs CPU: scores "
          f"{sc.tolist()}, keypoints max err {kp_err} m")

    # the bf16 serving artifact of the checkpoint against the live model on
    # one batch of 8 frames
    live_asm = assemble(cfg)
    live_asm.model.load_state_dict(load_checkpoint(ckpt)["state_dict"])
    live_asm.model.to(dev).eval()
    art = os.path.join(tmp, "mp2_b8.pt2")
    port_export.main([cfg_path, "--checkpoint", ckpt, "--out", art, "--batch_size", "8"])
    host_ds = build_dataset_from_cfg(cfg.data, "test", max_poses=2)
    xb = torch.stack([torch.from_numpy(np.ascontiguousarray(host_ds[i]["rdr_tensor"]))
                      for i in range(8)]).to(dev)
    live = make_predict_fn(live_asm)(xb)
    ops.reset_launch_counts()
    got = load_predict(art)(xb)
    slice_counts("mp2 artifact", ops.launch_counts(),
                 dict(conv3d_k3=K3_PER_STEP, group_norm=GN_PER_FORWARD,
                      resize_trilinear=RS_PER_FORWARD))
    (ka, sa), (kl, sl) = got[0], live[0]
    art_err = float((ka - kl).abs().max())
    if ka.shape != (8, 2, 15, 3) or art_err > SERVE_ARTIFACT_ATOL_M:
        fail(f"mp2 artifact vs live: shape {tuple(ka.shape)}, keypoints apart by {art_err} m")
    check_close("mp2 artifact vs live (scores)", sa.cpu(), sl.cpu(), 1e-6, 0.0)
    wall = time.perf_counter() - t_phase
    print(f"[mp2] bf16 artifact (B=8) vs live: keypoints max err {art_err} m; phase wall "
          f"{wall:.1f} s")
    return dict(train=train, test=test, compare=compare, artifact_kpts_err_m=art_err,
                wall_s=wall)


def phase_dcn(tmp, train_root, dev):
    """``_dcn`` (the deformable head, dense step) on the flagship training
    root: one epoch at B=8 with --device_preprocess and one more traced
    (the deformable gather and its scatter-add backward by kernel), peak
    device memory, tools.test on the checkpoint (traced), one frame card
    vs CPU (seeded weights, the offset convs given DCN_OFFSET_STD)."""
    import torch
    from rtpose_tpu_torch.api import build_dataset_from_cfg
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.engine import preprocess_raw
    from rtpose_tpu_torch.tools import train as port_train

    t_phase = time.perf_counter()
    cfg_path = slice_config(tmp, "dcn", "hr3d_one_hm_doppler_dcn", train_root)
    cfg = Config.fromfile(cfg_path)
    per_step = dict(preprocess=1, conv3d_k3=K3_PER_STEP, conv3d_k3_bwd=K3_PER_STEP)
    work = os.path.join(tmp, "dcn_work")
    steps = TRAIN_FRAMES // 8
    _, train = slice_train("dcn", [cfg_path, "--work_dir", work, "--device_preprocess",
                                   "--seed", "0", "--stop_epoch", "1"], steps, per_step)
    _, train["trace"] = traced("dcn train", lambda: port_train.main(
        [cfg_path, "--work_dir", os.path.join(tmp, "dcn_trace"), "--device_preprocess",
         "--seed", "0", "--stop_epoch", "1"]), steps, "step")
    ckpt = os.path.join(work, "checkpoints", "epoch_1.pth")
    _, test = slice_test("dcn", cfg_path, ckpt, os.path.join(tmp, "dcn_eval"), 8,
                         dict(preprocess=1, conv3d_k3=K3_PER_STEP, deform_conv2d=2,
                              group_norm=GN_PER_FORWARD, resize_trilinear=RS_PER_FORWARD), 1,
                         extra=["--device_preprocess"])
    _, gpu, cpu = card_and_cpu_models(cfg, seeded_state_dict(cfg, DCN_OFFSET_STD), dev)
    ds = build_dataset_from_cfg(cfg.data, "test", device_preprocess=True)
    raw = torch.from_numpy(ds[0]["rdr_raw"])[None]
    norm = (ds.norm_start, ds.norm_scale)
    with torch.inference_mode():
        compare = card_vs_cpu_outputs("dcn", gpu(preprocess_raw(raw.to(dev), norm))[0],
                                      cpu(preprocess_raw(raw, norm))[0])
    wall = time.perf_counter() - t_phase
    print(f"[dcn] phase wall {wall:.1f} s")
    return dict(train=train, test=test, compare=compare, wall_s=wall)


def phase_complex(tmp):
    """``_phase`` (complex 64-channel cubes, B=1) on a root the port's
    generator writes: one training epoch and one more traced, tools.test
    (traced); of the hand kernels only GroupNorm's, in eval: complex cubes
    opt out of the card preprocess and no conv of the 64/128-channel
    backbone is the K3 shape."""
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import generate_synthetic_dataset
    from rtpose_tpu_torch.tools import train as port_train

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "phase_data")
    n_train, n_test = PHASE_FRAMES
    generate_synthetic_dataset(root, num_seqs=2, frames_per_seq=n_train // 2,
                               test_frames_per_seq=n_test // 2, seed=7, pose_mode="skeleton",
                               rdr_type="dzyx_complex", roi_only=True)
    cfg_path = slice_config(tmp, "phase", "hr3d_one_hm_doppler_phase", root)
    shape = assemble(Config.fromfile(cfg_path)).input_shape_zyxc
    if shape != (16, 64, 160, 64):
        fail(f"phase: input shape {shape}")
    argv = [cfg_path, "--device_preprocess", "--seed", "0", "--stop_epoch", "1"]
    work = os.path.join(tmp, "phase_work")
    _, train = slice_train("phase", argv + ["--work_dir", work], n_train, {})
    _, train["trace"] = traced("phase train", lambda: port_train.main(
        argv + ["--work_dir", os.path.join(tmp, "phase_trace")]), n_train, "step")
    _, test = slice_test("phase", cfg_path, os.path.join(work, "checkpoints", "epoch_1.pth"),
                         os.path.join(tmp, "phase_eval"), n_test,
                         dict(group_norm=GN_PHASE, resize_trilinear=RS_PER_FORWARD),
                         n_test,
                         extra=["--device_preprocess"])
    wall = time.perf_counter() - t_phase
    print(f"[phase] phase wall {wall:.1f} s")
    return dict(train=train, test=test, wall_s=wall)


def phase_repeat(tmp, train_root):
    """``_skel480x2`` (RepeatDataset x2) on the flagship training root: one
    epoch takes twice the steps of its child."""
    from rtpose_tpu_torch.api import build_dataset_from_cfg
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import RepeatDataset

    t_phase = time.perf_counter()
    cfg_path = slice_config(tmp, "repeat", "hr3d_one_hm_doppler_skel480x2", train_root)
    ds = build_dataset_from_cfg(Config.fromfile(cfg_path).data, "train")
    if not isinstance(ds, RepeatDataset) or len(ds) != 2 * len(ds.dataset):
        fail(f"repeat: {type(ds).__name__} of {len(ds)} samples")
    child_steps = len(ds.dataset) // 8
    per_step = dict(preprocess=1, conv3d_k3=K3_PER_STEP, conv3d_k3_bwd=K3_PER_STEP)
    _, train = slice_train("repeat", [cfg_path, "--work_dir", os.path.join(tmp, "repeat_work"),
                                      "--device_preprocess", "--seed", "0", "--stop_epoch",
                                      "1"], 2 * child_steps, per_step)
    wall = time.perf_counter() - t_phase
    print(f"[repeat] {train['steps']} steps = twice the child's {child_steps}; phase wall "
          f"{wall:.1f} s")
    return dict(train=train, child_steps=child_steps, wall_s=wall)


# ---- the LiDAR branch (configs/lidar/voxelnet_pose.py): VoxelNet on voxel batches

LIDAR_CFG = os.path.join(REPO, "configs", "lidar", "voxelnet_pose.py")
# train / test frames of the LiDAR root: 24 steps an epoch at B=8, a
# 40-frame --speed_test window (the middle third of the test frames)
LIDAR_FRAMES = (192, 120)
LIDAR_SPEED_RUNS = 3    # --speed_test windows per eval mode: median and spread
K3_LIDAR = 6    # the 32 -> 32 convs of hr_tiny_feat16_zyx_l4: stages 2-4, branch 1
LIDAR_TTA_LINES = ("voxelization['cfg']['double_flip'] = True\n"
                   "test_cfg['double_flip'] = True\n")


def lidar_config(tmp, tag, root, extra=""):
    """A config that runs ``configs/lidar/voxelnet_pose.py`` as shipped, reads
    ``root`` and saves a checkpoint after every epoch."""
    path = os.path.join(tmp, f"voxelnet_pose_{tag}.py")
    with open(path, "w") as f:
        f.write(f"exec(compile(open({LIDAR_CFG!r}).read(), {LIDAR_CFG!r}, 'exec'))\n"
                f"DATASET['DIR']['ROOT_DIR'] = {root!r}\n"
                "checkpoint_config = dict(interval=1)\n" + extra)
    return path


def speed_windows(tag, cfg_path, ckpt, work, frames):
    """``LIDAR_SPEED_RUNS`` runs of ``tools.test --speed_test`` (B=1, the
    middle third of the ``frames`` test frames, untraced): host ms per frame
    of each window, their median and spread."""
    import statistics

    from rtpose_tpu_torch.tools import test as port_test

    speed = [port_test.main([cfg_path, "--checkpoint", ckpt, "--work_dir", work, "--testset",
                             "--speed_test"])["sec_per_frame"] * 1e3
             for _ in range(LIDAR_SPEED_RUNS)]
    window = (2 * frames) // 3 - frames // 3
    med = statistics.median(speed)
    print(f"[{tag}] speed windows of {window} frames at B=1: {speed} ms/frame; median {med}, "
          f"spread {max(speed) - min(speed)}")
    return dict(window_frames=window, speed_ms_per_frame=speed, ms_per_frame=med,
                ms_per_frame_spread=max(speed) - min(speed))


def phase_lidar(tmp, dev):
    """The LiDAR branch at full width on a LiDAR-only root of the port's
    generator (``with_lidar``, no radar cubes): tools.train two epochs at
    B=8 (K3 6 times a step forward and 6 grad-input), one more traced (the
    voxel scatter by kernel), two fused epochs over the device cache (a
    captured CUDA graph replayed per step), tools.test on the checkpoint (traced, and
    three ``--speed_test`` windows), the same with the double-flip TTA (4 forwards a
    frame), ``voxelize`` of the test clouds on the card against the CPU,
    one frame card vs CPU (seeded weights), a bf16 and an int8 tools.export
    artifact against the live model."""
    import numpy as np
    import torch
    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import generate_synthetic_dataset
    from rtpose_tpu_torch.engine import VOXEL_KEYS, load_checkpoint
    from rtpose_tpu_torch.export import calibrate_predict, load_predict, make_predict_fn
    from rtpose_tpu_torch.ops.voxelize import voxelize
    from rtpose_tpu_torch.tools import export as port_export
    from rtpose_tpu_torch.tools import train as port_train

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "lidar_data")
    n_train, n_test = LIDAR_FRAMES
    generate_synthetic_dataset(root, num_seqs=2, frames_per_seq=n_train // 2,
                               test_frames_per_seq=n_test // 2, seed=8, pose_mode="skeleton",
                               with_lidar=True, radar_cubes=False)
    cfg_path = lidar_config(tmp, "lidar", root)
    cfg = Config.fromfile(cfg_path)
    asm = assemble(cfg)
    if (asm.sensor, asm.voxel_shape, asm.sparse_head, asm.input_key) != (
            "lidar", (1024, 8, 4), False, None):
        fail(f"lidar: assembly {asm.sensor} {asm.voxel_shape} {asm.sparse_head}")
    per_step = dict(conv3d_k3=K3_LIDAR, conv3d_k3_bwd=K3_LIDAR)
    work = os.path.join(tmp, "lidar_work")
    steps = n_train // 8
    _, train = slice_train("lidar", [cfg_path, "--work_dir", work, "--seed", "0",
                                     "--stop_epoch", "2"], 2 * steps, per_step)
    _, train["trace"] = traced("lidar train", lambda: port_train.main(
        [cfg_path, "--work_dir", os.path.join(tmp, "lidar_trace"), "--seed", "0",
         "--stop_epoch", "1"]), steps, "step")
    train["idle_share"] = 1.0 - train["trace"]["device_busy_ms"] / train["ms_per_step_median"]
    print(f"[lidar] train: {train['ms_per_step_median']} ms/step (host clock, median of "
          f"{train['timed_steps']} steps), device busy {train['trace']['device_busy_ms']} ms/step "
          f"(one traced epoch of {steps} steps), idle share {train['idle_share']}; the "
          f"voxel scatter (index_add_) {train['trace']['index_add_ms']} ms/step; its backward: "
          f"none (the mean reader has no parameter and the voxels need no gradient)")

    # fused epochs over the device-cached voxel batches: replays of one
    # captured CUDA graph of the train step
    fused_trainer, fused = slice_train(
        "lidar fused", [cfg_path, "--work_dir", os.path.join(tmp, "lidar_fused"), "--seed", "0",
                        "--stop_epoch", "2", "--device_cache", "--fuse_epochs"],
        2 * steps, per_step, counted_steps=2)
    es = fused_trainer.epoch_step
    if es is None or es.graph is None or es.replays != 2 * steps:
        fail(f"lidar fused: no captured graph, or {es and es.replays} replays for "
             f"{2 * steps} steps")
    fused["replays"] = es.replays
    fused["ms_per_step_epoch2"] = fused_trainer.iter_seconds[-1] * 1e3
    train["fused"] = fused
    print(f"[lidar] fused epochs: {es.replays} replays of one captured step, "
          f"{fused['ms_per_step_epoch2']} ms/step in the second epoch")

    ckpt = os.path.join(work, "checkpoints", "epoch_2.pth")
    forwards = -(-n_test // 8)
    _, test = slice_test("lidar", cfg_path, ckpt, os.path.join(tmp, "lidar_eval"), n_test,
                         dict(conv3d_k3=K3_LIDAR, group_norm=GN_PER_FORWARD,
                              resize_trilinear=RS_PER_FORWARD), forwards)
    test.update(speed_windows("lidar", cfg_path, ckpt, os.path.join(tmp, "lidar_speed"),
                              n_test))
    tta_path = lidar_config(tmp, "lidar_tta", root, LIDAR_TTA_LINES)
    if not assemble(Config.fromfile(tta_path)).tta_double_flip:
        fail("lidar tta: the config's double_flip did not reach the assembly")
    _, tta = slice_test("lidar tta", tta_path, ckpt, os.path.join(tmp, "lidar_tta_eval"),
                        n_test, dict(conv3d_k3=K3_LIDAR, group_norm=GN_PER_FORWARD,
                                     resize_trilinear=RS_PER_FORWARD),
                        4 * forwards)
    tta.update(speed_windows("lidar tta", tta_path, ckpt, os.path.join(tmp, "lidar_tta_speed"),
                             n_test))
    print(f"[lidar] eval: {test['ms_per_frame']} ms/frame at B=1 (host clock, median of "
          f"{LIDAR_SPEED_RUNS} windows of {test['window_frames']} frames), device "
          f"{test['trace']['device_busy_ms']} ms/frame at B=8 ({n_test} frames traced); TTA (4 "
          f"forwards a frame): {tta['ms_per_frame']} ms/frame, device "
          f"{tta['trace']['device_busy_ms']} ms/frame; "
          f"MPJPE {test['mpjpe_mm']} mm, with TTA {tta['mpjpe_mm']} mm")

    # voxelize of the test clouds: the card against the CPU
    vox_cfg = dict(cfg.voxelization["cfg"])
    from rtpose_tpu_torch.data.pipelines import Voxelization
    stage = Voxelization(cfg=vox_cfg)
    ds = build_dataset_from_cfg(cfg.data, "test")
    n_vox = 0
    for i in range(len(ds)):
        s = ds.samples[i]
        pts = ds.get_points(s["seq"], s.get("lidar_frame") or s["rdr_frame"])
        n = min(len(pts), stage.max_num_points)
        padded = np.zeros((stage.max_num_points, pts.shape[1]), np.float32)
        padded[:n] = pts[:n]
        x = torch.from_numpy(padded)
        want = voxelize(x, n, stage.test_spec)
        got = voxelize(x.to(dev), n, stage.test_spec)
        for k in want:
            if not torch.equal(got[k].cpu(), want[k]):
                fail(f"lidar voxelize: {k} of test frame {i} differs card vs cpu")
        n_vox += int(want["num_voxels"])
    print(f"[lidar] voxelize card == cpu on {len(ds)} test clouds (all five outputs, voxels "
          f"bit for bit; {n_vox / len(ds)} voxels a cloud of {stage.test_spec.max_voxels})")

    # one frame: the card (bf16 + kernels) against the CPU in float32
    _, gpu, cpu = card_and_cpu_models(cfg, seeded_state_dict(cfg), dev)
    item = ds[0]
    batch = {k: torch.from_numpy(np.asarray(item[k]))[None] for k in VOXEL_KEYS}
    with torch.inference_mode():
        compare = card_vs_cpu_outputs("lidar", gpu({k: v.to(dev) for k, v in batch.items()})[0],
                                      cpu(batch)[0])

    # serving: a bf16 and an int8 artifact of the checkpoint against the live model
    live_asm = assemble(cfg)
    live_asm.model.load_state_dict(load_checkpoint(ckpt)["state_dict"])
    live_asm.model.to(dev).eval()
    items = [ds[i] for i in range(8)]
    xb = {k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items])).to(dev)
          for k in VOXEL_KEYS}
    serving = {}
    for kind in ("bf16", "int8"):
        art = os.path.join(tmp, f"lidar_{kind}.pt2")
        extra = ["--int8", "--calib_batches", "2"] if kind == "int8" else []
        res = port_export.main([cfg_path, "--checkpoint", ckpt, "--out", art,
                                "--batch_size", "8", *extra])
        scales = res["int8_scales"]
        live = make_predict_fn(live_asm, int8_scales=scales)(xb)
        ops.reset_launch_counts()
        got = load_predict(art)(xb)
        torch.cuda.synchronize()
        want_counts = (dict(conv3d_k3_int8=K3_LIDAR) if kind == "int8"
                       else dict(conv3d_k3=K3_LIDAR))
        want_counts.update(group_norm=GN_PER_FORWARD, resize_trilinear=RS_PER_FORWARD)
        slice_counts(f"lidar {kind} artifact", ops.launch_counts(), want_counts)
        (ka, sa, _), (kl, sl, _) = got[0], live[0]
        err = float((ka - kl).abs().max())
        if ka.shape != (8, 15, 3) or not torch.isfinite(ka).all() or err > SERVE_ARTIFACT_ATOL_M:
            fail(f"lidar {kind} artifact vs live: shape {tuple(ka.shape)}, keypoints apart by "
                 f"{err} m")
        serving[kind] = dict(kpts_err_m=err, launches=ops.launch_counts(),
                             int8_sites=None if scales is None else len(scales))
        print(f"[lidar] {kind} artifact (B=8) vs live: keypoints max err {err} m"
              + ("" if scales is None else f"; {len(scales)} int8 sites"))
    if serving["int8"]["int8_sites"] != len(calibrate_predict(live_asm, [xb])):
        fail("lidar int8: the artifact's sites are not the live calibration's")
    wall = time.perf_counter() - t_phase
    print(f"[lidar] phase wall {wall:.1f} s")
    return dict(train=train, test=test, tta=tta, compare=compare, serving=serving,
                voxels_per_cloud=n_vox / len(ds), wall_s=wall)


# Phase 25: data parallelism, one process per card under torch.distributed.run
DP_WORKER = "--dp_worker"   # chip_smoke.py --dp_worker SPEC: one rank of phase 25
DP_TIMEOUT_S = 600
# collectives of a train step: the positive counts, then the gradient with the
# loss and metric shares; a sharded cache's batch exchange adds one
DP_ALL_REDUCES_PER_STEP = 2
EXCHANGE_CALLS = 20     # eager calls of the sharded cache's exchange, timed together
# the gathered eval at world size 1 runs the one-process batches: equal as a
# float; across cards each rank batches other frames together, and the bf16
# convs may then round a frame's outputs apart (not measured yet)
DP_EVAL_RTOL_MULTI = 1e-6


def run_process_group(cmd, timeout):
    """Run ``cmd`` in a session of its own, output captured; on timeout the
    whole session is killed (torchrun and its ranks).  Returns (rc, text)."""
    import signal
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        return 124, out
    return proc.returncode, out


def dp_trace_summary(averages, steps):
    """Device work of ``steps`` traced steps: busy ms, NCCL's kernels (count,
    ms, names), the preprocess and conv kernels by name, per step."""
    import torch
    dev_ops = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    if not dev_ops:
        fail("phase 25: a trace holds no device operation")
    nccl = [e for e in dev_ops if "nccl" in e.key.lower()]
    return dict(steps=steps,
                busy_ms_per_step=sum(e.self_device_time_total for e in dev_ops) / 1e3 / steps,
                nccl_kernels=sum(e.count for e in nccl),
                nccl_ms_per_step=sum(e.self_device_time_total for e in nccl) / 1e3 / steps,
                nccl_names=sorted({e.key[:100] for e in nccl}),
                preprocess_kernels=sum(e.count for e in dev_ops if "preprocess_kernel" in e.key),
                conv3d_k3_kernels=sum(e.count for e in dev_ops if "conv3d_k3_kernel" in e.key))


def dp_run(tag, argv, out, rank):
    """One ``tools.train --multihost`` run on this rank: its per-step losses,
    host step times, the wrappers' launch counts and the collectives, reset
    just before it; the final parameters go to ``rank<R>_<tag>_params.pt``."""
    import torch
    from rtpose_tpu_torch import ops, parallel
    from rtpose_tpu_torch.tools import train as port_train

    ops.reset_launch_counts()
    parallel.reset_collective_counts()
    t0 = time.perf_counter()
    trainer = port_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(launches=ops.launch_counts(), collectives=parallel.collective_counts(),
               wall_s=wall, steps=len(trainer.iter_seconds),
               iter_ms=[t * 1e3 for t in trainer.iter_seconds],
               losses=list(trainer.log_buffer.val_history["loss"]),
               skipped=list(trainer.log_buffer.val_history["skipped"]))
    params = torch.cat([q.detach().reshape(-1).float().cpu()
                        for q in trainer.state.model.parameters()])
    torch.save(params, os.path.join(out, f"rank{rank}_{tag}_params.pt"))
    return trainer, rec


def dp_worker(spec_path) -> int:
    """One rank of phase 25 (launched by ``phase_dp`` through
    ``torch.distributed.run``): the flagship's per-step training and a traced
    epoch of its steps, the fused sharded-cache training and a traced fused
    epoch, the sharded cache's batches against the replicated cache's and
    its exchange's time, and ``tools.test --multihost``.  Writes
    ``rank<R>.json`` beside the spec."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from rtpose_tpu_torch import ops, parallel
    from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import DeviceCachedLoader
    from rtpose_tpu_torch.data.loader import gather_batch
    from rtpose_tpu_torch.engine import device_prefetch
    from rtpose_tpu_torch.tools import test as port_test

    with open(spec_path) as f:
        spec = json.load(f)
    cfg_path, out = spec["cfg_path"], spec["out"]
    rank = int(os.environ["RANK"])
    res = dict(rank=rank)

    # 25.1: per-step training (host loader), then one more epoch of its
    # steps under the profiler (the step alone: no hook, no checkpoint)
    argv = train_argv(cfg_path, os.path.join(out, "work"), TRAIN_EPOCHS) + ["--multihost"]
    trainer, res["train"] = dp_run("train", argv, out, rank)
    dev = trainer.device
    world = parallel.process_count()
    res["world"], res["device"] = world, str(dev)
    loader = trainer.loader
    loader.set_epoch(TRAIN_EPOCHS)
    ops.reset_launch_counts()

    def epoch():
        steps = 0
        for batch in device_prefetch(loader, dev):
            batch.pop("meta", None)
            batch.pop("valid", None)
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            steps += 1
        return steps, metrics

    (steps, metrics), dev_ops, _ = cuda_trace(epoch)
    res["train_trace"] = dp_trace_summary(dev_ops, steps)
    res["train_trace"]["launches"] = ops.launch_counts()
    res["train_trace"]["skipped"] = float(metrics["skipped"])

    # 25.2: fused epochs over the sharded device cache, then two more fused
    # epochs under the profiler (the first its warm-up), as phase 17
    argv = train_argv(cfg_path, os.path.join(out, "fused_work"), TRAIN_EPOCHS) + [
        "--multihost", "--device_cache", "--cache_shard", "--fuse_epochs"]
    trainer, res["fused"] = dp_run("fused", argv, out, rank)
    es, loader = trainer.epoch_step, trainer.loader
    if es is None or es.graph is None or loader.shard is None:
        fail("phase 25: the sharded-cache run captured no CUDA graph")
    res["fused"].update(replays=es.replays, launches_per_step=es.launches_per_step,
                        collectives_per_step=es.collectives_per_step,
                        shard=[loader.shard.lo, loader.shard.hi], cache_bytes=loader.nbytes)
    per_epoch = len(loader)
    recorded = []
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: recorded.append(p.key_averages())) as prof:
        for epoch in (TRAIN_EPOCHS, TRAIN_EPOCHS + 1):
            loader.set_epoch(epoch)
            idx = loader.fused_epoch()[0]
            torch.cuda.synchronize()
            time.sleep(TRACE_EDGE_S)
            t0 = time.perf_counter()
            _, metrics = es(trainer.state, loader.data, idx)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / per_epoch
            time.sleep(TRACE_EDGE_S)
            prof.step()
    if not recorded:
        fail("phase 25: the fused trace recorded nothing")
    res["fused_trace"] = dp_trace_summary(recorded[0], per_epoch)
    res["fused_trace"].update(ms_per_step=traced_ms,
                              skipped=float(metrics["skipped"].sum()),
                              finite=bool(torch.isfinite(metrics["loss"]).all()))

    # the sharded cache's batches against a replicated cache's, one epoch;
    # the exchange's time against the replicated cache's gather
    cfg = Config.fromfile(cfg_path)
    ds = build_dataset_from_cfg(cfg.data, "train", device_preprocess=True,
                                max_poses=assemble(cfg).target_spec.max_poses)
    repl = DeviceCachedLoader(ds, batch_size=loader.batch_size, device=dev, shuffle=True,
                              seed=0, num_shards=world, shard_id=rank)
    repl.set_epoch(TRAIN_EPOCHS + 2)
    loader.set_epoch(TRAIN_EPOCHS + 2)
    n_equal = 0
    for a, b in zip(repl, loader):
        for k in ("rdr_raw", "poses", "num_poses"):
            if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
                fail(f"phase 25: the sharded cache's {k} differs from the replicated "
                     f"cache's in batch {n_equal}")
        n_equal += 1
    bs = loader.batch_size
    sel = torch.from_numpy(loader.fused_epoch()[0][:world * bs]).to(dev)
    mine = sel[rank * bs:(rank + 1) * bs]
    row_bytes = sum(v.shape[1] * v.element_size() for v in loader.data.values())
    def exchange():
        return loader.shard.exchange(loader.data, sel)

    def replicated():
        return gather_batch(repl.data, mine, bs, repl._shapes, repl._orig_dtype)

    res["exchange"] = dict(
        batches_equal=n_equal, batch_bytes=bs * row_bytes, reduced_bytes=world * bs * row_bytes,
        device_ms=device_ms(exchange), replicated_gather_device_ms=device_ms(replicated),
        eager_ms=wrapper_ms(exchange, iters=EXCHANGE_CALLS),
        replicated_gather_eager_ms=wrapper_ms(replicated, iters=EXCHANGE_CALLS))
    del repl

    # 25.3: tools.test --multihost on 25.1's checkpoint
    ckpt = os.path.join(out, "work", "checkpoints", f"epoch_{TRAIN_EPOCHS}.pth")
    ops.reset_launch_counts()
    parallel.reset_collective_counts()
    got, _, symbols = cuda_trace(lambda: port_test.main(
        [cfg_path, "--checkpoint", ckpt, "--work_dir", os.path.join(out, "test"), "--testset",
         "--device_preprocess", "--multihost"]))
    res["test"] = dict(mpjpe=None if got["results"] is None else got["results"]["MPJPE"],
                       keys=sorted(got["detections"]),
                       launches=eval_launches("phase 25 test", got, symbols),
                       collectives=parallel.collective_counts())
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    # the fused epoch's graph holds NCCL collectives: free it before leaving
    del trainer, es, loader, exchange, replicated
    parallel.shutdown()
    return 0


def dp_check_counts(tag, rec, steps, launches_want, coll_want):
    if rec["steps"] != steps:
        fail(f"{tag}: {rec['steps']} steps, expected {steps}")
    losses = rec["losses"]
    if len(losses) != steps or not all(v == v and abs(v) < float("inf") for v in losses):
        fail(f"{tag}: train losses not all finite: {losses}")
    if any(v != 0.0 for v in rec["skipped"]):
        fail(f"{tag}: {int(sum(rec['skipped']))} steps skipped")
    if rec["launches"] != launches_want:
        fail(f"{tag}: launch counts {rec['launches']}, expected {launches_want}")
    for k, v in coll_want.items():
        if rec["collectives"][k] != v:
            fail(f"{tag}: {rec['collectives'][k]} {k} collectives, expected {v}")


def dp_only_rank0_wrote(tag, work, epochs):
    files = sorted(os.listdir(work))
    logs = [f for f in files if f.endswith(".log.json")]
    texts = [f for f in files if f.startswith("exp_") and f.endswith(".log")]
    ckpts = sorted(os.listdir(os.path.join(work, "checkpoints")))
    want_ckpts = sorted([f"epoch_{e}.pth" for e in range(1, epochs + 1)] + ["latest"])
    if len(logs) != 1 or len(texts) != 1 or ckpts != want_ckpts:
        fail(f"{tag}: work dir holds {files}, checkpoints {ckpts}")
    with open(os.path.join(work, logs[0])) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(work, texts[0])) as f:
        saves = f.read().count("saved checkpoint")
    if [r["epoch"] for r in records] != list(range(1, epochs + 1)) or saves != epochs:
        fail(f"{tag}: the logs hold {len(records)} JSON records and {saves} saves for "
             f"{epochs} epochs: more than one rank wrote")
    return dict(files=files, checkpoints=ckpts)


def phase_dp(tmp, cfg_path, refs=None):
    """Phase 25: ``torch.distributed.run`` with one rank per card over
    ``dp_worker``.  ``refs``: (phase 11's run, phase 16's run, the seeded
    parameters, phase 16's noise distance) for the comparisons at one card,
    where the ranks' arithmetic is the one-process run's."""
    import statistics

    import torch

    from rtpose_tpu_torch.tools import test as port_test

    world = torch.cuda.device_count()
    out = os.path.join(tmp, "dp")
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, "spec.json")
    with open(spec, "w") as f:
        json.dump(dict(cfg_path=cfg_path, out=out), f)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world), os.path.abspath(__file__), DP_WORKER, spec]
    t0 = time.perf_counter()
    rc, text = run_process_group(cmd, DP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "ranks.log"), "w") as f:
        f.write(text)
    if rc != 0:
        fail(f"phase 25: torch.distributed.run exited {rc} after {wall:.1f} s:\n{text[-4000:]}")
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(world)]
    if [r["world"] for r in ranks] != [world] * world:
        fail(f"phase 25: world sizes {[r['world'] for r in ranks]}")
    print(f"[dp] {world} rank(s) on {[r['device'] for r in ranks]}: {wall:.1f} s wall")
    per_epoch = TRAIN_FRAMES // (8 * world)
    steps = TRAIN_EPOCHS * per_epoch
    r0 = ranks[0]
    n_params = None
    for tag in ("train", "fused"):
        params = [torch.load(os.path.join(out, f"rank{r}_{tag}_params.pt")) for r in range(world)]
        n_params = params[0].numel()
        if any(not torch.equal(p, params[0]) for p in params[1:]):
            fail(f"phase 25 {tag}: the ranks' parameters differ")
        for r in ranks:
            r[tag]["params"] = params[0]
    per_step = {"preprocess": steps, "preprocess_single": 0, "conv3d_k3": K3_PER_STEP * steps,
                "conv3d_k3_bwd": K3_PER_STEP * steps, "conv3d_k3_int8": 0, "deform_conv2d": 0,
                "group_norm": 0, "resize_trilinear": 0}
    for r in ranks:
        dp_check_counts(f"dp train rank {r['rank']}", r["train"], steps, per_step,
                        {"all_reduce": DP_ALL_REDUCES_PER_STEP * steps,
                         "barrier": TRAIN_EPOCHS})
        captured = {"preprocess": 1, "preprocess_single": 0, "conv3d_k3": K3_PER_STEP,
                    "conv3d_k3_bwd": K3_PER_STEP, "conv3d_k3_int8": 0, "deform_conv2d": 0,
                    "group_norm": 0, "resize_trilinear": 0}
        two = {k: 2 * v for k, v in captured.items()}    # the warm-up step and the capture
        # the warm-up step and the capture each issue the step's collectives
        dp_check_counts(f"dp fused rank {r['rank']}", r["fused"], steps, two,
                        {"all_reduce": 2 * (DP_ALL_REDUCES_PER_STEP + 1),
                         "barrier": TRAIN_EPOCHS})
        f = r["fused"]
        if f["replays"] != steps or f["launches_per_step"] != captured \
                or f["collectives_per_step"]["all_reduce"] != DP_ALL_REDUCES_PER_STEP + 1:
            fail(f"phase 25 fused rank {r['rank']}: {f['replays']} replays, captured "
                 f"{f['launches_per_step']} and {f['collectives_per_step']}")
        # NCCL sums a one-rank in-place all-reduce by launching nothing
        for tr, n, per in ((r["train_trace"], per_epoch, DP_ALL_REDUCES_PER_STEP),
                           (r["fused_trace"], per_epoch, DP_ALL_REDUCES_PER_STEP + 1)):
            want_nccl = per * n if world > 1 else 0
            if tr["steps"] != n or tr["nccl_kernels"] != want_nccl \
                    or tr["preprocess_kernels"] != n \
                    or tr["conv3d_k3_kernels"] != 2 * K3_PER_STEP * n:
                fail(f"phase 25 rank {r['rank']} trace: {tr}, expected {n} steps, "
                     f"{want_nccl} NCCL kernels")
        if r["fused_trace"]["skipped"] or not r["fused_trace"]["finite"]:
            fail(f"phase 25 rank {r['rank']}: the traced fused epochs lost a step")
        if r["exchange"]["batches_equal"] != per_epoch:
            fail(f"phase 25 rank {r['rank']}: {r['exchange']['batches_equal']} batches compared")
    for tag, work in (("dp train", "work"), ("dp fused", "fused_work")):
        dp_only_rank0_wrote(tag, os.path.join(out, work), TRAIN_EPOCHS)

    tr = r0["train"]
    ms = tr["iter_ms"][2:]
    median = statistics.median(ms)
    bytes_per_step = tr["collectives"]["all_reduce_bytes"] / steps
    fused_by_epoch = [r0["fused"]["iter_ms"][e * per_epoch] for e in range(TRAIN_EPOCHS)]
    info = dict(world=world, steps=steps, batch_per_rank=8, wall_s=wall,
                ms_per_step_median=median, ms_per_step_spread=max(ms) - min(ms),
                all_reduce_bytes_per_step=bytes_per_step, params=n_params,
                train_trace={k: v for k, v in r0["train_trace"].items()},
                fused_ms_per_step_by_epoch=fused_by_epoch,
                fused_trace=r0["fused_trace"], exchange=r0["exchange"],
                collectives_per_step_fused=r0["fused"]["collectives_per_step"],
                launches=tr["launches"], fused_launches=r0["fused"]["launches"],
                test_launches=r0["test"]["launches"])
    t = r0["train_trace"]
    print(f"[dp train] {steps} steps of {8 * world} frames ({world} x 8): host ms/step median "
          f"{median}, spread {max(ms) - min(ms)}; all-reduced {bytes_per_step} bytes a step in "
          f"{DP_ALL_REDUCES_PER_STEP} collectives; traced epoch: device busy "
          f"{t['busy_ms_per_step']} ms/step, NCCL kernels {t['nccl_kernels']} "
          f"({t['nccl_ms_per_step']} ms/step; {t['nccl_names']}), K1 {t['preprocess_kernels']} "
          f"and K3 {t['conv3d_k3_kernels']} launches over {t['steps']} steps; wrappers "
          f"{tr['launches']}")
    f = r0["fused_trace"]
    print(f"[dp fused] sharded cache rows {r0['fused']['shard']} ({r0['fused']['cache_bytes']} "
          f"bytes on rank 0), {r0['fused']['replays']} replays, captured collectives "
          f"{r0['fused']['collectives_per_step']}; ms/step by epoch {fused_by_epoch}; traced "
          f"epoch {f['ms_per_step']} ms/step, device busy {f['busy_ms_per_step']}, NCCL kernels "
          f"{f['nccl_kernels']} ({f['nccl_ms_per_step']} ms/step; {f['nccl_names']}), K1 "
          f"{f['preprocess_kernels']}, K3 {f['conv3d_k3_kernels']}")
    x = r0["exchange"]
    print(f"[dp exchange] {x['batches_equal']} batches equal to the replicated cache's bit for "
          f"bit; exchange {x['device_ms']} ms of device time ({x['reduced_bytes']} bytes "
          f"reduced for a {x['batch_bytes']}-byte batch) against the replicated gather's "
          f"{x['replicated_gather_device_ms']}; eager, host work included: {x['eager_ms']} "
          f"and {x['replicated_gather_eager_ms']} ms")

    if refs is not None and world == 1:
        host_run, cached_run, p0, noise_dist = refs
        for tag, ref, name in (("train", host_run, "host loader (phase 11)"),
                               ("fused", cached_run, "device cache per step (phase 16)")):
            rec = r0[tag]
            run = dict(losses=rec["losses"], params=rec["params"],
                       epoch_means=[sum(rec["losses"][e * per_epoch:(e + 1) * per_epoch])
                                    / per_epoch for e in range(TRAIN_EPOCHS)])
            info[f"{tag}_vs_one_process"] = compare_runs(
                f"dp {tag} vs {name}", run, ref, p0, noise_dist)
    elif world > 1:
        print(f"[dp] {world} ranks train a global batch of {8 * world}: no one-process run of "
              "this script is its reference")
    else:
        print("[dp] no one-process reference run given")

    # 25.3: the gathered eval against the one-process eval of the checkpoint
    ckpt = os.path.join(out, "work", "checkpoints", f"epoch_{TRAIN_EPOCHS}.pth")
    one = port_test.main([cfg_path, "--checkpoint", ckpt, "--work_dir",
                          os.path.join(out, "test_one"), "--testset", "--device_preprocess"])
    keys = sorted(one["detections"])
    mpjpe = r0["test"]["mpjpe"]
    if any(r["test"]["keys"] != keys for r in ranks) or len(keys) != 8:
        fail(f"phase 25: gathered detections {[len(r['test']['keys']) for r in ranks]} keys, "
             f"the one-process eval {len(keys)}")
    if any(r["test"]["mpjpe"] is not None for r in ranks[1:]):
        fail("phase 25: a rank other than 0 evaluated")
    # each rank's share of the 8 frames is one padded batch of 8: one forward
    want = {"preprocess": 1, "preprocess_single": 0, "conv3d_k3": K3_PER_STEP,
            "conv3d_k3_bwd": 0, "conv3d_k3_int8": 0, "deform_conv2d": 0,
            "group_norm": GN_PER_FORWARD, "resize_trilinear": RS_PER_FORWARD}
    if any(r["test"]["launches"] != want for r in ranks):
        fail(f"phase 25: tools.test launch counts {[r['test']['launches'] for r in ranks]}, "
             f"expected {want} on each rank")
    rel = abs(mpjpe - one["results"]["MPJPE"]) / abs(one["results"]["MPJPE"])
    if (world == 1 and mpjpe != one["results"]["MPJPE"]) or rel > DP_EVAL_RTOL_MULTI:
        fail(f"phase 25: gathered MPJPE {mpjpe} vs one-process {one['results']['MPJPE']}")
    print(f"[dp test] tools.test --multihost: {len(keys)} frames gathered on {world} rank(s), "
          f"MPJPE {mpjpe} (one process: {one['results']['MPJPE']}, rel {rel}); collectives "
          f"{r0['test']['collectives']}, launches {r0['test']['launches']}")
    info["test"] = dict(frames=len(keys), mpjpe=mpjpe, one_process_mpjpe=one["results"]["MPJPE"],
                        collectives=r0["test"]["collectives"])
    return info


# ---- phase 26: the rest of the JAX package (box AP, geometry, neck, second
# stage, RoI head, distillation)

GEOM_BOXES = 512        # seeded boxes of the geometry check
GEOM_ATOL = 1e-5        # IoUs card vs CPU (float32, the CPU tests' tolerance vs JAX)
NMS_THRESH, NMS_POST = 0.1, 128
# RPN at the reference's default widths, float32 on both sides (TF32 off):
# cuDNN and the CPU sum each conv in other orders, through 17 conv + BatchNorm
# layers; outputs and running statistics within 1e-3 of their largest
# magnitude (layout or flip faults are O(1))
RPN_FRAC = 1e-3
RPN_SHAPE = (8, 16, 64, 160, 128)    # a flagship backbone feature, B=8
# PolarToCart / BEV gather four (eight) taps and sum them as on the CPU; the
# card divides a tensor by a Python scalar through the scalar's reciprocal,
# one ulp off a pixel coordinate of ~160, so ~1e-5 off a bilinear weight
# (measured: 1.8e-5 of the largest BEV value): 1e-4 of the largest
# magnitude.  The RoI head's float32 dense layers (TF32 off) and flax
# LayerNorm: 1e-4
TAPS_FRAC, ROI_FRAC = 1e-4, 1e-4
DISTILL_FRAMES, DISTILL_B, DISTILL_STEPS = 6, 2, 3
K3_STUDENT = K3_PER_STEP     # the flagship's 14, width 64 at its final conv
DISTILL_LR = 1e-4


def rest_config(tmp, tag, cfg_path, extra):
    """A config that runs ``cfg_path`` and then ``extra``."""
    path = os.path.join(tmp, f"rest_{tag}.py")
    with open(path, "w") as f:
        f.write(f"exec(compile(open({cfg_path!r}).read(), {cfg_path!r}, 'exec'))\n" + extra)
    return path


def rest_box_ap(tmp, cfg_path, ckpt):
    """tools.test on the flagship with the host loader (native C++ cube
    loader, then the numpy path) and ``EVAL_BOX_AP``: box AP beside MPJPE,
    the same detections evaluated again by the port's evaluation, eval
    ms/frame with ``use_native`` on and off (under a CUDA-only trace),
    launch counts checked against it (no preprocess on the card: the host
    normalizes)."""
    import numpy as np
    from rtpose_tpu_torch import native, ops
    from rtpose_tpu_torch.api import build_dataset_from_cfg
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.tools import test as port_test

    t0 = time.perf_counter()
    native.get_lib()
    res = {"native_build_s": time.perf_counter() - t0}
    print(f"[rest box AP] native cube loader built (or found) in {res['native_build_s']:.1f} s")
    for tag, extra in (("native", ""), ("numpy", "data['test']['use_native'] = False\n")):
        path = rest_config(tmp, f"box_ap_{tag}", cfg_path,
                           "DATASET['EVAL_BOX_AP'] = True\n" + extra)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out, _, symbols = cuda_trace(lambda: port_test.main(
            [path, "--checkpoint", ckpt, "--work_dir", os.path.join(tmp, f"rest_{tag}"),
             "--testset", "--speed_test"]))
        wall = time.perf_counter() - t0
        counts = eval_launches(f"box AP ({tag})", out, symbols)
        if len(out["detections"]) != FRAMES:
            fail(f"box AP ({tag}): {len(out['detections'])} frames decoded, expected {FRAMES}")
        forwards = FRAMES + eval_captures(out)
        if counts["preprocess"] != 0 or counts["conv3d_k3"] != K3_PER_STEP * forwards:
            fail(f"box AP ({tag}): launch counts {counts}, expected no preprocess and "
                 f"{K3_PER_STEP * forwards} conv launches")
        box_ap = out["results"]["box_ap"]
        aps = [box_ap[m]["Pedestrian"] for m in ("bev", "3d")]
        if not all(0.0 <= a <= 1.0 for a in aps):
            fail(f"box AP ({tag}) out of [0, 1]: {aps}")
        cfg = Config.fromfile(path)
        ds = build_dataset_from_cfg(cfg.data, "test")
        again = ds.evaluation(out["detections"])[0]["results"]
        if again["box_ap"] != box_ap or again["MPJPE"] != out["results"]["MPJPE"]:
            fail(f"box AP ({tag}): the port's evaluation of the same detections differs: "
                 f"{again['box_ap']} vs {box_ap}")
        res[tag] = dict(use_native=ds.use_native, ms_per_frame=out["sec_per_frame"] * 1e3,
                        wall_s=wall, mpjpe_mm=out["results"]["MPJPE"], box_ap_bev=aps[0],
                        box_ap_3d=aps[1], launches=counts)
        print(f"[rest box AP] {tag}: tools.test {wall:.1f} s wall, "
              f"{out['sec_per_frame'] * 1e3:.3f} ms/frame at B=1 (host loader); MPJPE "
              f"{out['results']['MPJPE']} mm; box AP bev {aps[0]}, 3d {aps[1]}; "
              f"launch counts {counts}")
    if native._lib is None or not res["native"]["use_native"] or res["numpy"]["use_native"]:
        fail("box AP: the native cube loader was not the host path of the native run")
    if res["native"]["mpjpe_mm"] != res["native"]["mpjpe_mm"]:
        fail("box AP: MPJPE is not a number")
    # the two host paths of one frame: at most one float32 ulp apart
    ds = build_dataset_from_cfg(Config.fromfile(cfg_path).data, "test")
    s = ds.samples[0]
    a = ds.get_cube(s["seq"], s["rdr_frame"])
    ds.use_native = False
    b = ds.get_cube(s["seq"], s["rdr_frame"])
    ulps = int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())
    if ulps > 1:
        fail(f"native and numpy cubes {ulps} ulps apart")
    res["native_vs_numpy_max_ulps"] = ulps
    return res


def rest_geometry(dev):
    """``boxes_iou3d`` / ``rotate_nms`` on GEOM_BOXES seeded boxes and
    ``circle_nms`` on their centers: the card against the CPU."""
    import numpy as np
    import torch
    from rtpose_tpu_torch.ops import nms

    rng = np.random.default_rng(26)
    n = GEOM_BOXES
    boxes = np.concatenate([rng.uniform(-8, 8, (n, 3)), rng.uniform(0.4, 2.0, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    b_c, s_c = torch.from_numpy(boxes), torch.from_numpy(scores)
    b_g, s_g = b_c.to(dev), s_c.to(dev)
    iou_c = nms.boxes_iou3d(b_c, b_c)
    iou_g = nms.boxes_iou3d(b_g, b_g)
    err = check_close("boxes_iou3d card vs cpu", iou_g.cpu(), iou_c, 0.0, GEOM_ATOL)
    keep_c, num_c = nms.rotate_nms(b_c, s_c, NMS_THRESH, post_max_size=NMS_POST)
    keep_g, num_g = nms.rotate_nms(b_g, s_g, NMS_THRESH, post_max_size=NMS_POST)
    if keep_g.cpu().tolist() != keep_c.tolist() or int(num_g) != int(num_c):
        fail(f"rotate_nms keep lists differ: card {int(num_g)} kept, cpu {int(num_c)}")
    dets = torch.cat([b_c[:, :2], s_c[:, None]], 1)
    ck_c, cn_c = nms.circle_nms(dets, 1.0, post_max_size=NMS_POST)
    ck_g, cn_g = nms.circle_nms(dets.to(dev), 1.0, post_max_size=NMS_POST)
    if ck_g.cpu().tolist() != ck_c.tolist() or int(cn_g) != int(cn_c):
        fail("circle_nms keep lists differ")
    iou_ms = wrapper_ms(lambda: nms.boxes_iou3d(b_g, b_g), iters=10, warmup=2)
    nms_ms = wrapper_ms(lambda: nms.rotate_nms(b_g, s_g, NMS_THRESH, post_max_size=NMS_POST),
                        iters=3, warmup=1)
    print(f"[rest geometry] {n} boxes: iou3d max err card vs cpu {err:.2e}; rotate_nms kept "
          f"{int(num_g)} (equal lists), circle_nms kept {int(cn_g)} (equal); card "
          f"boxes_iou3d {iou_ms:.3f} ms, rotate_nms {nms_ms:.3f} ms (eager)")
    return dict(boxes=n, iou3d_max_abs_err=err, rotate_nms_kept=int(num_g),
                circle_nms_kept=int(cn_g), iou3d_ms=iou_ms, rotate_nms_ms=nms_ms)


def rest_rpn(dev):
    """The RPN neck at the reference's default widths on a seeded flagship
    backbone feature (B=8 x 16 Z planes of 64 x 160 x 128), train mode,
    forward and backward: the card against the CPU (outputs and running
    statistics to RPN_FRAC; the input and parameter gradients to phase 14's
    norm and cosine tolerances), and the card's time."""
    import torch
    from rtpose_tpu_torch.models import RPN, init_weights

    cpu = init_weights(RPN(), torch.Generator().manual_seed(26))
    gpu = RPN().to(dev)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(27)
    x = torch.randn(RPN_SHAPE, generator=g)
    # the loss mean(out * w) with seeded weights w
    w = torch.randn(*RPN_SHAPE[:-3], RPN_SHAPE[-3] // 2, RPN_SHAPE[-2] // 2, 768, generator=g)

    def step(model, inp, weights):
        inp = inp.clone().requires_grad_(True)
        model.zero_grad(set_to_none=True)
        out = model(inp, train=True)
        (out * weights).mean().backward()
        return out.detach(), inp.grad

    def flat_grads(model):
        return torch.cat([p.grad.reshape(-1).double().cpu() for p in model.parameters()])

    x_g, w_g = x.to(dev), w.to(dev)
    out_g, gx_g = step(gpu, x_g, w_g)
    gp_g = flat_grads(gpu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_c, gx_c = step(cpu, x, w)
    t_cpu = time.perf_counter() - t0
    gp_c = flat_grads(cpu)
    res = {"out_err_frac": check_close("RPN output card vs cpu", out_g.cpu(), out_c, 0.0,
                                       RPN_FRAC * out_c.abs().max().item())
           / out_c.abs().max().item()}
    bufs = dict(gpu.named_buffers())
    for name, want in cpu.named_buffers():
        check_close(f"RPN {name} card vs cpu", bufs[name].cpu(), want, 0.0,
                    RPN_FRAC * want.abs().max().item())
    # the gradients: BatchNorm's backward projects out two directions per
    # channel at each of 17 layers, so elementwise they carry float32 noise
    # of a few per cent of their largest value even on one device (the CPU
    # in float32 against float64 at (1, 4, 64, 160, 128)); held as phase 14
    # holds a train step's
    for tag, a, b in (("input", gx_g.double().cpu().reshape(-1), gx_c.double().reshape(-1)),
                      ("params", gp_g, gp_c)):
        rel = abs(a.norm().item() - b.norm().item()) / b.norm().item()
        cos = float(a @ b / (a.norm() * b.norm()))
        res[f"grad_{tag}_norm_rel_err"], res[f"grad_{tag}_cosine"] = rel, cos
        if rel > TRAIN_GNORM_RTOL or cos < TRAIN_MIN_COS:
            fail(f"RPN {tag} gradient card vs cpu: norm {rel:.2e} relative, cosine {cos}")
    del out_g, gx_g
    ms = wrapper_ms(lambda: step(gpu, x_g, w_g), iters=5, warmup=2)
    fwd_ms = wrapper_ms(lambda: gpu(x_g, train=True), iters=5, warmup=1)
    prec = getattr(getattr(torch.backends.cudnn, "conv", None), "fp32_precision", None)
    print(f"[rest rpn] output {tuple(out_c.shape)}; card vs cpu: {res}; running stats within "
          f"{RPN_FRAC}; card forward+backward {ms:.2f} ms, forward {fwd_ms:.2f} ms (train mode, "
          f"float32, input {RPN_SHAPE}; cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"conv fp32_precision {prec}); CPU step {t_cpu:.1f} s")
    return dict(res, input_shape=list(RPN_SHAPE), output_shape=list(out_c.shape),
                fwd_bwd_ms=ms, fwd_ms=fwd_ms, cpu_step_s=t_cpu)


def rest_modules(dev):
    """PolarToCart (both dimensions), BEVFeatureExtractor and RoIHead (with
    ``assign_roi_targets``) at their default widths: the card against the
    CPU."""
    import numpy as np
    import torch
    from rtpose_tpu_torch.data.synthetic import ROI1
    from rtpose_tpu_torch.models import (BEVFeatureExtractor, PolarToCart, RoIHead,
                                         assign_roi_targets, init_weights)

    g = torch.Generator().manual_seed(28)
    res = {}
    for dim, shape in (("2", (8, 64, 160, 128)), ("3", (2, 16, 64, 160, 32))):
        m = PolarToCart(cart_roi=ROI1, dimension=dim, polar_range=(0, 12, -60, 60, -30, 30))
        x = torch.randn(shape, generator=g)
        want = m(x)
        got = m.to(dev)(x.to(dev)).cpu()
        res[f"polar_to_cart_{dim}d"] = check_close(
            f"PolarToCart {dim}-D card vs cpu", got, want, 0.0,
            TAPS_FRAC * want.abs().max().item()) / want.abs().max().item()
        res[f"polar_to_cart_{dim}d_shape"] = list(want.shape)
    bev = BEVFeatureExtractor()
    feat = torch.randn(8, 160, 160, 256, generator=g)
    centers = torch.rand(8, 128, 2, generator=g) * 16.0       # world xy on the 0.1 m map
    want = bev(feat, centers)
    got = bev(feat.to(dev), centers.to(dev)).cpu()
    res["bev"] = check_close("BEV card vs cpu", got, want, 0.0,
                             TAPS_FRAC * want.abs().max().item()) / want.abs().max().item()
    head = init_weights(RoIHead(), torch.Generator().manual_seed(29))
    want = head(want)
    head_g = RoIHead().to(dev)
    head_g.load_state_dict(head.state_dict())
    got = head_g(got.to(dev))
    for k in ("rcnn_cls", "rcnn_reg"):
        res[f"roi_{k}"] = check_close(f"RoIHead {k} card vs cpu", got[k].cpu(), want[k], 0.0,
                                      ROI_FRAC * want[k].abs().max().item()) \
            / want[k].abs().max().item()
    rng = np.random.default_rng(30)
    gt = np.concatenate([rng.uniform(-4, 4, (16, 3)), rng.uniform(0.5, 2.0, (16, 3)),
                         rng.uniform(-np.pi, np.pi, (16, 1))], 1).astype(np.float32)
    rois = (gt[rng.integers(0, 16, 128)] + rng.normal(scale=0.3, size=(128, 7))).astype(
        np.float32)
    t_c = assign_roi_targets(torch.from_numpy(rois), torch.ones(128), torch.from_numpy(gt), 12)
    t_g = assign_roi_targets(torch.from_numpy(rois).to(dev), torch.ones(128, device=dev),
                             torch.from_numpy(gt).to(dev), 12)
    if not torch.equal(t_g["labels"].cpu(), t_c["labels"]):
        fail("assign_roi_targets labels differ card vs cpu")
    res["roi_max_iou"] = check_close("assign_roi_targets max_iou card vs cpu",
                                     t_g["max_iou"].cpu(), t_c["max_iou"], 0.0, GEOM_ATOL)
    print(f"[rest modules] card vs cpu, error / max magnitude: {res}")
    return res


def distill_cfg(dtype=None):
    """Distillation of the shipped LiDAR VoxelNet (teacher) into the flagship
    RadarPoseNet (student) whose final conv and head take 64 channels (the
    teacher's feature width; the flagship's is 128).  ``dtype`` overrides
    every backbone's and head's compute dtype (the CPU copy: float32)."""
    import copy

    from rtpose_tpu_torch.config import Config

    student = copy.deepcopy(dict(Config.fromfile(FLAGSHIP).model))
    student["backbone"]["final_conv_out"] = 64
    student["pose_head"]["in_channels"] = 64
    teacher = copy.deepcopy(dict(Config.fromfile(LIDAR_CFG).model))
    for m in (student, teacher):
        if dtype is not None:
            m["backbone"]["dtype"] = dtype
            m["pose_head"]["dtype"] = dtype
    return dict(type="Distillation", student=student, teacher=teacher)


def rest_distill(tmp, dev):
    """Distillation at full width, B=2: the student's raw cubes through the
    preprocess kernel, the teacher frozen through ``utils.freeze``, three
    AdamW steps of ``distill_loss`` on the card; launch counts, the
    teacher's parameters bit-equal after the steps and the student's moved,
    device ms a step, and the first step's loss against the CPU port in
    float32 (phase 14's tolerance)."""
    import numpy as np
    import torch
    from rtpose_tpu_torch import ops
    from rtpose_tpu_torch.api import build_dataset_from_cfg
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import generate_synthetic_dataset
    from rtpose_tpu_torch.engine import VOXEL_KEYS, preprocess_raw
    from rtpose_tpu_torch.models import build_detector, init_weights
    from rtpose_tpu_torch.utils import split_frozen

    root = os.path.join(tmp, "distill_data")
    generate_synthetic_dataset(root, num_seqs=1, frames_per_seq=DISTILL_FRAMES,
                               test_frames_per_seq=0, seed=9, roi_only=True, with_lidar=True)
    rcfg = Config.fromfile(rest_config(tmp, "distill_radar", FLAGSHIP,
                                       f"DATASET['DIR']['ROOT_DIR'] = {root!r}\n"
                                       "DATASET['DIR']['CUBES_ARE_ROI'] = True\n"))
    lcfg = Config.fromfile(lidar_config(tmp, "distill", root))
    rds = build_dataset_from_cfg(rcfg.data, "train", device_preprocess=True)
    lds = build_dataset_from_cfg(lcfg.data, "train")
    if [s["rdr_frame"] for s in rds.samples] != [s["rdr_frame"] for s in lds.samples]:
        fail("distillation: the radar and LiDAR datasets list different frames")
    norm = (rds.norm_start, rds.norm_scale)

    def batch(i, device):
        """Raw cubes (B, D, Z, Y, X) and the voxel batch of step i."""
        idx = range(i * DISTILL_B, (i + 1) * DISTILL_B)
        raw = torch.from_numpy(np.stack([rds[j]["rdr_raw"] for j in idx])).to(device)
        items = [lds[j] for j in idx]
        lidar = {k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items])).to(device)
                 for k in VOXEL_KEYS}
        return raw, lidar

    model = init_weights(build_detector(distill_cfg()), torch.Generator().manual_seed(0))
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    cpu = build_detector(distill_cfg("float32"))
    cpu.load_state_dict(sd0)
    model = model.to(dev).train()
    opt = split_frozen(lambda ps: torch.optim.AdamW(ps, lr=DISTILL_LR, weight_decay=0.01),
                       model, ["teacher"])
    n_frozen = sum(p.numel() for p in model.teacher.parameters())
    if any(p.requires_grad for p in model.teacher.parameters()):
        fail("distillation: a teacher parameter still needs a gradient")
    batches = [batch(i, dev) for i in range(DISTILL_STEPS)]
    ops.reset_launch_counts()
    losses, ms = [], []
    for raw, lidar in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        opt.zero_grad(set_to_none=True)
        radar = {"rdr_tensor": preprocess_raw(raw, norm)}
        loss = model.distill_loss(*model(radar, lidar))
        loss.backward()
        opt.step()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(loss.item())
    counts = ops.launch_counts()
    want = dict(preprocess=DISTILL_STEPS, conv3d_k3=DISTILL_STEPS * (K3_STUDENT + K3_LIDAR),
                conv3d_k3_bwd=DISTILL_STEPS * K3_STUDENT)
    if any(counts[k] != v for k, v in want.items()) or counts["conv3d_k3_int8"]:
        fail(f"distillation: launch counts {counts}, expected {want}")
    if not all(np.isfinite(losses)):
        fail(f"distillation: non-finite losses {losses}")
    # the student's regression tower is not in the loss: its tensors get no
    # gradient, and AdamW leaves them; every tensor with a gradient moved
    graded = [(n, p) for n, p in model.student.named_parameters() if p.grad is not None]
    moved = [not torch.equal(p.detach().cpu(), sd0[f"student.{n}"]) for n, p in graded]
    if not all(torch.equal(p.detach().cpu(), sd0[f"teacher.{n}"])
               for n, p in model.teacher.named_parameters()):
        fail("distillation: a frozen teacher parameter changed")
    n_student = sum(1 for _ in model.student.parameters())
    if not all(moved) or len(graded) < n_student // 2:
        fail(f"distillation: {sum(moved)} of {len(graded)} student tensors with a gradient "
             f"moved ({n_student} in all)")
    t0 = time.perf_counter()
    with torch.no_grad():
        raw_c, l_c = batch(0, torch.device("cpu"))
        loss_c = cpu.distill_loss(*cpu({"rdr_tensor": preprocess_raw(raw_c, norm)}, l_c)).item()
    t_cpu = time.perf_counter() - t0
    rel = abs(losses[0] - loss_c) / abs(loss_c)
    if rel > TRAIN_LOSS_RTOL:
        fail(f"distillation: first loss card {losses[0]} vs cpu {loss_c} ({rel:.2e} relative)")
    print(f"[rest distill] {DISTILL_STEPS} steps at B={DISTILL_B}: losses {losses}; card "
          f"ms/step {ms}; launch counts {counts}; teacher ({n_frozen} parameters) bit-equal, "
          f"{sum(moved)}/{n_student} student tensors moved (all with a gradient); first loss "
          f"card {losses[0]} cpu "
          f"{loss_c} (rel {rel:.2e}, CPU forward {t_cpu:.1f} s)")
    return dict(batch=DISTILL_B, steps=DISTILL_STEPS, losses=losses, ms_per_step=ms,
                launches=counts, teacher_params=n_frozen, student_tensors_moved=sum(moved),
                student_tensors=n_student, first_loss_cpu=loss_c, first_loss_rel_err=rel)


def phase_rest(tmp, cfg_path, ckpt, dev):
    """Phase 26: box AP through tools.test, geometry, the RPN neck, the
    second stage and RoI head, and distillation; the phase's wall time."""
    t0 = time.perf_counter()
    rest = dict(box_ap=rest_box_ap(tmp, cfg_path, ckpt), geometry=rest_geometry(dev),
                rpn=rest_rpn(dev), modules=rest_modules(dev), distill=rest_distill(tmp, dev))
    rest["wall_s"] = time.perf_counter() - t0
    print(f"[rest] phase wall {rest['wall_s']:.1f} s")
    return rest


BREAKDOWN_ITERS = 3     # calls per segment between CUDA events, and again traced
BREAKDOWN_WORKER = "--breakdown_worker"   # chip_smoke.py --breakdown_worker OUT: phase 27
BREAKDOWN_TIMEOUT_S = 600
BREAKDOWN_SUM_FRAC = 0.25   # the inference segments' sum against the whole predict
BREAKDOWN_K3 = dict(        # K3 launches a call of each segment: (forward, grad-input)
    infer=dict(backbone=(14, 0), hm=(0, 0), argmax=(0, 0), reg=(0, 0), full=(14, 0)),
    train=dict(targets=(0, 0), loss_fwd=(14, 0), fwd_bwd=(14, 14), optimizer=(0, 0),
               full=(14, 14)),
    backbone=dict(layer1=(2, 0), stage2=(4, 0), stage3=(4, 0), stage4=(4, 0),
                  transition2=(0, 0), transition3=(0, 0), final_fuse=(0, 0)),
    head=dict(conv0=(0, 0), out_f32=(0, 0), out_bf16=(0, 0), out8_bf16=(0, 0)))


def breakdown_counts(tag, segs, want, kernel="conv3d_k3"):
    """Each segment's launches a call of ``kernel`` (forward) and of the
    grad-input equal to ``want``; every row's device time positive."""
    for name, (fwd, bwd) in want.items():
        got = segs[name]["launches"]
        if got[kernel] != fwd or got["conv3d_k3_bwd"] != bwd:
            fail(f"breakdown {tag} {name}: launches a call {got}, want {kernel} {fwd}, "
                 f"grad-input {bwd}")
        if not segs[name]["ms"] > 0:
            fail(f"breakdown {tag} {name}: device time {segs[name]['ms']}")


def phase_breakdown(dev):
    """Phase 27: ``rtpose_tpu_torch.tools.perf_breakdown`` at the flagship's
    full width (seeded weights): the inference segments in bf16, int8 and
    int8 + resize at B=1 and B=8, the train segments, the backbone's stages
    and the hm tower's convs at B=8; each segment's device time positive and
    its kernel launches a call as the path runs them (``BREAKDOWN_K3``); the
    inference segments' sum against the whole predict (a gap above
    ``BREAKDOWN_SUM_FRAC`` is printed, not failed); and ``estimate_flops``
    on the card equal to the CPU's (a float32 copy of the model) for
    ``predict_sparse`` at B=1 in bf16 and int8 and for one forward +
    backward of the sparse loss at B=1."""
    import copy

    import numpy as np
    import torch
    from rtpose_tpu_torch.engine import bind_sites
    from rtpose_tpu_torch.models import build_detector, init_weights
    from rtpose_tpu_torch.ops import quant
    from rtpose_tpu_torch.tools import perf_breakdown as pb
    from rtpose_tpu_torch.utils.flops import estimate_flops

    t0 = time.perf_counter()
    asm = pb.flagship()
    shape = asm.input_shape_zyxc
    rng = np.random.default_rng(0)
    model = init_weights(asm.model, torch.Generator().manual_seed(0))
    cfg32 = copy.deepcopy(asm.model_cfg)
    cfg32["backbone"]["dtype"] = cfg32["pose_head"]["dtype"] = "float32"
    cpu = build_detector(cfg32)
    cpu.load_state_dict(model.state_dict())
    bind_sites(cpu)
    model = model.to(dev)
    out, xs = {}, {}
    for B in (1, 8):
        timer = pb.SegmentTimer(dev, BREAKDOWN_ITERS, B)
        xs[B] = x = pb.random_input(rng, (B, *shape), dev)
        base = out[f"infer_b{B}"] = pb.infer_segments(model, x, timer)
        int8 = pb.int8_segments(model, x, pb.random_input(rng, (B, *shape), dev), timer, base)
        for label, segs in int8.items():
            out[f"{label}_b{B}"] = segs
        if int8["int8"]["sites"] != INT8_SITES:
            fail(f"breakdown int8: {int8['int8']['sites']} sites, want {INT8_SITES}")
        for label in ("infer", "int8", "int8+resize"):
            segs = out[f"{label}_b{B}"]
            breakdown_counts(f"{label} B={B}", segs, BREAKDOWN_K3["infer"],
                             "conv3d_k3" if label == "infer" else "conv3d_k3_int8")
            gap = abs(segs["sum"]["ms"] - segs["full"]["ms"]) / segs["full"]["ms"]
            segs["sum_vs_full"] = gap
            print(f"[breakdown] {label} B={B}: segments sum {segs['sum']['ms']} ms against "
                  f"the whole predict's {segs['full']['ms']} ms ({100 * gap:.1f} % apart)"
                  + ("" if gap <= BREAKDOWN_SUM_FRAC else
                     f"; FINDING: above {100 * BREAKDOWN_SUM_FRAC:.0f} %"))
    out["infer_wall_s"] = time.perf_counter() - t0
    timer = pb.SegmentTimer(dev, BREAKDOWN_ITERS, 8)
    out["backbone_b8"] = pb.backbone_segments(asm, 8, rng, timer)
    breakdown_counts("backbone B=8", out["backbone_b8"], BREAKDOWN_K3["backbone"])
    out["head_b8"] = pb.head_segments(asm, 8, rng, timer)
    breakdown_counts("head B=8", out["head_b8"], BREAKDOWN_K3["head"])

    # the FLOP count, card against CPU, on the seeded weights (before the
    # train segments move them)
    t1 = time.perf_counter()
    x1c = xs[1].cpu()
    scales = quant.calibration_scales(model.predict_sparse, [xs[1]])
    counts = {}
    with torch.inference_mode():
        counts["predict_sparse_bf16"] = (estimate_flops(model.predict_sparse, xs[1]),
                                         estimate_flops(cpu.predict_sparse, x1c))
        with quant.int8_mode(scales):
            counts["predict_sparse_int8"] = (estimate_flops(model.predict_sparse, xs[1]),
                                             estimate_flops(cpu.predict_sparse, x1c))
    b1 = pb.train_batch(asm, xs[1])
    fb = [pb.train_calls(asm, m, {k: v.to(d) for k, v in b1.items()})["fwd_bwd"]
          for m, d in ((model, dev), (cpu, torch.device("cpu")))]
    counts["loss_fwd_bwd"] = (estimate_flops(fb[0]), estimate_flops(fb[1]))
    for name, (card, host) in counts.items():
        print(f"[breakdown] estimate_flops {name} B=1: card {card}, CPU {host}")
        if not card or card != host:
            fail(f"breakdown: estimate_flops {name} on the card {card} != the CPU's {host}")
    out["flops_wall_s"] = time.perf_counter() - t1

    out["train_b8"] = pb.train_segments(asm, model, pb.train_batch(asm, xs[8]), timer)
    breakdown_counts("train B=8", out["train_b8"], BREAKDOWN_K3["train"])
    out["flops_card_vs_cpu"] = {k: v[0] for k, v in counts.items()}
    out["wall_s"] = time.perf_counter() - t0
    print(f"[breakdown] phase wall {out['wall_s']:.1f} s (inference segments "
          f"{out['infer_wall_s']:.1f} s, FLOP counts card and CPU {out['flops_wall_s']:.1f} s)")
    return out


def breakdown_worker(out_path) -> int:
    """Phase 27 in a process of its own: ``phase_breakdown`` on the card,
    its dict written to ``out_path``."""
    from rtpose_tpu_torch.api import resolve_device
    out = phase_breakdown(resolve_device("cuda"))
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def phase_breakdown_process(tmp):
    """Phase 27 through ``--breakdown_worker``: a fresh process, since
    traces taken late in this one, after the earlier phases' hundreds of
    profiler traces, lost their first device operations (the kernels of
    ``tools.perf_breakdown``'s short segments entirely), while the same
    traces in a fresh process held every one."""
    out_path = os.path.join(tmp, "breakdown.json")
    rc, text = run_process_group([sys.executable, os.path.abspath(__file__), BREAKDOWN_WORKER,
                                  out_path], BREAKDOWN_TIMEOUT_S)
    print(text, end="")
    if rc != 0:
        fail(f"phase 27: the breakdown worker exited {rc}")
    with open(out_path) as f:
        return json.load(f)


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
    if len(sys.argv) == 3 and sys.argv[1] == DP_WORKER:
        return dp_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == BREAKDOWN_WORKER:
        return breakdown_worker(sys.argv[2])
    from rtpose_tpu_torch.api import resolve_device

    t_all = time.perf_counter()
    smi = smi_line()
    print(f"[card] {smi}")
    dev = resolve_device("cuda")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    phase_build()
    kernels = [*phase_preprocess(dev), phase_conv(dev), phase_conv_bwd(dev),
               phase_conv_int8(dev), phase_deform(dev), phase_group_norm(dev),
               phase_resize(dev)]
    phase_autograd(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path, cfg, ckpt = write_inputs(tmp)
        out, counts = phase_e2e(tmp, cfg_path, ckpt)
        e2e = phase_speed_and_trace(tmp, cfg_path, ckpt, out["sec_per_frame"] * 1e3)
        phase_cpu_compare(cfg, ckpt, out["detections"], dev)
        serving = phase_serving(tmp, cfg_path, cfg, ckpt, dev)
        train_cfg = write_train_inputs(tmp)
        train, host_run = phase_train(tmp, train_cfg)
        train.update(phase_train_trace(tmp, train_cfg, train["ms_per_step_median"]))
        train["trained_mpjpe_mm"] = phase_train_eval(tmp, train_cfg, train.pop("checkpoint"))
        train.update(phase_train_compare(train_cfg, dev))
        train["cache"] = phase_cache_content(train_cfg, dev)
        p0 = seeded_params(train_cfg)
        train["device_cache"], cached_run = phase_train_cached(tmp, train_cfg, host_run, p0)
        train["fused"] = phase_train_fused(tmp, train_cfg, cached_run, p0,
                                           train["device_cache"]["param_rel_dist"])
        train["stream"] = phase_train_stream(tmp, train_cfg)
        train["profile"] = phase_train_profile(tmp, train_cfg)
        train_root = os.path.join(tmp, "train_data")
        slices = dict(skel_mp2=phase_skel_mp2(tmp, dev), dcn=phase_dcn(tmp, train_root, dev),
                      phase=phase_complex(tmp), repeat=phase_repeat(tmp, train_root),
                      lidar=phase_lidar(tmp, dev))
        rest = phase_rest(tmp, cfg_path, ckpt, dev)
        breakdown = phase_breakdown_process(tmp)
        dp = phase_dp(tmp, train_cfg, (host_run, cached_run, p0,
                                       train["device_cache"]["param_rel_dist"]))
    tc, ft = train["launches"], train["fused"]["trace_launches"]
    k1, k2, k3, k3_bwd, k3_int8, k_deform, k_gn, k_rs = kernels
    # the deformable head's eval: its slice's tools.test (eager, capture, replays)
    k_deform["launches"] = slices["dcn"]["test"]["launches"]["deform_conv2d"]
    # the serving path's own run: the int8 artifact through tools.test
    k3_int8["launches"] = serving["launches"]["int8"]["conv3d_k3_int8"]
    k1["launches"] = e2e["launches"]["preprocess"]
    # on no path: its wrapper's count over the eval run and every training run
    k2["launches"] = counts["preprocess_single"] + sum(
        r["preprocess_single"] for r in (tc, train["device_cache"]["launches"],
                                         train["fused"]["wrapper_launches"],
                                         train["stream"]["launches"]))
    k3["launches"] = e2e["launches"]["conv3d_k3"]
    k3_bwd["launches"] = tc["conv3d_k3_bwd"]
    k_gn["launches"] = e2e["launches"]["group_norm"]
    k_rs["launches"] = e2e["launches"]["resize_trilinear"]
    for k, name in ((k1, "preprocess"), (k3, "conv3d_k3"), (k3_bwd, "conv3d_k3_bwd"),
                    (k_gn, "group_norm"), (k_rs, "resize_trilinear")):
        k["kernel_ms"] = k["ms"]
        k["train_launches"] = tc[name]
    # the replays of the traced fused epoch, by kernel symbol in the trace
    k1["fused_trace_launches"] = ft["preprocess_kernel"]
    k3["fused_trace_launches_with_bwd"] = ft["conv3d_k3_kernel"]
    k3_bwd["fused_trace_launches_with_fwd"] = ft["conv3d_k3_kernel"]
    # each slice path's own runs: the wrappers' counts, reset just before each
    names = {"preprocess": k1, "preprocess_single": k2, "conv3d_k3": k3,
             "conv3d_k3_bwd": k3_bwd, "conv3d_k3_int8": k3_int8, "deform_conv2d": k_deform,
             "group_norm": k_gn, "resize_trilinear": k_rs}
    lidar = slices["lidar"]
    for name, k in names.items():
        k["path_launches"] = {}
        for path, r in slices.items():
            k["path_launches"][f"{path}_train"] = r["train"]["launches"][name]
            if "test" in r:
                k["path_launches"][f"{path}_test"] = r["test"]["launches"][name]
        k["path_launches"]["lidar_tta_test"] = lidar["tta"]["launches"][name]
        for kind in ("bf16", "int8"):
            k["path_launches"][f"lidar_{kind}_artifact"] = \
                lidar["serving"][kind]["launches"][name]
        # phase 25, rank 0: the per-step run, the fused run (its warm-up step
        # and capture) and tools.test --multihost
        for path, counts_ in (("dp_train", dp["launches"]), ("dp_fused", dp["fused_launches"]),
                              ("dp_test", dp["test_launches"])):
            k["path_launches"][path] = counts_[name]
        # phase 26: the box-AP evals (host loader, native and numpy) and the
        # three distillation steps
        for path, counts_ in (("rest_box_ap_native_test", rest["box_ap"]["native"]["launches"]),
                              ("rest_box_ap_numpy_test", rest["box_ap"]["numpy"]["launches"]),
                              ("rest_distill_train", rest["distill"]["launches"])):
            k["path_launches"][path] = counts_[name]
    e2e["mpjpe_mm"] = out["results"]["MPJPE"]
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"train": train}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"slices": slices}))
    print(json.dumps({"dp": dp}))
    print(json.dumps({"rest": rest}))
    print(json.dumps({"breakdown": breakdown}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
