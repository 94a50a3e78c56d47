"""The loop of a serving cell: the program's int8 serving artifact, made as
``tools.export --int8`` makes it and run as ``tools.test --exported`` runs
it, in a closed loop of batches through ``engine.evaluator.run_eval``.

Set-up: the seeded weights into the program's model; the calibration
(``export.calibrate_predict``) over ``calib_batches`` batches of seeded
frames from a generator stream of their own (the run's seed plus
``CALIB_SEED``); the artifact exported for the traffic's batch on the card
(``export.export_predict`` with the scales and the configuration's ``int8``
exclusions), saved (``save_exported``) to a temporary file and loaded back
(``load_predict``); then ``warm_frames`` frames through ``run_eval``.  The
set-up's parts go to stderr, in seconds.

The frames are prepared on the host as the dataset prepares a
``dzyx_real`` cube (ROI crop, ``(x - n0) / n1`` with the configuration's
``DZYX`` normalizing values, clamp >= 0, channels-last float32): the
artifact's input contract (``tools.test`` refuses ``--device_preprocess``
with ``--exported``).  ``eval_tensor.TensorStream`` yields them from pinned
host memory, cycling; ``run_eval`` copies each batch to the card on its
prefetch thread and calls ``predict(model_input_of(batch, "rdr_tensor"))``,
which replays the loaded program's CUDA graph (``predict.graphs``; the
warm-up's calls ran it eagerly and captured it).  A program that serves the
loaded artifact eagerly (no ``predict.graphs``) cannot run the cell: the run
ends with exit code 1 once the artifact is loaded (``replayed``).  Eagerly
the host dispatches the program's ~1,500 operations one by one, a batch
takes that dispatch and then the card's tail, and its time follows the
shared host's speed: on an H100 its median batch read 70.5-81.3 ms over
five processes on one card (IQR / median 10.9 %, 6.8 % with the dispatch
thread on a core of its own and the garbage collector paused), where the
cell's bounds need under 2.75 %.

The window, a frame's time, the traced stretch and the result's keys are
``eval_stream``'s.  The traced run hands the window's counts to
``Trace.extra``: ``export.counts()``, ``ops.launch_counts()`` and
``ops.quant.counts()`` over the window (the last stays 0: the loaded
program runs no Python site), and ``quant_forward``, the site counts of one
eager int8 forward after the window (the function the artifact was traced
from); a program without those counters gives None for them.

The check, after the window, holds two numbers to limits.  The reference
(``reference/int8.py``) calibrates itself on the run's calibration frames.
``scale_ulps``: the program's 51 activation scales against the reference's
own, in bfloat16 ulps of the absmax (a wrong statistic, a site left
uncalibrated or a scale given to the wrong site reads far above the
limit).  ``answers_off``: how many of the sampled answers (the traffic's
``check_frames``, every slot of a batch among them) lie more than
``OFF_VOXELS`` from every near-tie of the int8 reference at the program's
scales so held, fed the same tensors (``reference/evaluate.py``; why not
at its own: ``reference_check``).  A value one
bfloat16 ulp from the reference's may quantize one int8 step away, and such
steps multiply from site to site, so a few answers of a sample drift from
the reference while the rest equal it: the worst answer (``kpt_gap``,
reported with ``kpt_gap_p50``, ``peak_gap`` and ``score_gap``) is not held.
``extra`` adds, for ``benchmark/calibrate.py``, the controls ``bf16`` (the
same model exported without scales) and ``double_scale`` (every activation
scale doubled: a bit fewer), both judged as the program is; ``own``
(the program's answers against the reference at its own scales),
``float32`` (against the float32 flagship reference, ``reference/model.py``)
and ``answers`` (each run's sampled answers' ``kpt_gap``, sorted), none
judged.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import check, counts, data
from benchmark.harness.eval_stream import Timed, _answers
from benchmark.harness.eval_tensor import TensorStream
from benchmark.harness.trace import Schedule
from benchmark.reference import evaluate as ref_eval
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.reference.dcn import NoTF32

CALIB_SEED = 1 << 40        # the calibration frames' seed, over the run's
CONTROLS = ("bf16", "double_scale")
OFF_VOXELS = 1.0            # an answer further from every near-tie is off
QMAX = 127.0


def prepared_frames(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The traffic's seeded frames on ``device``, prepared as the dataset
    prepares a ``dzyx_real`` cube: (n, Z, Y, X, D) float32."""
    raw = data.make_frames(cfg, traffic, seed, device)["raw"]
    n0, n1 = (float(v) for v in cfg["DATASET"]["DZYX"]["NORMALIZING_VALUE"])
    out = torch.empty((raw.shape[0], *raw.shape[2:], raw.shape[1]), dtype=torch.float32,
                      device=device)
    for i in range(raw.shape[0]):
        out[i] = ref_eval.preprocess(raw[i], n0, n1 - n0)
    return out


def calib_frames(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The calibration frames: ``calib_batches`` batches of frames from a
    seed stream of their own, prepared as the traffic's."""
    n = int(traffic["batch_per_rank"]) * int(cfg["int8"]["calib_batches"])
    return prepared_frames(cfg, dict(traffic, frames=n), int(seed) + CALIB_SEED, device)


def reference_scales(model, scales: Dict[str, float]) -> Dict[str, float]:
    """The program's scales (keyed by its site paths) under the reference's
    names, which are the state dict's module names."""
    from rtpose_tpu_torch.engine.convert import site_paths
    names = {m: n for n, m in model.named_modules()}
    return {names[m]: scales[p] for m, p in site_paths(model).items() if p in scales}


def scale_ulps(got: Optional[Dict[str, float]], bounds: Dict[str, tuple]) -> float:
    """The largest gap, over the sites, of ``got``'s absmax (scale x 127)
    from the reference's bounds of it (``reference/int8.py``'s
    ``calibrate``), in bfloat16 ulps of the nearer bound (an absmax is a
    bfloat16 value): inf where ``got`` is None or lacks a site, or gives a
    site the reference finds dead (absmax 0) another scale than 1."""
    if got is None or set(got) != set(bounds):
        return math.inf
    gap = 0.0
    for name, (low, high) in bounds.items():
        if high == 0.0:
            gap = max(gap, 0.0 if got[name] == 1.0 else math.inf)
            continue
        a = got[name] * QMAX
        near = min(max(a, low), high)
        gap = max(gap, abs(a - near) / 2.0 ** (math.floor(math.log2(near)) - 7))
    return gap


def replayed(predict):
    """``predict``, where the program replays the loaded artifact from a
    CUDA graph (``predict.graphs``); else the run ends, exit code 1 (the
    module's doc says why)."""
    if getattr(predict, "graphs", None) is None:
        raise SystemExit("serve_artifact: the program serves the loaded artifact eagerly "
                         "(load_predict gives no predict.graphs); this cell measures it "
                         "replayed from a CUDA graph")
    return predict


def artifact(asm, scales, batch: int, device, exclude: tuple, tmp: str, name: str):
    """The artifact exported, saved and loaded back: ``predict``."""
    from rtpose_tpu_torch import export
    ep = export.export_predict(asm, batch_size=batch, device=device.type, int8_scales=scales,
                               int8_exclude=exclude)
    path = os.path.join(tmp, f"{name}.pt2")
    export.save_exported(path, ep)
    del ep
    return export.load_predict(path, device=device.type)


def _counts(module):
    """``module.counts()``, or None from a program whose module has none."""
    return module.counts() if hasattr(module, "counts") else None


def _reset(module):
    if hasattr(module, "reset"):
        module.reset()


def run(cell, seed: int, seconds: float, trace: bool, device, ranks=None,
        extra: tuple = ()) -> Dict:
    from rtpose_tpu_torch import export, ops
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.engine import model_input_of, run_eval
    from rtpose_tpu_torch.ops import quant

    cfg, tr, q = cell.cfg, cell.traffic, cell.cfg["int8"]
    B = int(tr["batch_per_rank"])
    exclude = tuple(q["exclude"])
    marks = [("start", time.perf_counter())]
    weights = data.make_weights(cfg, seed, device, cell.bench_dir)
    frames = prepared_frames(cfg, tr, seed, device)
    host = data.to_host({"tensor": frames})
    del frames
    asm = assemble(Config(cell.cfg))
    model = asm.model.to(device)
    model.load_state_dict(weights)
    del weights
    model.eval()
    calib = calib_frames(cfg, tr, seed, device)
    marks.append(("weights_frames", time.perf_counter()))
    scales = export.calibrate_predict(asm, list(calib.split(B)), exclude=exclude,
                                      quantile=q["quantile"])
    del calib
    if len(scales) != int(q["sites"]):
        raise RuntimeError(f"the calibration found {len(scales)} int8 sites, the "
                           f"configuration states {q['sites']}")
    marks.append(("calibration", time.perf_counter()))
    tmp = tempfile.mkdtemp(prefix="serve_artifact_")
    try:
        predict = replayed(artifact(asm, scales, B, device, exclude, tmp, "int8"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if predict.meta["int8_sites"] != int(q["sites"]):
        raise RuntimeError(f"the artifact holds {predict.meta['int8_sites']} int8 sites")
    marks.append(("export_save_load", time.perf_counter()))

    def step(batch):
        return predict(model_input_of(batch, asm.input_key))

    def evaluate(stream, fn):
        dets, _ = run_eval(fn, stream, asm.decode_spec, device=device, one_hm=asm.one_hm)
        return dets

    evaluate(TensorStream(host, B, count=max(1, int(tr["warm_frames"]) // B)), Timed(step))
    sched = Schedule(device, tr["trace"]) if trace else None
    timed = Timed(step, sched)
    stream = TensorStream(host, B, seconds=seconds, hold=lambda: trace and not sched.done)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(("warm", time.perf_counter()))
    print("serve_artifact: set-up s " + ", ".join(
        f"{name} {t - prev:.3f}" for (_, prev), (name, t) in zip(marks, marks[1:])),
        file=sys.stderr)
    for module in (export, quant):
        _reset(module)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        dets = evaluate(stream, timed)
    finally:
        if sched is not None:
            sched.close()
    t1 = time.perf_counter()
    window_counts = dict(export=_counts(export), launches=ops.launch_counts(),
                         quant=_counts(quant))
    calls = len(timed.calls)
    n = calls * B
    # every frame of a batch waits for the whole batch: its time is the call's
    call_ms = np.diff(np.asarray(timed.calls + [t1])) * 1e3
    out: Dict = {"units": calls, "frames": n, "window_s": t1 - t0, "rate": n / (t1 - t0),
                 "setup_end": t0, "frame_ms": np.repeat(call_ms, B), "call_ms": call_ms,
                 "host_ms": timed.host_ms}
    if device.type == "cuda":
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    if trace:
        if sched.trace is None:
            raise RuntimeError("the window closed before the traced calls ended")
        # one eager int8 forward (the function the artifact was traced from)
        # counts the sites of a forward, which the loaded program does not
        _reset(quant)
        export.make_predict_fn(asm, int8_scales=scales, int8_exclude=exclude)(
            host["tensor"][:B].to(device))
        window_counts["quant_forward"] = _counts(quant)
        out["host_ms_untraced"] = timed.host_ms[:sched.after]
        out["unprofiled_s"] = (sched.opened - timed.calls[0]) / sched.after
        sched.trace.extra.update(window_counts)
        out["trace"] = sched.trace
        print(f"serve_artifact: {sched.trace.window_s / sched.count * 1e3:.4f} ms a call in "
              f"the traced stretch, {out['unprofiled_s'] * 1e3:.4f} before the profiler "
              f"started; window counts {window_counts}", file=sys.stderr)
    answers = _answers(dets)
    out["failed"] = n - sum(1 for a in answers.values() if np.isfinite(a[1]).all())
    # the k-th batch drawn gives its slot k % B, so every slot is judged
    rng = np.random.default_rng(int(seed) & ((1 << 63) - 1))
    picks = rng.choice(calls, size=min(int(tr["check_frames"]), calls), replace=False)
    sample = sorted(int(b) * B + k % B for k, b in enumerate(picks))
    del predict, timed, dets
    runs = {"program": (answers, reference_scales(model, scales))}
    for name in CONTROLS:
        if name in extra:
            sc = None if name == "bf16" else {k: 2.0 * v for k, v in scales.items()}
            runs[name] = (control_answers(asm, sc, exclude, host, sample, answers, device, B),
                          None if sc is None else reference_scales(model, sc))
    del model, asm
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    judged = reference_check(cell, seed, device, host, sample, runs, extra)
    out["numbers"] = judged.pop("program")
    out["extra"] = judged
    return out


def control_answers(asm, scales, exclude, host, sample, answers, device, B):
    """A control artifact's answers on the sampled frames, each in the batch
    the stream put it in."""
    tmp = tempfile.mkdtemp(prefix="serve_artifact_")
    try:
        predict = artifact(asm, scales, B, device, exclude, tmp, "control")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {}
    for pos in sample:
        src = answers[pos][0]
        first = src - pos % B
        kpts, scores, _ = predict(host["tensor"][first:first + B].to(device))[0]
        j = src - first
        out[pos] = (src, kpts[j].float().cpu().numpy(), float(scores[j, 0]))
    return out


def _judge(cands, picks: List[tuple], vsize) -> List[Dict[str, float]]:
    return [ref_eval.judge(cands[src], torch.from_numpy(kp), score, vsize)
            for src, kp, score in picks]


def _judged(cands, picks: List[tuple], vsize) -> Dict[str, float]:
    """``check.eval_numbers`` of the answers judged (the worst of each), the
    median ``kpt_gap`` and ``answers_off``: how many lie more than
    ``OFF_VOXELS`` from every near-tie."""
    judged = _judge(cands, picks, vsize)
    gaps = [j["kpt_gap"] for j in judged]
    return dict(check.eval_numbers(judged), kpt_gap_p50=statistics.median(gaps),
                answers_off=float(sum(g > OFF_VOXELS for g in gaps)))


def reference_check(cell, seed, device, host, sample, runs, extra=()):
    """Each run's numbers (``runs``: name -> (answers by stream position,
    its scales under the reference's names, or None)): ``scale_ulps``
    against the reference's own calibration (``reference/int8.py``'s
    ``calibrate`` on the run's calibration frames), and its sampled answers
    judged against the near-ties (``reference/evaluate.py``) of the int8
    reference at the program's scales, fed the same tensors.  The reference
    takes the program's scales, not its own: its own lie a bfloat16 ulp or
    two from them at a third of the sites, a bit that moves the quantized
    values of the whole tensor, and against it the program's answers drift
    as the bf16 control's do (``limits/hrradarpose_doppler_int8.serve_b8.json``);
    a scale its calibration does not give fails ``scale_ulps`` whatever the
    answers read.  With ``answers``, ``own`` or ``float32`` in ``extra``,
    the readings of those names (the module's doc), not judged."""
    cfg, ref = cell.cfg, cell.reference
    spec = ref_train.Spec(cfg)
    answers = runs["program"][0]
    if any(pos not in answers for pos in sample):
        return {"program": dict.fromkeys(("peak_gap", "kpt_gap", "score_gap", "kpt_gap_p50",
                                          "answers_off", "scale_ulps"), float("inf"))}
    weights = data.make_weights(cfg, seed, device, cell.bench_dir)
    net = ref.load(ref.build(cfg["model"], counts.in_channels(cfg), device), weights)
    calib = calib_frames(cfg, cell.traffic, seed, device)
    own, bounds = ref.calibrate(net, list(calib.split(int(cell.traffic["batch_per_rank"]))))
    del calib
    srcs = sorted({answers[pos][0] for pos in sample})

    def candidates(scales):
        ref.set_scales(net, scales)
        return {src: ref_eval.candidates(net, host["tensor"][src].to(device), spec)
                for src in srcs}

    cands = candidates(runs["program"][1])
    out = {name: dict(_judged(cands, [got[pos] for pos in sample], spec.vsize),
                      scale_ulps=scale_ulps(sc, bounds))
           for name, (got, sc) in runs.items()}
    if "answers" in extra:
        for name, (got, _) in runs.items():
            out[f"answers_{name}"] = sorted(
                j["kpt_gap"] for j in _judge(cands, [got[pos] for pos in sample], spec.vsize))
    if "own" in extra:
        cands = candidates(own)
        out["own"] = _judged(cands, [answers[pos] for pos in sample], spec.vsize)
    if "float32" in extra:
        del net
        f32 = ref_model.load(ref_model.build(cfg["model"], counts.in_channels(cfg), device),
                             weights)
        with NoTF32():
            cands = {src: ref_eval.candidates(f32, host["tensor"][src].to(device), spec)
                     for src in srcs}
        out["float32"] = _judged(cands, [answers[pos] for pos in sample], spec.vsize)
    return out
