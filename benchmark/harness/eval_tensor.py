"""The loop of an eval cell whose frames the host prepares: a closed loop of
batches (B=1: one sensor stream) of float32 cubes through the program's
``engine.evaluator.run_eval``.

A complex cube (``dzyx_complex``: the real and imaginary parts of each
Doppler bin as channels) is only cropped: it is neither normalized nor
clamped, on the host or on the card.  The loader yields the seeded frames
(``data.make_frames``'s ``tensor``) from pinned host memory, cycling, in the
layout the program's ``BatchLoader`` yields for such a configuration (a
(B, Z, Y, X, C) float32 'rdr_tensor', 'meta', 'valid'); ``run_eval`` copies
each to the card on its prefetch thread and runs ``make_eval_step(...,
preprocess=None)`` on it (``predict_sparse``, ``decode_pose_sparse``, the
step replayed from its ``EvalGraphs`` graph), then copies the answer back,
waits for the stream and post-processes it on the host.

Set-up, the window, the frame's time, the traced stretch and the result's
keys are ``eval_stream``'s.  The reference check feeds the same tensor,
with no preprocessing, to the plain float32 reference, with TF32 off for
its convs (``reference.dcn.NoTF32``).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import check, counts, data
from benchmark.harness.eval_stream import Stream, Timed, _answers
from benchmark.harness.trace import Schedule
from benchmark.reference import evaluate as ref_eval
from benchmark.reference import train as ref_train
from benchmark.reference.dcn import NoTF32


class TensorStream(Stream):
    """``eval_stream.Stream`` over the host's float32 'tensor' frames, as
    'rdr_tensor' batches."""

    def __iter__(self):
        n, B = self.host["tensor"].shape[0], self.batch
        t0 = time.perf_counter()
        for i in range(len(self)):
            if (self.seconds is not None and time.perf_counter() - t0 >= self.seconds
                    and not self.hold()):
                return
            src = (i * B) % n
            yield {"rdr_tensor": self.host["tensor"][src:src + B].numpy(),
                   "meta": [dict(seq="0", frame=str(i * B + j), rdr_frame=str(src + j))
                            for j in range(B)],
                   "valid": np.int32(B)}


def run(cell, seed: int, seconds: float, trace: bool, device, ranks=None,
        extra: tuple = ()) -> Dict:
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.engine import make_eval_step, run_eval

    cfg, tr = cell.cfg, cell.traffic
    B = int(tr["batch_per_rank"])
    weights = data.make_weights(cfg, seed, device, cell.bench_dir)
    frames_dev = data.make_frames(cfg, tr, seed, device)
    host = data.to_host(frames_dev)
    del frames_dev
    asm = assemble(Config(cell.cfg))
    model = asm.model.to(device)
    model.load_state_dict(weights)
    del weights
    model.eval()
    step = make_eval_step(model, asm.decode_spec, input_key=asm.input_key,
                          sparse=asm.sparse_head, preprocess=None,
                          multi_poses=asm.multi_poses)

    def evaluate(stream, fn):
        dets, _ = run_eval(fn, stream, asm.decode_spec, device=device, one_hm=asm.one_hm)
        return dets

    evaluate(TensorStream(host, B, count=max(1, int(tr["warm_frames"]) // B)), Timed(step))
    sched = Schedule(device, tr["trace"]) if trace else None
    timed = Timed(step, sched)
    stream = TensorStream(host, B, seconds=seconds, hold=lambda: trace and not sched.done)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        dets = evaluate(stream, timed)
    finally:
        if sched is not None:
            sched.close()
    t1 = time.perf_counter()
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
        # the calls before the profiler first started: profiling slows the
        # host, and leaves it slower for the rest of the process
        out["host_ms_untraced"] = timed.host_ms[:sched.after]
        out["unprofiled_s"] = (sched.opened - timed.calls[0]) / sched.after
        out["trace"] = sched.trace
        print(f"eval_tensor: {sched.trace.window_s / sched.count * 1e3:.4f} ms a call in the "
              f"traced stretch, {out['unprofiled_s'] * 1e3:.4f} before the profiler started",
              file=sys.stderr)
    answers = _answers(dets)
    out["failed"] = n - sum(1 for a in answers.values() if np.isfinite(a[1]).all())
    # the k-th batch drawn gives its slot k % B, so every slot is judged
    rng = np.random.default_rng(int(seed) & ((1 << 63) - 1))
    picks = rng.choice(calls, size=min(int(tr["check_frames"]), calls), replace=False)
    sample = sorted(int(b) * B + k % B for k, b in enumerate(picks))
    control = None
    if "control" in extra:
        control = int8_answers(model, step, host, sample, answers, device, B)
    del step, model, asm, timed, dets
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["numbers"], out["extra"] = reference_check(cell, seed, device, host, sample, answers,
                                                   control)
    return out


def int8_answers(model, step, host, sample, answers, device, B):
    """The control: the program's own int8 path (post-training scales from
    four of the frames, ``ops.quant.int8_mode``) on the sampled frames, each
    in the batch the stream put it in."""
    from rtpose_tpu_torch.engine.convert import bind_sites
    from rtpose_tpu_torch.ops import quant
    bind_sites(model)
    frames = [{"rdr_tensor": host["tensor"][i:i + 1].to(device)} for i in range(4)]
    scales = quant.calibration_scales(step, frames)
    out = {}
    with quant.int8_mode(scales, exclude=quant.DEFAULT_EXCLUDE):
        for pos in sample:
            src = answers[pos][0]
            first = src - pos % B
            kpts, scores, _ = step({"rdr_tensor": host["tensor"][first:first + B].to(device)})[0]
            j = src - first
            out[pos] = (src, kpts[j].float().cpu().numpy(), float(scores[j, 0]))
    return out


def reference_check(cell, seed, device, host, sample, answers, control=None):
    """The sampled answers judged against the float32 reference's decode of
    the same tensors (``reference/evaluate.py``), TF32 off in its convs."""
    cfg, ref = cell.cfg, cell.reference
    spec = ref_train.Spec(cfg)
    net = ref.load(ref.build(cfg["model"], counts.in_channels(cfg), device),
                   data.make_weights(cfg, seed, device, cell.bench_dir))
    cand = {}
    judged, judged_ctl = [], []
    for pos in sample:
        if pos not in answers:
            return {"peak_gap": float("inf"), "kpt_gap": float("inf"),
                    "score_gap": float("inf")}, {}
        src, kp, score = answers[pos]
        if src not in cand:
            with NoTF32():
                cand[src] = ref_eval.candidates(net, host["tensor"][src].to(device), spec)
        judged.append(ref_eval.judge(cand[src], torch.from_numpy(kp), score, spec.vsize))
        if control is not None:
            c_src, c_kp, c_score = control[pos]
            judged_ctl.append(ref_eval.judge(cand[c_src], torch.from_numpy(c_kp), c_score,
                                              spec.vsize))
    extra = {"control": check.eval_numbers(judged_ctl)} if control is not None else {}
    return check.eval_numbers(judged), extra
