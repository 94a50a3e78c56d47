"""The loop of an eval cell: a closed loop of batches (B=1: one sensor
stream) through the program's ``engine.evaluator.run_eval``.

The loader yields the seeded frames from pinned host memory, cycling,
in the layout the program's ``BatchLoader`` yields with
``--device_preprocess`` (a (B, D, Z, Y, X) raw cube, 'meta', 'valid');
``run_eval`` copies each to the card on its prefetch thread and runs
``make_eval_step(..., sparse=True, preprocess=...)`` on it (the preprocess
kernel, ``predict_sparse``, ``decode_pose_sparse``), then copies the answer
back, waits for the stream and post-processes it on the host.

Set-up runs ``run_eval`` once over ``warm_frames`` frames (every shape
built and warmed).  The window is a second ``run_eval`` call: its loader
stops yielding once ``--seconds`` have passed, and the window closes when
``run_eval`` returns.  A frame's time runs from the eval step's call on
its batch to the call on the next batch (to the return of ``run_eval``
for the last one), so it holds the forward, the decode, the copy back,
the stream wait, the post-processing and the wait for the next batch.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import check, counts, data
from benchmark.harness.trace import Schedule
from benchmark.reference import evaluate as ref_eval
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train


class Stream:
    """Batches of ``batch`` frames from pinned host memory, ``count`` of
    them or until ``seconds`` have passed since the first (and ``hold()``
    is false: a traced stretch not finished keeps the stream going).  Each
    frame gets its own key (``frame`` its position in the stream,
    ``rdr_frame`` the frame it shows); the frames cycle in order, so a
    batch is a contiguous block (their count is a multiple of ``batch``)."""

    def __init__(self, host: Dict[str, torch.Tensor], batch: int, count: Optional[int] = None,
                 seconds: Optional[float] = None, hold=lambda: False):
        self.host, self.batch, self.count = host, batch, count
        self.seconds, self.hold = seconds, hold

    def __len__(self):
        return self.count if self.count is not None else 1_000_000

    def __iter__(self):
        n, B = self.host["raw"].shape[0], self.batch
        t0 = time.perf_counter()
        for i in range(len(self)):
            if (self.seconds is not None and time.perf_counter() - t0 >= self.seconds
                    and not self.hold()):
                return
            src = (i * B) % n
            yield {"rdr_raw": self.host["raw"][src:src + B].numpy(),
                   "meta": [dict(seq="0", frame=str(i * B + j), rdr_frame=str(src + j))
                            for j in range(B)],
                   "valid": np.int32(B)}


class Timed:
    """The eval step as ``run_eval`` calls it: the time of each call and
    of each return, and the traced stretches started and stopped at stated
    calls."""

    def __init__(self, step, schedule: Optional[Schedule] = None):
        self.step, self.schedule = step, schedule
        self.calls: List[float] = []
        self.host_ms: List[float] = []

    def __call__(self, batch):
        if self.schedule is not None:
            self.schedule.before_call(len(self.calls))
        t = time.perf_counter()
        self.calls.append(t)
        out = self.step(batch)
        self.host_ms.append((time.perf_counter() - t) * 1e3)
        return out


def _answers(dets: Dict[str, dict]):
    """Stream position -> (shown frame, keypoints (15, 3), score)."""
    out = {}
    for key, d in dets.items():
        _, frame, src = key.split("/")
        kp = np.asarray([p[1:4] for p in d["keypoints"]], np.float32)
        out[int(frame)] = (int(src), kp, float(d["keypoints"][0][4]))
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, ranks=None,
        extra: tuple = ()) -> Dict:
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.engine import make_eval_step, run_eval

    cfg, tr = cell.cfg, cell.traffic
    B = int(tr["batch_per_rank"])
    weights = data.make_weights(cfg, seed, device)
    frames_dev = data.make_frames(cfg, tr, seed, device)
    host = data.to_host(frames_dev)
    del frames_dev
    asm = assemble(Config(cell.cfg))
    model = asm.model.to(device)
    model.load_state_dict(weights)
    del weights
    model.eval()
    nv = cfg["DATASET"]["DZYX"]["NORMALIZING_VALUE"]
    preprocess = (float(nv[0]), float(nv[1]) - float(nv[0]))
    step = make_eval_step(model, asm.decode_spec, input_key=asm.input_key,
                          sparse=asm.sparse_head, preprocess=preprocess,
                          multi_poses=asm.multi_poses)

    def evaluate(stream, fn):
        dets, _ = run_eval(fn, stream, asm.decode_spec, device=device, one_hm=asm.one_hm)
        return dets

    evaluate(Stream(host, B, count=max(1, int(tr["warm_frames"]) // B)), Timed(step))
    sched = Schedule(device, tr["trace"]) if trace else None
    timed = Timed(step, sched)
    stream = Stream(host, B, seconds=seconds, hold=lambda: trace and not sched.done)
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
        print(f"eval_stream: {sched.trace.window_s / sched.count * 1e3:.4f} ms a call in the "
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
                                                   preprocess, control)
    return out


def int8_answers(model, step, host, sample, answers, device, B):
    """The control: the program's own int8 path (post-training scales from
    four of the frames, ``ops.quant.int8_mode``) on the sampled frames, each
    in the batch the stream put it in."""
    from rtpose_tpu_torch.engine.convert import bind_sites
    from rtpose_tpu_torch.ops import quant
    bind_sites(model)
    frames = [{"rdr_raw": host["raw"][i:i + 1].to(device)} for i in range(4)]
    scales = quant.calibration_scales(step, frames)
    out = {}
    with quant.int8_mode(scales, exclude=quant.DEFAULT_EXCLUDE):
        for pos in sample:
            src = answers[pos][0]
            first = src - pos % B
            kpts, scores, _ = step({"rdr_raw": host["raw"][first:first + B].to(device)})[0]
            j = src - first
            out[pos] = (src, kpts[j].float().cpu().numpy(), float(scores[j, 0]))
    return out


def reference_check(cell, seed, device, host, sample, answers, preprocess, control=None):
    cfg = cell.cfg
    spec = ref_train.Spec(cfg)
    net = ref_model.load(ref_model.build(cfg["model"], counts.in_channels(cfg), device),
                         data.make_weights(cfg, seed, device))
    cand = {}
    judged, judged_ctl = [], []
    for pos in sample:
        if pos not in answers:
            return {"peak_gap": float("inf"), "kpt_gap": float("inf"),
                    "score_gap": float("inf")}, {}
        src, kp, score = answers[pos]
        if src not in cand:
            cube = ref_eval.preprocess(host["raw"][src].to(device), *preprocess)
            cand[src] = ref_eval.candidates(net, cube, spec)
        judged.append(ref_eval.judge(cand[src], torch.from_numpy(kp), score, spec.vsize))
        if control is not None:
            c_src, c_kp, c_score = control[pos]
            judged_ctl.append(ref_eval.judge(cand[c_src], torch.from_numpy(c_kp), c_score,
                                              spec.vsize))
    extra = {"control": check.eval_numbers(judged_ctl)} if control is not None else {}
    return check.eval_numbers(judged), extra
