"""The program's host spans read against a traced eval run.

The port records host spans at its layer boundaries when they are turned on
(``rtpose_tpu_torch.utils.trace``): (name, thread id, start ns, end ns), on
the clock ``torch.profiler`` stamps its events with (Unix-epoch ns).  The
eval loop's thread records, once a batch: ``eval.next_batch`` (the wait for
the prefetch thread), ``eval.step`` (the eval step's call) holding
``predict.backbone``, ``predict.hm``, ``predict.reg`` and ``eval.decode``,
then ``eval.sync`` (the copies back and the stream wait) and ``eval.post``
(post-processing).

What is read here is a ``Trace`` whose ``extra`` holds ``spans``, the spans
recorded over the window, ``spans_dropped``, how many the program's buffer
dropped (the oldest) before they were taken, and ``spans_opened_ns``, when
the profiler was first started, on the spans' clock.  A span belongs to batch k when it
starts inside the k-th ``eval.step`` or after it and before the next one;
an ``eval.next_batch`` belongs to the step that follows it.  ``batch_ms``
takes the batches whose step ended before the profiler was started
(profiling slows the host, and the step that starts it holds its start-up);
``idle_in_step_ms`` lays the steps over the traced stretch, which the
profiler recorded with the card's activity alone.  Both return None where
there are no spans to read, or where the buffer dropped any: the batches
left would not be the window's.
"""

from __future__ import annotations

import bisect
import statistics
from typing import List, Optional, Sequence, Tuple

STEP, WAIT = "eval.step", "eval.next_batch"

# what each per-batch reading sums
PARTS = {"backbone_host_ms": ("predict.backbone",),
         "head_host_ms": ("predict.hm", "predict.reg", "eval.decode"),
         "sync_wait_ms": ("eval.sync",),
         "post_host_ms": ("eval.post",),
         "batch_wait_ms": (WAIT,)}


def _spans(trace) -> Optional[list]:
    """The window's spans, or None where there are none or some were
    dropped."""
    spans = trace.extra.get("spans")
    if not spans or trace.extra.get("spans_dropped", 0):
        return None
    return spans


def _loop(spans) -> Tuple[list, list]:
    """The eval loop thread's spans (the thread of the first ``eval.step``)
    and its steps, by start."""
    steps = sorted((s for s in spans if s[0] == STEP), key=lambda s: s[2])
    if not steps:
        return [], []
    tid = steps[0][1]
    return [s for s in spans if s[1] == tid], [s for s in steps if s[1] == tid]


def batch_ms(trace, names: Sequence[str]) -> Optional[float]:
    """Median over the batches whose step ended before the profiler was
    started of the host ms of the spans ``names`` summed in each batch
    (batches with none of them left out)."""
    spans, opened = _spans(trace), trace.extra.get("spans_opened_ns")
    if spans is None or opened is None:
        return None
    loop, steps = _loop(spans)
    starts = [s[2] for s in steps]
    before = bisect.bisect_right([s[3] for s in steps], opened)
    per: dict = {}
    for name, _, t0, t1 in loop:
        if name not in names:
            continue
        k = (bisect.bisect_left(starts, t1) if name == WAIT
             else bisect.bisect_right(starts, t0) - 1)
        if 0 <= k < before:
            per[k] = per.get(k, 0.0) + (t1 - t0) / 1e6
    return statistics.median(per.values()) if per else None


def idle_gaps_us(trace) -> List[Tuple[float, float]]:
    """The traced stretch's intervals (us) in which the card ran nothing."""
    busy = sorted((max(s, trace.start_us), min(e, trace.end_us)) for _, s, e in trace.ops
                  if e > trace.start_us and s < trace.end_us)
    gaps, at = [], trace.start_us
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if trace.end_us > at:
        gaps.append((at, trace.end_us))
    return gaps


def idle_in_step_ms(trace) -> Optional[float]:
    """Device-idle ms a unit of the traced stretch that falls inside an
    ``eval.step`` of the eval loop: the card waiting on the step's dispatch
    (a profiled host's, as the stretch is traced)."""
    spans = _spans(trace)
    if spans is None:
        return None
    _, steps = _loop(spans)
    steps = [(t0 / 1e3, t1 / 1e3) for _, _, t0, t1 in steps
             if t1 / 1e3 > trace.start_us and t0 / 1e3 < trace.end_us]
    if not steps:
        return None
    gaps = idle_gaps_us(trace)
    total, i, j = 0.0, 0, 0
    while i < len(gaps) and j < len(steps):
        lo, hi = max(gaps[i][0], steps[j][0]), min(gaps[i][1], steps[j][1])
        if hi > lo:
            total += hi - lo
        if gaps[i][1] < steps[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e3 / trace.units
