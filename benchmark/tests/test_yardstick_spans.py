"""The span readers (``harness/spans.py``) on synthetic traces, and spans
handed over by a traced eval run on the CPU."""

import statistics
import time
import types

import pytest

from benchmark.harness import spans as sp
from benchmark.harness.trace import Schedule, Trace

MS = 1_000_000      # ns


def _trace(spans=None, opened=None, ops=(), start_us=0.0, end_us=1e9, units=1, dropped=0):
    extra = {"cell": types.SimpleNamespace(cfg={}, traffic={"batch_per_rank": 1})}
    if spans is not None:
        extra.update(spans=spans, spans_opened_ns=opened, spans_dropped=dropped)
    return Trace(ops=list(ops), start_us=start_us, end_us=end_us, units=units, host_ops=[],
                 extra=extra)


def _batch(k, tid=7, backbone=5, hm=1, reg=2, decode=1, sync=3, post=1, wait=1):
    """Batch k's spans: the wait, the step (10 ms from k * 100 ms) and its
    parts, the sync and the post-processing after it."""
    t = k * 100 * MS
    out = [("eval.next_batch", tid, t - wait * MS, t),
           ("eval.step", tid, t, t + 10 * MS)]
    at = t
    for name, ms in (("predict.backbone", backbone), ("predict.hm", hm), ("predict.reg", reg),
                     ("eval.decode", decode)):
        out.append((name, tid, at, at + ms * MS))
        at += ms * MS
    at = t + 10 * MS
    out.append(("eval.sync", tid, at, at + sync * MS))
    out.append(("eval.post", tid, at + sync * MS, at + (sync + post) * MS))
    return out


def test_the_median_takes_the_batches_before_the_profiler():
    spans = (_batch(0, backbone=4) + _batch(1, backbone=6) + _batch(2, backbone=5)
             + _batch(3, backbone=50) + _batch(4, backbone=60))
    t = _trace(spans, opened=250 * MS)          # batches 0-2 before it
    assert sp.batch_ms(t, sp.PARTS["backbone_host_ms"]) == pytest.approx(5.0)
    # a profiler started inside batch 2's step leaves that batch out
    t2 = _trace(spans, opened=205 * MS)
    assert sp.batch_ms(t2, sp.PARTS["backbone_host_ms"]) == pytest.approx(5.0)
    assert sp.batch_ms(t2, sp.PARTS["sync_wait_ms"]) == pytest.approx(3.0)
    t2.extra["spans"] = _batch(0, backbone=4) + _batch(1, backbone=60)
    t2.extra["spans_opened_ns"] = 105 * MS
    assert sp.batch_ms(t2, sp.PARTS["backbone_host_ms"]) == pytest.approx(4.0)
    assert sp.batch_ms(t, sp.PARTS["sync_wait_ms"]) == pytest.approx(3.0)
    assert sp.batch_ms(t, sp.PARTS["post_host_ms"]) == pytest.approx(1.0)
    # batch 3's wait ends as batch 3's step starts, after the profiler opened
    assert sp.batch_ms(t, sp.PARTS["batch_wait_ms"]) == pytest.approx(1.0)


def test_the_head_sums_its_parts_in_each_batch():
    spans = (_batch(0, hm=1, reg=1, decode=1) + _batch(1, hm=2, reg=2, decode=2)
             + _batch(2, hm=1, reg=3, decode=4))
    t = _trace(spans, opened=10_000 * MS)
    assert sp.batch_ms(t, sp.PARTS["head_host_ms"]) == pytest.approx(6.0)


def test_another_threads_spans_are_left_out():
    spans = _batch(0) + _batch(1) + [("eval.sync", 8, 150 * MS, 190 * MS)]
    t = _trace(spans, opened=10_000 * MS)
    assert sp.batch_ms(t, sp.PARTS["sync_wait_ms"]) == pytest.approx(3.0)


def test_idle_inside_the_steps():
    """Steps at [0, 10) and [100, 110) ms; the card busy [2, 4) and
    [100, 150) ms in a stretch [1, 200) ms over 2 units: idle inside the
    steps is [1, 2) and [4, 10) ms, 7 ms, 3.5 a unit."""
    spans = _batch(0) + _batch(1)
    ops = [("k", 2_000.0, 4_000.0), ("k", 100_000.0, 150_000.0)]
    t = _trace(spans, opened=0, ops=ops, start_us=1_000.0, end_us=200_000.0, units=2)
    assert sp.idle_in_step_ms(t) == pytest.approx(3.5)
    # gaps wholly outside the steps read 0
    t = _trace(spans, opened=0, ops=[("k", 0.0, 10_000.0), ("k", 100_000.0, 110_000.0)],
               start_us=0.0, end_us=200_000.0, units=2)
    assert sp.idle_in_step_ms(t) == 0.0


def test_no_spans_read_nothing():
    for t in (_trace(), _trace([], opened=0), _trace([("eval.post", 1, 0, 5)], opened=10)):
        for parts in sp.PARTS.values():
            assert sp.batch_ms(t, parts) is None
        assert sp.idle_in_step_ms(t) is None
    # steps that miss the stretch read nothing
    t = _trace(_batch(0), opened=0, start_us=1e9, end_us=2e9)
    assert sp.idle_in_step_ms(t) is None


def test_a_buffer_that_dropped_spans_reads_nothing():
    spans = _batch(0) + _batch(1)
    ops = [("k", 2_000.0, 4_000.0)]
    whole = _trace(spans, opened=10_000 * MS, ops=ops, start_us=1_000.0, end_us=200_000.0)
    assert sp.batch_ms(whole, sp.PARTS["backbone_host_ms"]) is not None
    assert sp.idle_in_step_ms(whole) is not None
    cut = _trace(spans, opened=10_000 * MS, ops=ops, start_us=1_000.0, end_us=200_000.0,
                 dropped=1)
    for parts in sp.PARTS.values():
        assert sp.batch_ms(cut, parts) is None
    assert sp.idle_in_step_ms(cut) is None


class ClockTracer:
    """A tracer that traces nothing: the whole stretch idle, on the
    profiler's clock."""

    def __init__(self, device, host=False):
        pass

    def start(self):
        self.t0 = time.time_ns() / 1e3

    def stop(self, units):
        return Trace(ops=[], start_us=self.t0, end_us=time.time_ns() / 1e3, units=units,
                     host_ops=[])

    def close(self):
        pass


class SpanSchedule(Schedule):
    """The schedule with the program's spans on from the window's start to
    its close, handing them to the trace as a traced eval run would."""

    def __init__(self, device, tcfg, offset=0):
        from rtpose_tpu_torch.utils import trace as program_spans
        super().__init__(device, tcfg, offset)
        self.spans, self.opened_ns = program_spans, None
        program_spans.enable()

    def before_call(self, k):
        if k == self.after:
            self.opened_ns = time.time_ns()
        super().before_call(k)

    def close(self):
        super().close()
        self.spans.disable()
        dropped = self.spans.dropped()
        recorded = self.spans.take()
        if self.trace is not None:
            self.trace.extra.update(spans=recorded, spans_dropped=dropped,
                                    spans_opened_ns=self.opened_ns)


def test_a_traced_eval_run_hands_its_spans_to_the_readers(monkeypatch):
    pytest.importorskip("rtpose_tpu_torch")
    import torch

    from benchmark.harness import eval_stream, trace
    from benchmark.tests.tiny import tiny
    from rtpose_tpu_torch.utils import trace as program_spans
    monkeypatch.setattr(trace, "Tracer", ClockTracer)
    monkeypatch.setattr(eval_stream, "Schedule", SpanSchedule)
    cell = tiny("hrradarpose_doppler.eval_b1")
    cell.traffic["trace"]["after"] = 2
    try:
        res = eval_stream.run(cell, 3, 0.5, True, torch.device("cpu"))
    finally:
        program_spans.disable()
        program_spans.take()
    tr = res["trace"]
    assert tr.extra["spans_dropped"] == 0
    readings = {name: sp.batch_ms(tr, parts) for name, parts in sp.PARTS.items()}
    assert all(v is not None and v > 0 for v in readings.values()), readings
    # the two batches before the profiler: the step's parts fit in the step
    assert (readings["backbone_host_ms"] + readings["head_host_ms"]
            <= statistics.mean(res["host_ms"][:2]))
    assert sp.idle_in_step_ms(tr) > 0

    # an untraced run keeps the program's spans off
    monkeypatch.undo()
    eval_stream.run(cell, 3, 0.3, False, torch.device("cpu"))
    assert program_spans.take() == []
