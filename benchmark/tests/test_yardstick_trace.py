"""The trace guard and the readers, on synthetic event lists."""

import time
import types

import pytest

from benchmark.harness import readers
from benchmark.harness.cells import BENCH_DIR
from benchmark.harness.kernel_classes import classify
from benchmark.harness.trace import SENTINELS, Trace, TraceLost, guard, union_us


def spins(n, t0):
    return [("spin_kernel", t0 + 2 * i, t0 + 2 * i + 1) for i in range(n)]


def test_guard_refuses_a_trace_that_kept_too_few_sentinels():
    ops = [("k", 500.0, 600.0)]
    for kept in (0, 10, SENTINELS):
        with pytest.raises(TraceLost):
            guard(spins(kept, 0.0) + ops)


def test_guard_finds_the_stretch_between_the_groups():
    ev = spins(SENTINELS, 0.0) + [("k", 300.0, 400.0)] + spins(SENTINELS, 1000.0)
    assert guard(ev) == (2 * SENTINELS - 1, 1000.0)


def test_guard_keeps_a_trace_that_lost_some_leading_sentinels():
    ev = spins(10, 0.0) + [("k", 300.0, 400.0)] + spins(SENTINELS, 1000.0)
    assert guard(ev) == (19.0, 1000.0)


def test_union():
    assert union_us([(0, 10), (5, 15), (20, 30)]) == 25


def _trace(ops, units=2, start=0.0, end=100.0, cfg=None, traffic=None):
    cell = types.SimpleNamespace(cfg=cfg or {}, traffic=traffic or {"batch_per_rank": 8},
                                 bench_dir=BENCH_DIR)
    return Trace(ops=ops, start_us=start, end_us=end, units=units, host_ops=[("aten::x", 0, 100)],
                 extra={"cell": cell})


def test_idle_and_class_sums():
    t = _trace([("elementwise_kernel", 0, 20), ("upsample_trilinear3d_backward_out_frame", 10, 40),
                ("ncclKernel_AllReduce", 60, 70)])
    assert t.busy_s == pytest.approx(50e-6)
    assert readers.idle_pct(t) == pytest.approx(50.0)
    assert t.class_ms_per_unit("resize") == pytest.approx(30e-3 / 2)
    assert t.class_ms_per_unit("nccl") == pytest.approx(10e-3 / 2)
    assert t.class_ms_per_unit("conv_lib") is None
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("upsample") and len(b["idle_gaps"]) >= 1


def test_the_unprofiled_readers(cfg_doppler):
    """Busy time from the stretch, a unit's time from before the profiler."""
    from benchmark.harness import counts
    t = _trace([("k", 0, 20)], units=2, cfg=cfg_doppler)
    assert readers.idle_pct(t, unprofiled=True) is None
    assert readers.mfu_pct(t, "predict", unprofiled=True) is None
    t.extra["unprofiled_s"] = 40e-6
    assert readers.idle_pct(t, unprofiled=True) == pytest.approx(75.0)
    flops = counts.model_flops(cfg_doppler, 8, "predict")
    assert readers.mfu_pct(t, "predict", unprofiled=True) == pytest.approx(
        100.0 * flops / 40e-6 / counts.BF16_PEAK)
    assert readers.mfu_pct(t, "predict") == pytest.approx(100.0 * flops / 50e-6 / counts.BF16_PEAK)


def test_classes():
    assert classify("conv3d_k3_kernel") == "k3"
    assert classify("preprocess_kernel") == "k1"
    assert classify("Memcpy HtoD (Pinned -> Device)") == "h2d"
    assert classify("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32") == "conv_lib"
    assert classify("void at::native::vectorized_elementwise_kernel<4>") == "norm_eltwise"


def test_k3_roofline_reads_nothing_without_its_launches(cfg_doppler):
    t = _trace([("elementwise_kernel", 0, 20)], cfg=cfg_doppler)
    assert readers.k3_roofline_pct(t, 2) is None
    # a launch count other than the frozen shapes' reads nothing either
    t = _trace([("conv3d_k3_kernel", 0, 20)], cfg=cfg_doppler)
    assert readers.k3_roofline_pct(t, 2) is None


def test_k3_roofline_of_a_full_stretch(cfg_doppler):
    ops = [("conv3d_k3_kernel", i * 10, i * 10 + 5) for i in range(2 * 2 * 14)]
    t = _trace(ops, units=2, end=1000.0, cfg=cfg_doppler)
    v = readers.k3_roofline_pct(t, 2)
    assert v is not None and v > 0


@pytest.fixture
def cfg_doppler():
    import json
    import os
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                           "hrradarpose_doppler.json")) as f:
        return json.load(f)


def test_outermost_host_operations():
    from benchmark.harness.trace import outermost
    ev = [("a", 0, 10), ("a.child", 1, 5), ("b", 10, 20), ("b.child", 12, 13), ("c", 25, 30)]
    assert [e[0] for e in outermost(ev)] == ["a", "b", "c"]


class FakeTracer:
    log = []

    def __init__(self, device, host=False):
        self.host = host

    def start(self):
        self.log.append(("start", self.host))

    def stop(self, units):
        self.log.append(("stop", self.host, units))
        return _trace([("k", 10.0, 20.0)], units=units)

    def close(self):
        self.log.append(("close", self.host))


@pytest.mark.parametrize("named", [0, 1, 2])
def test_the_schedule_traces_the_card_then_names_the_gaps(monkeypatch, named):
    """The device stretch (card activity alone) at the stated calls, then
    ``named`` calls traced with the host's operations."""
    from benchmark.harness import trace
    FakeTracer.log = []
    monkeypatch.setattr(trace, "Tracer", FakeTracer)
    s = trace.Schedule(None, {"after": 2, "count": 3, "named": named}, offset=1)
    done_at = None
    for k in range(12):
        s.before_call(k)
        if s.done and done_at is None:
            done_at = k
    want = [("start", False), ("stop", False, 3)]
    if named:
        want += [("start", True), ("stop", True, named)]
    assert FakeTracer.log == want
    assert s.after == 3 and done_at == 6 + named and s.trace.units == 3
    assert s.opened is not None
    assert (s.trace.named is not None) == bool(named)
    s.close()
    assert FakeTracer.log == want


class LosingTracer(FakeTracer):
    def stop(self, units):
        if self.host:
            raise TraceLost("lost")
        return super().stop(units)


def test_a_lost_naming_stretch_leaves_the_metrics(monkeypatch):
    from benchmark.harness import trace
    monkeypatch.setattr(trace, "Tracer", LosingTracer)
    s = trace.Schedule(None, {"after": 0, "count": 1, "named": 1})
    for k in range(3):
        s.before_call(k)
    assert s.done and s.trace is not None and s.trace.named is None
    assert s.trace.breakdown()["idle_gaps"]


def test_the_breakdown_names_idle_gaps_from_the_named_stretch():
    t = _trace([("k", 0, 50)])
    t.named = Trace(ops=[("k", 0, 10)], start_us=0.0, end_us=100.0, units=1,
                    host_ops=[("aten::conv3d", 20, 90)])
    assert t.breakdown()["idle_gaps"][0][0] == "aten::conv3d"


class SlowStart(FakeTracer):
    """A profiler that takes a while to start, as the card's does."""

    def start(self):
        time.sleep(START_S)

    def stop(self, units):
        return Trace(ops=[("k", 0.0, 1000.0)], start_us=0.0, end_us=4000.0, units=units,
                     host_ops=[])


START_S = 2.0


def test_a_traced_eval_run_times_the_frames_before_the_profiler(monkeypatch):
    """The unprofiled time a frame stops where the profiler starts, and the
    eval cell's readers take it from there."""
    pytest.importorskip("rtpose_tpu_torch")
    import torch

    from benchmark import run
    from benchmark.harness import eval_stream, trace
    from benchmark.tests.tiny import tiny
    monkeypatch.setattr(trace, "Tracer", SlowStart)
    cell = tiny("hrradarpose_doppler.eval_b1")
    res = eval_stream.run(cell, 3, 0.5, True, torch.device("cpu"))
    assert res["trace"].units == cell.traffic["trace"]["count"]
    lo = cell.traffic["trace"]["after"]     # the window's calls before the profiler
    assert 0 < res["unprofiled_s"] * lo <= sum(res["call_ms"][:lo]) / 1e3 - 0.9 * START_S
    metrics = run.per_layer(cell, res)
    assert metrics["device_idle.eval"]["value"] == pytest.approx(
        readers.idle_pct(res["trace"], unprofiled=True))
    assert "mfu.eval" in metrics and "step_host_ms.eval" in metrics
