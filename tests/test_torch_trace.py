"""The port's host spans (``rtpose_tpu_torch.utils.trace``): off they cost a
flag check and record nothing; on they record each span with its thread
on the profiler's clock, in a bounded buffer; the eval loop and the
trainer record their layers' spans; ``start_trace`` turns them on as
named ranges."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from rtpose_tpu_torch.core.decode import DecodeSpec
from rtpose_tpu_torch.core.targets import PoseTargetSpec
from rtpose_tpu_torch.data import BatchLoader, DeviceCachedLoader
from rtpose_tpu_torch.engine import (Trainer, create_train_state, make_eval_step,
                                     make_train_step, run_eval)
from rtpose_tpu_torch.engine.hooks import start_trace, stop_trace
from rtpose_tpu_torch.models import build_detector, init_weights
from rtpose_tpu_torch.solver import AdamOneCycle, make_one_cycle_fns
from rtpose_tpu_torch.utils import trace

CPU = torch.device("cpu")
GRID = (8, 8, 16)           # >= 5 per axis: the sparse path takes 5^3 patches
MODEL_CFG = dict(
    type="RadarPoseNet", reader=dict(type="RadarFeatureNet"),
    backbone=dict(type="HRNet3D", backbone_cfg="hr_tiny_feat16_zyx_l4", final_conv_in=176,
                  final_conv_out=64, final_fuse="conat_conv", ds_factor=1),
    pose_head=dict(type="CenterHead", tasks=[dict(num_class=1, class_names=["Pelvis"])],
                   in_channels=64, share_conv_channel=64, common_heads={"reg": (45, 2)},
                   weight=0.5, code_weights=[1.0] * 45))
SPEC_KW = dict(grid_zyx=GRID, pc_range_min_xyz=(0.0, -4.0, -1.0), voxel_size_xyz=(0.5, 1.0, 0.5))
EVAL_SPANS = ["eval.next_batch", "eval.step", "predict.backbone", "predict.hm", "predict.reg",
              "eval.decode", "eval.sync", "eval.post"]


@pytest.fixture(autouse=True)
def spans_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _names(spans):
    """Span names in the order the spans started (an outer one first)."""
    return [s[0] for s in sorted(spans, key=lambda s: (s[2], -s[3]))]


def test_off_returns_the_shared_noop_and_records_nothing():
    s = trace.span("a")
    assert s is trace.NOOP and trace.span("b") is s
    with s:
        pass
    assert trace.take() == [] and trace.dropped() == 0


def _other():
    with trace.span("other"):
        pass


def test_on_records_nested_spans_and_each_threads_id():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            pass
        t = threading.Thread(target=_other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    spans = trace.take()
    assert _names(spans) == ["outer", "inner", "other"]
    by = {s[0]: s for s in spans}
    me = threading.get_ident()
    assert by["outer"][1] == by["inner"][1] == me and by["other"][1] == t.ident != me
    assert by["outer"][2] <= by["inner"][2] <= by["inner"][3] <= by["outer"][3]
    assert trace.take() == []


def test_the_buffer_keeps_the_newest_spans_and_counts_the_dropped():
    trace.enable()
    for i in range(trace.CAPACITY + 5):
        with trace.span(str(i)):
            pass
    assert trace.dropped() == 5
    spans = trace.take()
    assert len(spans) == trace.CAPACITY
    assert spans[0][0] == "5" and spans[-1][0] == str(trace.CAPACITY + 4)
    assert trace.dropped() == 0


def test_spans_are_on_the_profilers_clock():
    """A span and a ``record_function`` around the same block start and end
    within 0.5 ms of each other in the profiler's own timestamps."""
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):      # the first range pays the profiler's set-up
            with trace.span(f"span{i}"), record_function(f"range{i}"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    spans = {s[0]: s for s in trace.take()}
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("range")}
    for i in range(1, 4):
        _, _, t0, t1 = spans[f"span{i}"]
        r = ranges[f"range{i}"]
        assert abs(r.start_ns() - t0) < 500_000 and abs(t1 - r.end_ns()) < 500_000


class _Frames:
    """``n`` batches of one seeded cube each, in the eval loader's layout."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            x = np.random.default_rng(i).normal(size=(1, *GRID, 1)).astype(np.float32)
            yield {"rdr_tensor": x, "meta": [dict(seq="0", frame=str(i), rdr_frame=str(i))],
                   "valid": np.int32(1)}


def _model(seed=0):
    return init_weights(build_detector(MODEL_CFG), torch.Generator().manual_seed(seed))


def test_run_eval_records_the_eval_layers_once_a_batch():
    model = _model().eval()
    spec = DecodeSpec(**SPEC_KW)
    step = make_eval_step(model, spec, sparse=True)
    trace.enable()
    dets, _ = run_eval(step, _Frames(3), spec, device=CPU)
    spans = trace.take()
    assert len(dets) == 3
    assert {s[1] for s in spans} == {threading.get_ident()}
    # the last wait finds the loader's end
    assert _names(spans) == EVAL_SPANS * 3 + ["eval.next_batch"]
    trace.disable()
    run_eval(step, _Frames(2), spec, device=CPU)
    assert trace.take() == []


def test_start_and_stop_trace_turn_the_named_ranges_on_and_off(tmp_path):
    """Under ``start_trace`` a span is a named range of the trace and
    records nothing in the buffer."""
    prof = start_trace(CPU)
    try:
        with trace.span("layer.x"):
            torch.ones(4).sum()
        assert trace.take() == []
    finally:
        path = stop_trace(prof, CPU, str(tmp_path))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "layer.x" in names
    assert trace.span("layer.y") is trace.NOOP and trace.take() == []


class _Samples:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        Z, Y, X = GRID
        poses = (r.uniform(0.2, 0.8, size=(1, 15, 3)) * np.array([X, Y, Z])
                 * np.array([0.5, 1.0, 0.5]) + np.array([0.0, -4.0, -1.0]))
        return {"rdr_tensor": r.normal(size=(Z, Y, X, 1)).astype(np.float32),
                "poses": poses.astype(np.float32), "num_poses": np.int32(1), "meta": {"i": i}}


@pytest.mark.parametrize("fused", [False, True])
def test_trainer_records_its_spans(tmp_path, fused):
    """The per-step loop: the wait for a batch and the step a step, the
    step's forward, backward and optimizer inside it; a fused epoch records
    no wait or step spans."""
    model = _model()
    lr_fn, mom_fn = make_one_cycle_fns(8, 1e-3)
    opt = AdamOneCycle(list(model.parameters()), lr_fn, mom_fn, eps=1e-8, weight_decay=0.0,
                       grad_clip_norm=None)
    step = make_train_step(model, model.pose_head,
                           PoseTargetSpec(**SPEC_KW, max_poses=1, min_radius=2, mode="one_hm",
                                          num_classes=1),
                           opt, lr_fn=lr_fn, sparse_reg=True)
    loader = (DeviceCachedLoader(_Samples(4), batch_size=2, device=CPU) if fused
              else BatchLoader(_Samples(4), batch_size=2))
    trainer = Trainer(step, create_train_state(model, opt), work_dir=str(tmp_path),
                      total_epochs=2, device=CPU, lr_fn=lr_fn, log_interval=2,
                      checkpoint_interval=10, enable_tensorboard=False, fuse_epochs=fused)
    trace.enable()
    trainer.run(loader)
    names = _names(trace.take())
    per_step = ["train.forward", "train.backward", "train.optimizer"]
    if fused:
        # on the CPU a fused epoch loops over the train step, whose phases record
        assert names == per_step * 4
    else:
        # the last wait of an epoch finds the loader's end
        epoch = (["train.next_batch", "train.step"] + per_step) * 2 + ["train.next_batch"]
        assert names == epoch * 2
