"""The rest of the port's training runtime against rtpose_tpu, on the CPU:
the schedule family, the host target assigner, the HTTP logger and profiler
hooks, and the trajectory-gate tool.

Tolerances: schedules, rtol 1e-6 (float32 formulas in two libraries, whose
``pow`` and ``cos`` may differ in the last bits); the host assigner, exact
against the JAX package's (the same numpy operations) and, against the
port's device assigner, exact on indices and masks and 1e-6 on the float
outputs (``exp`` on a dense grid against the splatted window).
"""

import http.server
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rtpose_tpu.core.targets import PoseTargetSpec as JaxSpec
from rtpose_tpu.core.targets import assign_pose_targets_np as jax_assign_np
from rtpose_tpu.solver import schedules as js

from rtpose_tpu_torch.core.targets import (PoseTargetSpec, assign_pose_targets,
                                           assign_pose_targets_np)
from rtpose_tpu_torch.engine import (HTTPLoggerHook, ProfilerHook, Trainer, TrainState)
from rtpose_tpu_torch.solver import schedules as ps
from rtpose_tpu_torch.tools import trajectory_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = [0, 1, 2, 9, 10, 11, 49, 50, 99, 100, 101, 250, 499, 500, 501, 999, 1000, 1001, 5000]

SCHEDULES = {
    "fixed": ("fixed_lr", (3e-3,), {}),
    "step": ("step_lr", (1e-2, [500, 100, 1000]), {"gamma": 0.1}),
    "exp": ("exp_lr", (1e-2, 0.999), {}),
    "poly": ("poly_lr", (1e-2, 1000), {"power": 0.9, "min_lr": 1e-5}),
    "inv": ("inv_lr", (1e-2, 1e-3), {"power": 0.75}),
    "cosine": ("cosine_lr", (1e-2, 1000), {"target_ratio": 0.01}),
    "staircase": ("exponential_decay_staircase", (3e-3, 1000, 0.1, 0.8), {}),
    "manual": ("manual_stepping", (1000, [0.1, 0.5, 0.9], [1e-2, 1e-3, 1e-4, 1e-5]), {}),
    "piecewise": ("piecewise_weight", (0.5, 2.0, 100), {}),
    "piecewise_const": ("piecewise_weight", (0.5,), {}),
}


@pytest.mark.parametrize("warmup", [None, "constant", "linear", "exp"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name, warmup):
    fn_name, args, kw = SCHEDULES[name]
    jfn = js.with_warmup(getattr(js, fn_name)(*args, **kw), warmup, warmup_iters=100,
                         warmup_ratio=0.25)
    pfn = ps.with_warmup(getattr(ps, fn_name)(*args, **kw), warmup, warmup_iters=100,
                         warmup_ratio=0.25)
    for step in STEPS:
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        for s in (step, torch.tensor(step), torch.tensor(step, dtype=torch.int32)):
            got = pfn(s)
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 \
                and got.dim() == 0, (name, step)
            np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=f"{name} @ {step}")


def test_with_warmup_rejects_unknown_mode():
    with pytest.raises(ValueError):
        ps.with_warmup(ps.fixed_lr(1.0), "cubic")


SPEC_KW = dict(grid_zyx=(8, 16, 32), pc_range_min_xyz=(0.0, -4.0, -1.0),
               voxel_size_xyz=(0.25, 0.5, 0.25), out_size_factor_zyx=(1, 1, 1))


def _poses(rng, max_poses):
    """World keypoints mostly inside the grid; one pose per sample far outside."""
    Z, Y, X = SPEC_KW["grid_zyx"]
    lo = np.array(SPEC_KW["pc_range_min_xyz"])
    size = np.array(SPEC_KW["voxel_size_xyz"]) * np.array([X, Y, Z])
    poses = lo + rng.uniform(0.05, 0.95, size=(max_poses, 15, 3)) * size
    poses[-1, 0] = lo - 3.0
    return poses.astype(np.float32)


@pytest.mark.parametrize("mode,max_poses,min_radius", [
    ("one_hm", 1, 2), ("one_hm", 3, 2), ("one_hm", 3, 1), ("per_joint", 1, 2),
    ("per_joint", 2, 0)])
def test_host_assigner_matches_jax_and_the_device_assigner(mode, max_poses, min_radius):
    kw = dict(SPEC_KW, max_poses=max_poses, min_radius=min_radius, mode=mode,
              num_classes=1 if mode == "one_hm" else 15)
    spec, jspec = PoseTargetSpec(**kw), JaxSpec(**kw)
    rng = np.random.default_rng(3)
    for num_poses in range(max_poses + 1):
        poses = _poses(rng, max_poses)
        got = assign_pose_targets_np(poses, num_poses, spec)
        want = jax_assign_np(poses, num_poses, jspec)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        dev = assign_pose_targets(torch.from_numpy(poses)[None], torch.tensor([num_poses]),
                                  spec)
        for k in ("ind", "mask", "cat"):
            np.testing.assert_array_equal(dev[k][0].numpy(), got[k], err_msg=k)
        for k in ("hm", "anno_pose"):
            np.testing.assert_allclose(dev[k][0].numpy(), got[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        assert int(got["mask"].sum()) <= num_poses * (1 if mode == "one_hm" else 15)


class _Collector(http.server.BaseHTTPRequestHandler):
    received = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).received.append((self.headers["Content-Type"], json.loads(body)))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *args):
        pass


class _StubLoader:
    def __init__(self, n):
        self.n = n
        self.epochs = []

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        for i in range(self.n):
            yield {"x": np.full((2,), float(i), np.float32), "meta": [None, None],
                   "valid": np.int32(2)}


def _stub_trainer(tmp_path, total_epochs=1):
    """A Trainer over a step that only counts: the hooks' side is under test."""
    state = TrainState(model=None, optimizer=None, step=torch.zeros((), dtype=torch.int64))

    def step(state, batch):
        state.step += 1
        return state, {"loss": batch["x"].sum(), "skipped": torch.zeros(())}

    return Trainer(step, state, work_dir=str(tmp_path), total_epochs=total_epochs,
                   device=torch.device("cpu"), log_interval=2, checkpoint_interval=100,
                   enable_tensorboard=False, default_hooks=False)


def test_http_logger_hook_posts_the_intervals_metrics(tmp_path):
    _Collector.received = []
    server = http.server.HTTPServer(("localhost", 0), _Collector)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        trainer = _stub_trainer(tmp_path)
        trainer.register_hook(HTTPLoggerHook(f"http://localhost:{server.server_port}/m",
                                             interval=2, session="run-1"))
        trainer.run(_StubLoader(5))
    finally:
        server.shutdown()
        thread.join(timeout=10)
        server.server_close()
    assert not thread.is_alive()
    posts = _Collector.received
    assert [p[1]["step"] for p in posts] == [2, 4, 5]      # intervals, and the epoch's end
    assert all(ct == "application/json" for ct, _ in posts)
    last = posts[-1][1]
    assert sorted(last) == ["epoch", "metrics", "session", "step"]
    assert last["session"] == "run-1" and last["epoch"] == 0
    # the running mean of every step so far: losses 0, 2, 4, 6, 8
    assert last["metrics"] == {"loss": 4.0, "skipped": 0.0}


def test_http_logger_hook_warns_once_and_training_goes_on(tmp_path, monkeypatch):
    with http.server.HTTPServer(("localhost", 0), _Collector) as closed:
        port = closed.server_port          # bound, never served, closed: refuses
    trainer = _stub_trainer(tmp_path)
    warnings = []
    # the logger is the package's shared one: the patch is undone after the test
    monkeypatch.setattr(trainer.logger, "warning", lambda msg: warnings.append(msg))
    trainer.register_hook(HTTPLoggerHook(f"http://localhost:{port}/m", interval=1,
                                         timeout=0.5))
    trainer.run(_StubLoader(3))
    assert int(trainer.state.step) == 3
    assert len(warnings) == 1 and "HTTPLoggerHook" in warnings[0]


def test_profiler_hook_writes_a_trace(tmp_path):
    trainer = _stub_trainer(tmp_path)
    hook = trainer.register_hook(ProfilerHook(num_steps=2, skip_steps=1))
    trainer.run(_StubLoader(5))
    assert hook.trace_path == os.path.join(str(tmp_path), "profile", "trace.json")
    with open(hook.trace_path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::sum" in names                       # the traced steps' operations
    assert hook._done and hook._prof is None


def test_profiler_hook_stops_when_the_run_ends_early(tmp_path):
    trainer = _stub_trainer(tmp_path)
    hook = trainer.register_hook(ProfilerHook(num_steps=50, skip_steps=0))
    trainer.run(_StubLoader(2))
    assert hook._prof is None and os.path.isfile(hook.trace_path)


def test_trajectory_gate_dry_run_prints_the_ports_command():
    r = subprocess.run(
        [sys.executable, "-m", "rtpose_tpu_torch.tools.trajectory_gate", "--dry_run",
         "--device_cache", "--cache_dtype", "float8_e4m3fn", "--epochs", "20",
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    for part in ("-m rtpose_tpu_torch.tools.train", "--stop_epoch 20", "--device_cache",
                 "--cache_dtype float8_e4m3fn", "hr3d_one_hm_doppler_skel480", "--device cpu"):
        assert part in r.stderr, part


def test_trajectory_gate_reads_the_last_epochs_loc_loss(tmp_path):
    recs = [dict(mode="train", epoch=e, loc_loss=v)
            for e, v in ((19, 21.0), (20, 18.0), (20, 16.0))]
    recs.append(dict(mode="val", epoch=20, loc_loss=999.0))    # ignored
    (tmp_path / "x.log.json").write_text("\n".join(json.dumps(r) for r in recs) + "\nnot json\n")
    ep, loc = trajectory_gate.last_epoch_loc(str(tmp_path))
    assert ep == 20 and np.isclose(loc, 17.0)
    assert trajectory_gate.last_epoch_loc(str(tmp_path / "none")) == (None, None)
