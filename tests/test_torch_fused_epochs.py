"""Fused epochs (``make_epoch_step``, ``Trainer(fuse_epochs=True)``) on the
CPU in float32, on a tiny model (hr_tiny_feat16, grid (8, 8, 16)).

On a CPU device a fused epoch is the train step in a plain loop over the
same device-cached gathers, so against the port's per-step loop it runs the
same operations in the same order: the final parameters are held to rtol
1e-6, atol 1e-7 (one intra-op thread: with several, the CPU's parallel
reductions sum in an order that varies from run to run).

Against rtpose_tpu's ``make_epoch_step`` (``lax.scan``), from the same
weights over the same cache rows and index list: rtol 1e-4, atol 1e-5 on the
final parameters, the tolerance ``tests/test_hooks.py`` gives the scan
against the per-step loop, and rtol 1e-4 on each step's loss and gradient
norm.  Both optimizers run with eps = 1e-3: at Adam's default 1e-8 an
element whose gradient is rounding noise moves by a full lr in the direction
of the noise's sign, which differs between the two frameworks, and the
parameters would sit 2 lr apart whatever the step computed.
"""

import json
import logging

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rtpose_tpu.core.targets import PoseTargetSpec as JaxSpec
from rtpose_tpu.engine import TrainState as JaxTrainState
from rtpose_tpu.engine import make_train_step as jax_make_train_step
from rtpose_tpu.engine.steps import make_epoch_step as jax_make_epoch_step
from rtpose_tpu.models import CenterHead as JaxHead
from rtpose_tpu.models import build_detector as jax_build
from rtpose_tpu.solver import adam_one_cycle as jax_adam
from rtpose_tpu.solver import make_one_cycle_fns as jax_one_cycle_fns

from rtpose_tpu_torch.core.targets import PoseTargetSpec
from rtpose_tpu_torch.data import BatchLoader, DeviceCachedLoader, StreamingDeviceLoader
from rtpose_tpu_torch.engine import (Hook, Trainer, create_train_state, make_epoch_step,
                                     make_train_step, state_dict_from_jax)
from rtpose_tpu_torch.models import build_detector
from rtpose_tpu_torch.solver import AdamOneCycle, make_one_cycle_fns

from test_torch_train_step import GRID, MODEL_CFG, SPEC_KW

CPU = torch.device("cpu")
N, BS, EPOCHS = 8, 2, 2
TOTAL_STEPS = 10


class DS:
    """N in-memory samples in the tiny grid's geometry."""

    def __init__(self, n=N):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        Z, Y, X = GRID
        poses = (r.uniform(0.2, 0.8, size=(1, 15, 3)) * np.array([X, Y, Z])
                 * np.array([0.5, 1.0, 0.5]) + np.array([0.0, -4.0, -1.0]))
        return {"rdr_tensor": r.normal(size=(Z, Y, X, 1)).astype(np.float32),
                "poses": poses.astype(np.float32), "num_poses": np.int32(1),
                "meta": {"i": i}}


@pytest.fixture(scope="module")
def weights():
    jmodel = jax_build(MODEL_CFG)
    x = jnp.zeros((BS, *GRID, 1), jnp.float32)
    params = jax.tree.map(np.array, jmodel.init(jax.random.PRNGKey(0), x))
    return dict(jmodel=jmodel, params=params, sd=state_dict_from_jax(params))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(weights, eps=1e-8, remat=False):
    model = build_detector(MODEL_CFG)
    model.load_state_dict(weights["sd"])
    lr_fn, mom_fn = make_one_cycle_fns(TOTAL_STEPS, 1e-3)
    opt = AdamOneCycle(list(model.parameters()), lr_fn, mom_fn, eps=eps, weight_decay=0.0,
                       grad_clip_norm=None)
    step = make_train_step(model, model.pose_head, PoseTargetSpec(**SPEC_KW), opt, lr_fn=lr_fn,
                           sparse_reg=True, remat=remat)
    return model, opt, step, lr_fn


class Recorder(Hook):
    def __init__(self):
        self.events = []

    def before_train_epoch(self, t):
        self.events.append("before_train_epoch")

    def before_train_iter(self, t):
        self.events.append("before_train_iter")

    def after_train_iter(self, t):
        self.events.append("after_train_iter")

    def after_train_epoch(self, t):
        self.events.append("after_train_epoch")


def _run_trainer(weights, work_dir, loader, fused, remat=False):
    model, opt, step, lr_fn = _port(weights, remat=remat)
    trainer = Trainer(step, create_train_state(model, opt), work_dir=str(work_dir),
                      total_epochs=EPOCHS, device=CPU, lr_fn=lr_fn, log_interval=3,
                      checkpoint_interval=10, enable_tensorboard=False, fuse_epochs=fused)
    rec = trainer.register_hook(Recorder())
    trainer.run(loader)
    with open(trainer.json_log) as f:
        logs = [json.loads(line) for line in f]
    return trainer, rec.events, logs


@pytest.mark.parametrize("remat", [False, True])
def test_fused_epochs_match_the_per_step_loop(weights, tmp_path, one_thread, remat):
    def loader():
        return DeviceCachedLoader(DS(), batch_size=BS, device=CPU, shuffle=True, seed=3)

    plain, plain_events, plain_logs = _run_trainer(weights, tmp_path / "plain", loader(),
                                                   False, remat)
    fused, fused_events, fused_logs = _run_trainer(weights, tmp_path / "fused", loader(),
                                                   True, remat)
    steps = EPOCHS * N // BS
    assert plain.epoch_step is None and fused.epoch_step is not None
    assert int(plain.state.step) == int(fused.state.step) == steps
    assert int(fused.state.optimizer.step_count) == steps
    assert fused._host_step == steps and len(fused.iter_seconds) == steps
    for (k, a), b in zip(plain.state.model.state_dict().items(),
                         fused.state.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=k)
    torch.testing.assert_close(fused.state.optimizer.mu, plain.state.optimizer.mu,
                               rtol=1e-6, atol=1e-9)
    # epoch hooks fire, iteration hooks do not; the interval log is the loop's
    assert fused_events == ["before_train_epoch", "after_train_epoch"] * EPOCHS
    assert plain_events.count("after_train_iter") == steps
    assert [(r["epoch"], r["iter"]) for r in fused_logs] == \
        [(r["epoch"], r["iter"]) for r in plain_logs] == [(1, 3), (1, 4), (2, 3), (2, 4)]
    # the fused records are written after the epoch: 'step' is its last step
    assert [r["step"] for r in fused_logs] == [4, 4, 8, 8]
    # every step's metrics are the loop's; so is each full interval's record (the
    # loop's record of an epoch's short last interval averages log_interval
    # steps, the fused one that interval's own, as in the JAX trainer)
    for k in ("loss", "hm_loss", "loc_loss", "grad_norm", "lr", "skipped"):
        assert fused.log_buffer.val_history[k] == \
            pytest.approx(plain.log_buffer.val_history[k], rel=1e-6), k
        assert len(fused.log_buffer.val_history[k]) == steps
        for a, b in zip(plain_logs, fused_logs):
            if a["iter"] == 3:
                assert b[k] == pytest.approx(a[k], rel=1e-6), k


def test_gate_takes_the_loop_for_loaders_that_cannot_fuse(weights, tmp_path):
    """``fuse_epochs`` with a loader that cannot fuse takes the per-step
    loop: the host loader, the streaming loader, and a cached loader whose
    unshuffled epoch does not divide into whole batches."""
    assert BatchLoader.supports_fused_epochs is False
    assert StreamingDeviceLoader.supports_fused_epochs is False
    assert DeviceCachedLoader.supports_fused_epochs is True
    loaders = [
        BatchLoader(DS(4), batch_size=BS, shuffle=True),
        StreamingDeviceLoader(DS(4), batch_size=BS, chunk_bytes=10 ** 9, device=CPU),
        DeviceCachedLoader(DS(5), batch_size=BS, device=CPU, shuffle=False, drop_last=False)]
    for i, loader in enumerate(loaders):
        model, opt, step, lr_fn = _port(weights)
        trainer = Trainer(step, create_train_state(model, opt), work_dir=str(tmp_path / str(i)),
                          total_epochs=1, device=CPU, lr_fn=lr_fn, log_interval=10,
                          checkpoint_interval=10, enable_tensorboard=False, fuse_epochs=True)
        rec = trainer.register_hook(Recorder())
        trainer.run(loader)
        assert trainer.epoch_step is None, type(loader).__name__
        assert int(trainer.state.step) == len(loader)
        assert rec.events.count("after_train_iter") == len(loader)


def test_fused_epochs_name_the_hooks_they_leave_silent(weights, tmp_path):
    """Iteration hooks cannot fire in a fused epoch: the trainer says once
    which registered hooks that silences (the interval logger is not one: the
    fused epoch logs its intervals itself); the per-step loop says nothing."""
    class Keep(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    for fused in (True, False):
        keep = Keep()
        logging.getLogger("rtpose_tpu_torch").addHandler(keep)
        loader = DeviceCachedLoader(DS(), batch_size=BS, device=CPU, shuffle=True, seed=3)
        try:
            trainer, events, _ = _run_trainer(weights, tmp_path / str(fused), loader, fused)
        finally:
            logging.getLogger("rtpose_tpu_torch").removeHandler(keep)
        said = [m for m in keep.messages if "iteration events" in m]
        assert len(said) == (1 if fused else 0)
        if fused:
            assert "Recorder" in said[0] and "LoggerHook" not in said[0]
            assert "after_train_iter" not in events


def test_epoch_step_matches_jax_epoch_step(weights, one_thread):
    eps = 1e-3
    data = {k: np.stack([DS()[i][k] for i in range(N)]).reshape(N, -1)
            for k in ("rdr_tensor", "poses", "num_poses")}
    shapes = {"rdr_tensor": (*GRID, 1), "poses": (1, 15, 3), "num_poses": ()}
    idx = np.random.default_rng(5).permutation(N)

    jmodel = weights["jmodel"]
    jhead = JaxHead(**{k: v for k, v in MODEL_CFG["pose_head"].items() if k != "type"})
    jlr, jmom = jax_one_cycle_fns(TOTAL_STEPS, 1e-3)
    jopt = jax_adam(jlr, jmom, eps=eps, weight_decay=0.0, grad_clip_norm=None)
    jstep = jax_make_train_step(jmodel, jhead, JaxSpec(**SPEC_KW), jopt, lr_fn=jlr,
                                sparse_reg=True)
    jparams = jax.tree.map(jnp.asarray, weights["params"])
    jstate = JaxTrainState(params=jparams, opt_state=jopt.init(jparams),
                           step=jnp.zeros((), jnp.int32))
    jepoch = jax.jit(jax_make_epoch_step(jstep, BS, shapes, {}))
    jstate, jms = jepoch(jstate, {k: jnp.asarray(v) for k, v in data.items()},
                         jnp.asarray(idx.astype(np.int32)))
    want = state_dict_from_jax(jax.device_get(jstate.params))

    model, opt, step, _ = _port(weights, eps=eps)
    epoch_fn = make_epoch_step(step, BS, shapes, {})
    state = create_train_state(model, opt)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    state, ms = epoch_fn(state, tdata, idx)
    assert int(state.step) == int(jstate.step) == N // BS and epoch_fn.replays == 0
    assert sorted(ms) == sorted(jms)
    for k in ("loss", "hm_loss", "loc_loss", "grad_norm", "lr", "num_positive", "skipped"):
        assert ms[k].shape == (N // BS,)
        np.testing.assert_allclose(ms[k].numpy(), np.asarray(jms[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(ms["loc_loss_elem"].numpy(), np.asarray(jms["loc_loss_elem"]),
                               rtol=1e-4, atol=1e-6)
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)

    # a second epoch runs on the same buffers; other tensors or sizes are refused
    state, ms2 = epoch_fn(state, tdata, idx[::-1].copy())
    assert int(state.step) == 2 * (N // BS) and ms2["loss"].shape == (N // BS,)
    with pytest.raises(ValueError, match="first epoch"):
        epoch_fn(state, {k: v.clone() for k, v in tdata.items()}, idx)
    with pytest.raises(ValueError, match="first epoch"):
        epoch_fn(state, tdata, idx[:4])


def test_fused_cli_flags(tmp_path):
    from rtpose_tpu_torch.tools import train as port_train
    with pytest.raises(SystemExit, match="--fuse_epochs needs the whole dataset resident"):
        port_train.main(["unused.py", "--fuse_epochs", "--stream_cache_gb", "1",
                         "--device", "cpu"])
    args = port_train.parse_args(["c.py", "--device_cache", "--cache_dtype", "bfloat16",
                                  "--fuse_epochs", "--profile", "5"])
    assert args.device_cache and args.fuse_epochs and args.profile == 5
    assert args.cache_dtype == "bfloat16" and args.stream_cache_gb is None
    assert port_train.device_cache_cap(CPU) is None
