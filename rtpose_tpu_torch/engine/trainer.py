"""Training loop.

Counterpart of ``rtpose_tpu/engine/trainer.py`` (reference
``det3d/torchie/trainer/trainer.py:143-609``): the Python loop feeds
batches to the train step, keeps its metrics on the device, and fires
prioritized hooks (``engine/hooks.py``) — text / JSON / TensorBoard logging
every ``log_interval`` iterations, checkpoints every
``checkpoint_interval`` epochs, the loader's epoch reseed, per-phase
timings.  Metric reads wait for the device, so the loop keeps the last
interval's metric dicts unread and copies them to the host in ONE transfer
at logging time.  A SIGTERM sets a flag; the loop then checkpoints at the
next step boundary and raises ``Preempted`` (caught in ``run``).

``fuse_epochs``: over a loader that keeps the whole dataset on the device
(``supports_fused_epochs``) an epoch is one call of
``steps.make_epoch_step`` — on the card, replays of one captured CUDA graph
of the train step — with one metric read per epoch; iteration hooks do not
fire, epoch hooks and interval logging do.

Under a process group (data parallelism, ``parallel``) every rank runs this
loop on its shard of each global batch and holds the same state: rank 0
broadcasts it after a resume, and only rank 0 writes the JSON log,
TensorBoard scalars and checkpoints (the other ranks wait at a barrier
after each save, so a resume finds the file).  The preemption handler is
each rank's own, as in the JAX package: a scheduler signals every rank of
the job, and each checkpoints at its next step boundary; a signal that
reached one rank only would leave the others waiting in that step's
collectives.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import parallel
from .checkpoint import load_training_checkpoint, save_training_checkpoint
from .evaluator import device_prefetch
from .hooks import CheckpointHook, Hook, LoggerHook, SamplerSeedHook
from .log_buffer import LogBuffer
from .steps import TrainState, make_epoch_step


def get_root_logger(log_level="INFO", work_dir: Optional[str] = None):
    logger = logging.getLogger("rtpose_tpu_torch")
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.propagate = False    # its own handlers only, whatever the root has
    logger.setLevel(log_level)
    if work_dir:
        os.makedirs(work_dir, exist_ok=True)
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)     # one log file: this run's
            h.close()
        fh = logging.FileHandler(os.path.join(
            work_dir, f"exp_{time.strftime('%Y%m%d_%H%M%S')}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class TensorboardWriter:
    """Optional TensorBoard scalars (TensorboardLoggerHook parity); a no-op
    where the ``tensorboard`` package is not installed."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.writer = None
        else:
            self.writer = SummaryWriter(log_dir)

    def add_scalars(self, scalars: Dict[str, float], step: int):
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(k, v, step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


class Preempted(Exception):
    """Raised inside the train loop after a preemption checkpoint is saved."""


class Trainer:
    def __init__(self, train_step: Callable, state: TrainState, *, work_dir: str,
                 total_epochs: int, device: torch.device,
                 lr_fn: Optional[Callable] = None, log_interval: int = 20,
                 checkpoint_interval: int = 5, meta: Optional[dict] = None,
                 enable_tensorboard: bool = True, logger=None,
                 default_hooks: bool = True, fuse_epochs: bool = False,
                 stop_epoch: Optional[int] = None):
        self.work_dir = os.path.abspath(work_dir)
        os.makedirs(self.work_dir, exist_ok=True)
        self.logger = logger or get_root_logger(work_dir=self.work_dir)
        self.device = device
        self.train_step = train_step
        self.state = state
        self.fuse_epochs = fuse_epochs
        self._epoch_step = None     # make_epoch_step's, once a fused epoch has run
        # host-side mirror of state.step: logging must not wait on the device
        self._host_step = int(state.step)
        self.total_epochs = total_epochs
        # early exit that keeps total_epochs sizing the lr schedule
        self.stop_epoch = stop_epoch
        self.lr_fn = lr_fn
        self.log_interval = log_interval
        self.checkpoint_interval = checkpoint_interval
        self.meta = meta or {}
        self.epoch = 0
        self.inner_iter = 0
        self.loader = None
        self.timings: Dict[str, float] = {}
        # wall seconds of each iteration of this run (host clock); a fused
        # epoch gives each of its steps the epoch's time over its steps
        self.iter_seconds: List[float] = []
        self.log_buffer = LogBuffer()
        # logs and checkpoints are rank 0's (the only rank without a group)
        self.is_writer = parallel.process_index() == 0
        self.tb = (TensorboardWriter(os.path.join(self.work_dir, "tf_logs"))
                   if enable_tensorboard and self.is_writer else None)
        self.json_log = os.path.join(self.work_dir,
                                     f"{time.strftime('%Y%m%d_%H%M%S')}.log.json")
        self._pending: List[Dict[str, torch.Tensor]] = []
        self._epoch_t0 = 0.0
        self._hooks: List[Hook] = []
        self._preempted = False
        if default_hooks:
            self.register_hook(SamplerSeedHook())
            self.register_hook(LoggerHook(log_interval))
            self.register_hook(CheckpointHook(checkpoint_interval))

    def register_hook(self, hook: Hook, priority: Optional[int] = None):
        """Insert in ascending priority (lower first); equal priorities keep
        registration order."""
        if priority is not None:
            hook.priority = priority
        idx = len(self._hooks)
        for i, h in enumerate(self._hooks):
            if h.priority > hook.priority:
                idx = i
                break
        self._hooks.insert(idx, hook)
        return hook

    def call_hook(self, event: str):
        for h in self._hooks:
            getattr(h, event)(self)

    def resume(self, path: str):
        """Restore parameters, optimizer moments and both step counts (every
        rank loads; rank 0's state is then broadcast)."""
        ckpt = load_training_checkpoint(path)
        self.state.model.load_state_dict(ckpt["state_dict"])
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        parallel.broadcast_state(self.state.model, self.state.optimizer)
        meta = ckpt["meta"]
        self._host_step = int(meta["step"])
        self.state.step.fill_(self._host_step)
        self.epoch = int(meta.get("epoch", 0))
        self.logger.info(f"resumed from {path}: epoch {self.epoch}, step {self._host_step}")

    def run(self, train_loader, val_loader=None, workflow=(("train", 1),),
            eval_fn: Optional[Callable] = None):
        """workflow: [('train', k), ('val', 1), ...] — reference semantics."""
        self.logger.info(f"start training: {self.total_epochs} epochs x "
                         f"{len(train_loader)} steps on {self.device}, "
                         f"{parallel.process_count()} process(es)")
        prev_handler = self._install_preempt_handler()
        self.call_hook("before_run")
        stop_at = (self.total_epochs if self.stop_epoch is None
                   else min(self.stop_epoch, self.total_epochs))
        try:
            while self.epoch < stop_at:
                for mode, times in workflow:
                    for _ in range(times):
                        if mode == "train":
                            if self.epoch >= stop_at:
                                break
                            self.train_epoch(train_loader)
                        elif mode == "val" and val_loader is not None and eval_fn:
                            eval_fn(self.state, val_loader, self.epoch)
                            self.call_hook("after_val_epoch")
        except Preempted:
            self.logger.warning(
                f"preempted: checkpoint saved at epoch {self.epoch}, step "
                f"{self._host_step} — resume with --resume_from "
                f"{os.path.join(self.work_dir, 'checkpoints')}")
        finally:
            self._restore_preempt_handler(prev_handler)
        self.call_hook("after_run")
        if self.tb:
            self.tb.close()
        return self.state

    # SIGTERM -> checkpoint at the next step boundary -> clean exit.  Resume
    # restarts the interrupted epoch from its start with the saved state.

    def _install_preempt_handler(self):
        if threading.current_thread() is not threading.main_thread():
            return None

        def _on_term(signum, frame):
            self._preempted = True
            self.logger.warning("SIGTERM: will checkpoint and exit at the next step boundary")

        return signal.signal(signal.SIGTERM, _on_term)

    @staticmethod
    def _restore_preempt_handler(prev):
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)

    def _check_preempt(self):
        if not self._preempted:
            return
        self.flush_metrics()
        self.save_checkpoint()
        raise Preempted()

    @property
    def epoch_step(self):
        """``make_epoch_step``'s callable once a fused epoch has run, else
        None (every epoch so far took the per-step loop)."""
        return self._epoch_step

    def train_epoch(self, loader):
        if self.fuse_epochs and getattr(loader, "supports_fused_epochs", False):
            # supports_fused_epochs is the loaders' capability flag (the whole
            # set must be on the device).  The fused epoch takes idx[:n * bs]
            # as (n, bs) with no padding or 'valid': an unshuffled dataset
            # that does not divide into batches takes the per-step loop
            # (whether it does is the same in every epoch)
            if loader.fused_epoch()[0] is not None:
                return self.train_epoch_fused(loader)
        self.loader = loader
        self.call_hook("before_train_epoch")
        self._pending = []
        t_iter = time.perf_counter()
        self._epoch_t0 = t_iter
        # a device-resident loader's batches are on the device already
        batches = (iter(loader) if getattr(loader, "device_resident", False)
                   else device_prefetch(loader, self.device))
        try:
            for i, batch in enumerate(batches):
                self.inner_iter = i
                self.call_hook("before_train_iter")
                t_data = time.perf_counter()
                batch.pop("meta", None)    # the step takes tensors only
                batch.pop("valid", None)   # train batches are always full
                self.state, metrics = self.train_step(self.state, batch)
                self._host_step += 1
                self._pending.append(metrics)
                t_done = time.perf_counter()
                # the H2D copies run on device_prefetch's thread and stream,
                # so data_time holds the wait for a copied batch
                self.timings = {"data_time": t_data - t_iter, "step_time": t_done - t_data,
                                "time": t_done - t_iter}
                self.iter_seconds.append(t_done - t_iter)
                self.call_hook("after_train_iter")
                self._check_preempt()
                t_iter = time.perf_counter()
        finally:
            batches.close()
        self.epoch += 1
        self.call_hook("after_train_epoch")

    def train_epoch_fused(self, loader):
        """One ``make_epoch_step`` call per epoch over a device-cached
        dataset.  Iteration hooks cannot fire inside it; epoch hooks and
        interval logging (from the stacked metrics, read once) are kept.
        Preemption is honored at epoch ends."""
        self.loader = loader
        self.call_hook("before_train_epoch")
        idx, shapes, orig_dtypes = loader.fused_epoch()
        if self._epoch_step is None:
            self._warn_iteration_hooks()
            self._epoch_step = make_epoch_step(self.train_step, loader.batch_size, shapes,
                                               orig_dtypes, getattr(loader, "shard", None))
        n = len(idx) // self._epoch_step.rows_per_step
        t0 = time.perf_counter()
        self._epoch_t0 = t0
        self.state, ms = self._epoch_step(self.state, loader.data, idx)
        self._host_step += n
        keys = [k for k, v in ms.items() if v.dim() == 1]
        host = torch.stack([ms[k] for k in keys], dim=1).cpu().tolist()   # waits for the epoch
        per_iter = (time.perf_counter() - t0) / max(n, 1)
        self.iter_seconds += [per_iter] * n
        for start in range(0, n, self.log_interval):
            end = min(start + self.log_interval, n)
            self.inner_iter = end - 1
            for row in host[start:end]:
                self.log_buffer.update(dict(zip(keys, row)))
            self.log_buffer.update({"time": per_iter, "data_time": 0.0, "step_time": per_iter})
            self.log_buffer.average(end - start)
            self.emit_log(end, n)
            self.log_buffer.clear_output()
        self.epoch += 1
        self.call_hook("after_train_epoch")
        self._check_preempt()

    def _warn_iteration_hooks(self):
        """Say once which registered hooks a fused epoch leaves silent: those
        that act on iteration events (interval logging aside, which the
        fused epoch does itself from the stacked metrics)."""
        silent = [type(h).__name__ for h in self._hooks
                  if not isinstance(h, LoggerHook)
                  and (type(h).before_train_iter is not Hook.before_train_iter
                       or type(h).after_train_iter is not Hook.after_train_iter)]
        if silent:
            self.logger.warning(
                f"fused epochs fire no iteration events: {', '.join(silent)} will not run "
                "(drop --fuse_epochs to use them)")

    def flush_metrics(self):
        """Read the pending scalar metrics with one device-to-host copy."""
        if not self._pending:
            return
        keys = [k for k, v in self._pending[0].items()
                if k != "loc_loss_elem" and v.dim() == 0]
        host = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in self._pending]).cpu().tolist()
        for row in host:
            self.log_buffer.update(dict(zip(keys, row)))
        self._pending = []

    def save_checkpoint(self):
        path = save_training_checkpoint(self.work_dir, self.state.model,
                                        self.state.optimizer, self.epoch,
                                        self._host_step, self.meta)
        if self.is_writer:
            self.logger.info(f"saved checkpoint {path}")
        return path

    def emit_log(self, it: int, n: int):
        if not self.is_writer:
            return
        out = dict(self.log_buffer.output)
        step = self._host_step
        elapsed = time.perf_counter() - self._epoch_t0
        per_it = elapsed / max(it, 1)
        eta = (n - it) * per_it + (self.total_epochs - self.epoch - 1) * n * per_it
        lr = out.get("lr", float(self.lr_fn(step)) if self.lr_fn else 0.0)
        self.logger.info(
            f"Epoch [{self.epoch + 1}/{self.total_epochs}][{it}/{n}] "
            f"lr: {lr:.5f}, eta: {int(eta)}s, loss: {out.get('loss', 0):.4f}, "
            f"hm: {out.get('hm_loss', 0):.4f}, loc: {out.get('loc_loss', 0):.4f}, "
            f"time: {out.get('time', 0) * 1000:.0f}ms "
            f"(data {out.get('data_time', 0) * 1000:.0f} / "
            f"step {out.get('step_time', 0) * 1000:.0f})")
        rec = dict(out, mode="train", epoch=self.epoch + 1, iter=it, step=step)
        with open(self.json_log, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb:
            self.tb.add_scalars({f"train/{k}": v for k, v in out.items()}, step)
