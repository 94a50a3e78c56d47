"""Prioritized trainer hooks.

Counterpart of ``rtpose_tpu/engine/hooks.py`` (reference
``det3d/torchie/trainer/hooks/``): the loop-structure events, and the
built-in behaviors as registered hooks — loader epoch reseed, interval
logging, checkpoint cadence — and two optional ones, an HTTP metrics logger
and a ``torch.profiler`` trace of a few steps.  Hooks read and change
trainer state through the ``trainer`` argument (``epoch``, ``inner_iter``,
``state``, ``log_buffer``, ``timings``, ``loader``).  In a fused epoch the
iteration events do not fire.
"""

from __future__ import annotations

import http.client
import json
import os
import time
import urllib.request
from typing import Optional

import numpy as np
import torch

from ..utils import trace

PRIORITIES = {
    "HIGHEST": 0, "VERY_HIGH": 10, "HIGH": 30, "NORMAL": 50,
    "LOW": 70, "VERY_LOW": 90, "LOWEST": 100,
}


class Hook:
    """Base hook: override any subset of events."""

    priority: int = PRIORITIES["NORMAL"]

    def before_run(self, trainer):
        pass

    def after_run(self, trainer):
        pass

    def before_train_epoch(self, trainer):
        pass

    def after_train_epoch(self, trainer):
        pass

    def before_train_iter(self, trainer):
        pass

    def after_train_iter(self, trainer):
        pass

    def after_val_epoch(self, trainer):
        pass

    @staticmethod
    def every_n_epochs(trainer, n: int) -> bool:
        return n > 0 and trainer.epoch % n == 0

    @staticmethod
    def every_n_inner_iters(trainer, n: int) -> bool:
        return n > 0 and (trainer.inner_iter + 1) % n == 0

    @staticmethod
    def end_of_epoch(trainer) -> bool:
        return trainer.inner_iter + 1 == len(trainer.loader)


class SamplerSeedHook(Hook):
    """Reseed the loader's shuffle each epoch (hooks/sampler_seed.py:4-6)."""

    priority = PRIORITIES["HIGH"]

    def before_train_epoch(self, trainer):
        trainer.loader.set_epoch(trainer.epoch)


class LoggerHook(Hook):
    """Interval text / JSON / TensorBoard logging; reads the deferred device
    metrics only at logging time (one device-to-host copy per interval).
    Every rank reads them; only rank 0 writes (``Trainer.emit_log``)."""

    priority = PRIORITIES["VERY_LOW"]

    def __init__(self, interval: int = 20):
        self.interval = interval

    def after_train_iter(self, trainer):
        if self.every_n_inner_iters(trainer, self.interval) or self.end_of_epoch(trainer):
            trainer.flush_metrics()
            trainer.log_buffer.update(trainer.timings)
            trainer.log_buffer.average(self.interval)
            trainer.emit_log(trainer.inner_iter + 1, len(trainer.loader))
            trainer.log_buffer.clear_output()


class HTTPLoggerHook(Hook):
    """Interval metric POST to an HTTP endpoint (PaviLoggerHook parity,
    ``det3d/torchie/trainer/hooks/logger/pavi.py``, for any JSON collector).

    Posts ``{"session": ..., "step": ..., "epoch": ..., "metrics": {...}}``
    after each log interval.  A failed POST is logged once and never
    interrupts training."""

    priority = PRIORITIES["LOWEST"]

    def __init__(self, url: str, interval: int = 20, session: str = "",
                 timeout: float = 2.0):
        self.url = url
        self.interval = interval
        self.session = session
        self.timeout = timeout
        self._warned = False

    def _post(self, payload: dict):
        req = urllib.request.Request(self.url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()

    def after_train_iter(self, trainer):
        if not (self.every_n_inner_iters(trainer, self.interval) or self.end_of_epoch(trainer)):
            return
        trainer.flush_metrics()
        if not trainer.is_writer:     # one rank posts the job's (global) metrics
            return
        metrics = {k: float(np.mean(v)) for k, v in trainer.log_buffer.val_history.items()
                   if v and isinstance(v[-1], (int, float))}
        try:
            self._post({"session": self.session, "step": trainer._host_step,
                        "epoch": trainer.epoch, "metrics": metrics})
        except (OSError, ValueError, http.client.HTTPException) as e:
            if not self._warned:
                trainer.logger.warning(f"HTTPLoggerHook: {e!r} (suppressing further warnings)")
                self._warned = True


class CheckpointHook(Hook):
    """Every-N-epochs checkpoint, and always at the final epoch
    (hooks/checkpoint.py:5-21); rank 0 writes it
    (``save_training_checkpoint``)."""

    priority = PRIORITIES["LOWEST"]

    def __init__(self, interval: int = 5):
        self.interval = interval

    def after_train_epoch(self, trainer):
        if self.every_n_epochs(trainer, self.interval) or trainer.epoch == trainer.total_epochs:
            trainer.save_checkpoint()


def start_trace(device: torch.device):
    """A started ``torch.profiler`` trace of host and, on a card, device
    activity, with the port's spans on as named ranges
    (``utils.trace``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    trace.enable(profiler_ranges=True)
    return prof


def stop_trace(prof, device: torch.device, log_dir: str) -> str:
    """Wait for the device's traced work, turn the spans off, stop the
    trace and write it as a Chrome trace ``<log_dir>/trace.json``; returns
    the path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    trace.disable()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


class ProfilerHook(Hook):
    """A ``torch.profiler`` trace (host and, on a card, device activity) of
    ``num_steps`` train iterations after the first ``skip_steps`` (warm-up
    stays outside), written as a Chrome trace ``<work_dir>/profile/trace.json``
    (open in chrome://tracing or Perfetto)."""

    priority = PRIORITIES["VERY_HIGH"]

    def __init__(self, num_steps: int = 10, log_dir: Optional[str] = None,
                 skip_steps: int = 3):
        self.num_steps = num_steps
        self.skip_steps = skip_steps
        self.log_dir = log_dir
        self.trace_path: Optional[str] = None
        self._seen = 0
        self._prof = None
        self._done = False

    def before_train_iter(self, trainer):
        if self._done or self._prof is not None or self._seen < self.skip_steps:
            return
        self.log_dir = self.log_dir or os.path.join(trainer.work_dir, "profile")
        self._prof = start_trace(trainer.device)
        self._t0 = time.perf_counter()

    def _stop(self, trainer):
        self.trace_path = stop_trace(self._prof, trainer.device, self.log_dir)
        self._prof = None
        self._done = True

    def after_train_iter(self, trainer):
        self._seen += 1
        if self._prof is not None and self._seen >= self.skip_steps + self.num_steps:
            self._stop(trainer)
            trainer.logger.info(f"profiler: traced {self.num_steps} steps "
                                f"({time.perf_counter() - self._t0:.2f}s) -> {self.trace_path}")

    def after_run(self, trainer):
        if self._prof is not None:    # the run ended before the window filled
            self._stop(trainer)
