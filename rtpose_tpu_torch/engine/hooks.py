"""Prioritized trainer hooks.

Counterpart of ``rtpose_tpu/engine/hooks.py:33-161`` (reference
``det3d/torchie/trainer/hooks/``): the loop-structure events, and the
built-in behaviors as registered hooks — loader epoch reseed, interval
logging, checkpoint cadence.  Hooks read and change trainer state through
the ``trainer`` argument (``epoch``, ``inner_iter``, ``state``,
``log_buffer``, ``timings``, ``loader``).  The profiler and HTTP logger
hooks are not ported.
"""

from __future__ import annotations

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
    metrics only at logging time (one device-to-host copy per interval)."""

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


class CheckpointHook(Hook):
    """Every-N-epochs checkpoint, and always at the final epoch
    (hooks/checkpoint.py:5-21)."""

    priority = PRIORITIES["LOWEST"]

    def __init__(self, interval: int = 5):
        self.interval = interval

    def after_train_epoch(self, trainer):
        if self.every_n_epochs(trainer, self.interval) or trainer.epoch == trainer.total_epochs:
            trainer.save_checkpoint()
