"""Scalar metric accumulation (LogBuffer parity, trainer/log_buffer.py:6-42).

Counterpart of ``rtpose_tpu/engine/log_buffer.py``."""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class LogBuffer:
    def __init__(self):
        self.val_history = defaultdict(list)
        self.n_history = defaultdict(list)
        self.output = {}
        self.ready = False

    def clear(self):
        self.val_history.clear()
        self.n_history.clear()
        self.clear_output()

    def clear_output(self):
        self.output.clear()
        self.ready = False

    def update(self, vars: dict, count: int = 1):
        for k, v in vars.items():
            self.val_history[k].append(float(v))
            self.n_history[k].append(count)

    def average(self, n: int = 0):
        """Weighted average of the last n entries (0 = all)."""
        for k in self.val_history:
            vals = np.asarray(self.val_history[k][-n:], np.float64)
            ns = np.asarray(self.n_history[k][-n:], np.float64)
            self.output[k] = float((vals * ns).sum() / max(ns.sum(), 1e-12))
        self.ready = True
