"""Context timer (torchie/utils/timer.py parity).

A copy of ``rtpose_tpu/utils/timer.py``.
"""

from __future__ import annotations

import time


class TimerError(Exception):
    pass


class Timer:
    def __init__(self, start: bool = True, print_tmpl: str | None = None):
        self._is_running = False
        self.print_tmpl = print_tmpl or "{:.3f}"
        if start:
            self.start()

    @property
    def is_running(self) -> bool:
        return self._is_running

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *args):
        print(self.print_tmpl.format(self.since_last_check()))
        self._is_running = False

    def start(self):
        if not self._is_running:
            self._t_start = time.perf_counter()
            self._is_running = True
        self._t_last = time.perf_counter()

    def since_start(self) -> float:
        if not self._is_running:
            raise TimerError("timer is not running")
        self._t_last = time.perf_counter()
        return self._t_last - self._t_start

    def since_last_check(self) -> float:
        if not self._is_running:
            raise TimerError("timer is not running")
        dur = time.perf_counter() - self._t_last
        self._t_last = time.perf_counter()
        return dur
