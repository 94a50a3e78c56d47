"""Terminal progress bar (torchie/utils/progressbar.py parity).

A copy of ``rtpose_tpu/utils/progressbar.py``.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, task_num: int = 0, bar_width: int = 50,
                 start: bool = True, file=sys.stdout):
        self.task_num = task_num
        self.bar_width = bar_width
        self.completed = 0
        self.file = file
        if start:
            self.start()

    def start(self):
        if self.task_num > 0:
            self.file.write(f"[{' ' * self.bar_width}] 0/{self.task_num}, "
                            "elapsed: 0s, ETA:")
        else:
            self.file.write("completed: 0, elapsed: 0s")
        self.file.flush()
        self.start_time = time.time()

    def update(self, n: int = 1):
        self.completed += n
        elapsed = max(time.time() - self.start_time, 1e-9)
        fps = self.completed / elapsed
        if self.task_num > 0:
            pct = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - pct) / max(pct, 1e-9) + 0.5)
            mark_width = int(self.bar_width * pct)
            bar = ">" * mark_width + " " * (self.bar_width - mark_width)
            self.file.write(
                f"\r[{bar}] {self.completed}/{self.task_num}, "
                f"{fps:.1f} task/s, elapsed: {int(elapsed + 0.5)}s, ETA: {eta:5}s")
            if self.completed == self.task_num:
                self.file.write("\n")
        else:
            self.file.write(
                f"\rcompleted: {self.completed}, elapsed: {int(elapsed + 0.5)}s,"
                f" {fps:.1f} tasks/s")
        self.file.flush()
