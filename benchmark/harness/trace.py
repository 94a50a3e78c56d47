"""Traced stretches of the window: ``torch.profiler`` with a sentinel guard.

A stretch is a stated count of steps or frames, the same every run
(``Schedule``, from the traffic mix's ``trace``: ``count`` calls from call
``after``).  The profiler records the card's activity alone there, since
recording the host's operations slows a host-bound loop (at B=1 it made a
frame about twice as long).  Right after it, ``named`` calls more are
traced with the host's operations too; they only name what the host was
doing in the breakdown's idle gaps.

``Tracer.start`` opens the profiler, lets the card idle a moment and
queues ``SENTINELS`` spin kernels; ``Tracer.stop`` queues as many again,
waits for the card, idles it a moment and closes the profiler.  Only the
device operations between the two groups of spin kernels count, and the
traced stretch runs from the end of the first group to the start of the
second.

On the H100, traces taken late in a long process lost their first device
operations (the program's per-segment tool saw it first and guards its
traces so).  The same guard is kept here: a trace that kept
``SENTINELS`` or fewer spin kernels may have lost the stretch's own
operations, and is refused.  ``guard`` is that test, on plain event
lists, so it can be checked without a card.

What a per-layer metric reads is a ``Trace``: the device operations of the
stretch (name, start and end in microseconds, all streams), its length
and the units (steps or frames) it covers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

SENTINELS, SPIN_CYCLES = 64, 1000
SPIN_KERNEL = "spin_kernel"     # torch.cuda._sleep's kernel
EDGE_S = 0.05

Event = Tuple[str, float, float]     # name, start us, end us


class TraceLost(RuntimeError):
    pass


def guard(device_events: Sequence[Event]) -> Tuple[float, float]:
    """The stretch (start, end) in us between the two groups of spin
    kernels; raises ``TraceLost`` when the trace kept ``SENTINELS`` or
    fewer of them, or not both groups."""
    spins = sorted((e for e in device_events if SPIN_KERNEL in e[0]), key=lambda e: e[1])
    if len(spins) <= SENTINELS:
        raise TraceLost(f"the trace kept {len(spins)} of its {2 * SENTINELS} sentinel "
                        "kernels, so it may have lost the stretch's own operations")
    gaps = [spins[i + 1][1] - spins[i][2] for i in range(len(spins) - 1)]
    cut = max(range(len(gaps)), key=gaps.__getitem__)
    return spins[cut][2], spins[cut + 1][1]


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclasses.dataclass
class Trace:
    ops: List[Event]                  # device operations inside the stretch, sentinels out
    start_us: float
    end_us: float
    units: int                        # steps or frames traced
    host_ops: List[Event]             # outermost host events (with the card's: its API calls)
    extra: dict = dataclasses.field(default_factory=dict)   # what the run adds for the readers
    named: Optional["Trace"] = None   # the stretch traced with the host's operations

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us([(max(s, self.start_us), min(e, self.end_us)) for _, s, e in self.ops
                         if e > self.start_us and s < self.end_us]) / 1e6

    def class_ms_per_unit(self, cls: str) -> Optional[float]:
        """Device ms a unit of the operations of one kernel class; None if
        the stretch has none."""
        from benchmark.harness.kernel_classes import classify
        ds = [e - s for n, s, e in self.ops if classify(n) == cls]
        return sum(ds) / 1e3 / self.units if ds else None

    def ops_named(self, part: str) -> List[Event]:
        return [o for o in self.ops if part in o[0]]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps by
        what the host was doing (in the stretch traced with its operations,
        where there is one)."""
        by: dict = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        device_ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in device_ops],
                "idle_gaps": (self.named or self).idle_gaps(top)}

    def idle_gaps(self, top: int = 10) -> list:
        busy = sorted((max(s, self.start_us), min(e, self.end_us)) for _, s, e in self.ops
                      if e > self.start_us and s < self.end_us)
        gaps, at = [], self.start_us
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.end_us > at:
            gaps.append((at, self.end_us))
        idle: dict = {}
        for s, e in gaps:
            mid = (s + e) / 2
            host = [n for n, hs, he in self.host_ops if hs <= mid <= he]
            key = host[0] if host else "(no host operation)"
            idle[key] = idle.get(key, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]


class Tracer:
    """One stretch: the card's activity, and with ``host`` the host's
    operations too."""

    def __init__(self, device, host: bool = False):
        self.device, self.host = device, host
        self.prof = None

    def _sentinels(self):
        import torch
        for _ in range(SENTINELS):
            torch.cuda._sleep(SPIN_CYCLES)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host else [])
        self.prof = profile(activities=activities)
        self.prof.start()
        time.sleep(EDGE_S)
        self._sentinels()

    def stop(self, units: int) -> Trace:
        import torch
        self._sentinels()
        torch.cuda.synchronize(self.device)
        time.sleep(EDGE_S)
        prof, self.prof = self.prof, None
        prof.stop()
        return self.read(prof, units)

    def close(self):
        """Stop a profiler left running (a run that failed inside the
        stretch)."""
        if self.prof is not None:
            self.prof.stop()
            self.prof = None

    @staticmethod
    def read(prof, units: int) -> Trace:
        """The stretch's events from the profiler's raw results (building
        its event tree takes minutes for a few hundred thousand events)."""
        dev, host = raw_events(prof)
        t0, t1 = guard(dev)
        ops = [o for o in dev if SPIN_KERNEL not in o[0] and o[2] > t0 and o[1] < t1]
        host = [h for h in outermost(host) if h[2] > t0 and h[1] < t1]
        return Trace(ops=ops, start_us=t0, end_us=t1, units=units, host_ops=host)


class Schedule:
    """The stretches of a window, started and stopped before stated calls
    (``offset`` calls of the loop come before the window's first)."""

    def __init__(self, device, tcfg: dict, offset: int = 0):
        self.device = device
        self.after = offset + int(tcfg["after"])
        self.count, self.named = int(tcfg["count"]), int(tcfg.get("named", 0))
        self.tracer = None
        self.trace: Optional[Trace] = None
        self.opened = None      # host clock when the profiler was first started
        self.done = False

    def before_call(self, k: int):
        end = self.after + self.count
        if k == self.after:
            self.opened = time.perf_counter()
            self.tracer = Tracer(self.device)
            self.tracer.start()
        elif k == end:
            self.trace, self.tracer = self.tracer.stop(self.count), None
            self.done = not self.named
            if self.named:
                self.tracer = Tracer(self.device, host=True)
                self.tracer.start()
        elif self.named and k == end + self.named:
            tracer, self.tracer = self.tracer, None
            try:
                self.trace.named = tracer.stop(self.named)
            except TraceLost:       # it names the idle gaps alone; the metrics stand
                pass
            self.done = True

    def close(self):
        """Stop a profiler left running (a run that failed inside a
        stretch)."""
        if self.tracer is not None:
            self.tracer.close()
            self.tracer = None


def raw_events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events), each (name, start us, end us)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
    return dev, host


def outermost(events: Sequence[Event]) -> List[Event]:
    """The events no other event encloses."""
    out, end = [], float("-inf")
    for ev in sorted(events, key=lambda e: (e[1], -e[2])):
        if ev[1] >= end:
            out.append(ev)
            end = ev[2]
    return out
