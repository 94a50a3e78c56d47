"""Host spans at the port's layer boundaries, on the profiler's clock.

``with span("predict.backbone"): ...`` marks a block of host code.  Off (the
default), ``span`` returns one shared no-op context after a single check of
a module flag: it builds no ``record_function`` and reads no clock.  On
(``enable``), it appends ``(name, thread id, start ns, end ns)`` to a buffer
that keeps the newest ``CAPACITY`` spans and counts the ones it dropped;
``take`` returns the spans and empties the buffer.  A reader of the buffer
traces the card's activity alone around it.

``enable(profiler_ranges=True)`` instead makes each span a
``torch.profiler.record_function(name)``, a named range in a Chrome trace of
the host's operations, and records nothing in the buffer: the trace holds
it.  ``engine.hooks.start_trace`` (``--profile``) turns that on.

The clock is ``time.time_ns()``.  ``torch.profiler`` stamps its events, host
and device (``prof.profiler.kineto_results.events()[i].start_ns()``), in
nanoseconds since the Unix epoch, which is what ``time.time_ns()`` reads
(``time.perf_counter`` is another clock).  So spans recorded while the
profiler traces the card's activity alone can be laid over that trace, and
each idle gap of the card put down to what the host was doing, without
tracing the host's operations, which slows a host-bound loop.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import List, Tuple

import torch

CAPACITY = 1 << 16
Span = Tuple[str, int, int, int]        # name, thread id, start ns, end ns

NOOP = contextlib.nullcontext()

_on = False
_ranges = False
_lock = threading.Lock()
_spans: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_dropped = 0


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        global _dropped
        with _lock:
            if len(_spans) == CAPACITY:
                _dropped += 1
            _spans.append((self.name, threading.get_ident(), self.t0, t1))
        return False


def span(name: str):
    """A context that records the block as ``name`` while spans are on."""
    if not _on:
        return NOOP
    if _ranges:
        return torch.profiler.record_function(name)
    return _Span(name)


def enable(profiler_ranges: bool = False) -> None:
    global _on, _ranges
    _ranges = profiler_ranges
    _on = True


def disable() -> None:
    global _on, _ranges
    _on = _ranges = False


def take() -> List[Span]:
    """The recorded spans in the order they ended; empties the buffer and
    the dropped count."""
    global _dropped
    with _lock:
        out = list(_spans)
        _spans.clear()
        _dropped = 0
    return out


def dropped() -> int:
    """Spans dropped (the oldest first) since the last ``take``; a reader
    of ``take`` reads it first."""
    return _dropped
