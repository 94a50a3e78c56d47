"""Idle share of the card in an eval frame (%): the traced frames'
device-busy time over a frame's time before the profiler started."""

from benchmark.harness import readers


def read(trace):
    return readers.idle_pct(trace, unprofiled=True)
