"""Idle share of the card in an eval batch (%): the traced batches'
device-busy time over a batch's time before the profiler started."""

from benchmark.harness import readers


def read(trace):
    return readers.idle_pct(trace, unprofiled=True)
