"""Median host ms of the eval step's call (forward and decode dispatch), untraced frames."""

from benchmark.harness import readers


def read(trace):
    return readers.median_host_ms(trace)
