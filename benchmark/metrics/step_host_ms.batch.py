"""Median host ms of the eval step's call on a batch, untraced calls."""

from benchmark.harness import readers


def read(trace):
    return readers.median_host_ms(trace)
