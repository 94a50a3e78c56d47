"""Idle share of the card over the traced training steps (%)."""

from benchmark.harness import readers


def read(trace):
    return readers.idle_pct(trace)
