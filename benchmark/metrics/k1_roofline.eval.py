"""The preprocess kernel's launches against their roofline (%)."""

from benchmark.harness import readers


def read(trace):
    return readers.k1_roofline_pct(trace)
