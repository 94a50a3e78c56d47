"""K3's launches in training (forward and grad-input) against their roofline (%)."""

from benchmark.harness import readers


def read(trace):
    return readers.k3_roofline_pct(trace, 2)
