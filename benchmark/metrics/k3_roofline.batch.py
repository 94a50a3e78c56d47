"""K3's launches in the batched eval forward against their roofline (%)."""

from benchmark.harness import readers


def read(trace):
    return readers.k3_roofline_pct(trace, 1)
