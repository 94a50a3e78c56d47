"""The int8 K3 kernel's launches in a batch of the int8 serving artifact
against their roofline (%), ``harness/int8_counts.py``."""

from benchmark.harness import int8_counts


def read(trace):
    return int8_counts.k3_int8_roofline_pct(trace)
