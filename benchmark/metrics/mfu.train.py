"""The whole train step's share of the card's bf16 peak (%)."""

from benchmark.harness import readers


def read(trace):
    return readers.mfu_pct(trace, "train")
