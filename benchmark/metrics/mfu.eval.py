"""The whole eval frame's (sparse predict) share of the card's bf16 peak
(%), over a frame's time before the profiler started."""

from benchmark.harness import readers


def read(trace):
    return readers.mfu_pct(trace, "predict", unprofiled=True)
