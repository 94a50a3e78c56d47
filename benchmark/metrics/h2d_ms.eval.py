"""Device ms of host-to-device copies a frame."""

from benchmark.harness import readers


def read(trace):
    ms = trace.class_ms_per_unit("h2d")
    return None if ms is None else ms / readers.batch(trace)
