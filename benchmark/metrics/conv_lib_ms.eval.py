"""Device ms a frame of the library's (cuDNN) conv kernels in the traced
stretch (``harness/kernel_classes.py``'s ``conv_lib``): the convs off the K3
shape, which carry the whole trunk and the head's shared conv of the
complex-cube model; None where the stretch has none."""

from benchmark.harness import readers


def read(trace):
    ms = trace.class_ms_per_unit("conv_lib")
    return None if ms is None else ms / readers.batch(trace)
