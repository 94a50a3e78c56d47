"""Device ms a step of GroupNorm, reduction and elementwise kernels."""


def read(trace):
    return trace.class_ms_per_unit("norm_eltwise")
