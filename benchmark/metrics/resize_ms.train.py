"""Device ms a step of the trilinear resize, forward and backward."""


def read(trace):
    return trace.class_ms_per_unit("resize")
