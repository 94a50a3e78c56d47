"""Device ms a step of the library's (cuDNN) conv kernels."""


def read(trace):
    return trace.class_ms_per_unit("conv_lib")
