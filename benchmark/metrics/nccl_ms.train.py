"""Device ms a step of NCCL kernels (rank 0)."""


def read(trace):
    return trace.class_ms_per_unit("nccl")
