"""Hand-written CUDA kernels and their plain PyTorch versions.  Importing
this package registers the kernels as ``torch.ops.rtpose`` custom ops
(``ops/library.py``), which a loaded serving artifact needs."""

from . import (conv_k3, conv_k3_int8, deform_conv, group_norm, interpolate, library,
               preprocess)
from .build import launch_counts, reset_launch_counts
