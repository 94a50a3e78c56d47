"""rtpose_tpu_torch — the PyTorch / CUDA port of rtpose_tpu for one NVIDIA H100.

Mirrors the module layout of ``rtpose_tpu`` (the JAX reference, which this
package never imports).  Layouts at the public functions are the JAX
package's: model input (B, Z, Y, X, C), heatmaps (B, Z, Y, X, C),
preprocess output (B, Z', Y', X', D).  The hand-written CUDA kernels live
in ``csrc/`` and are built with ``nvcc`` at first use (``ops/build.py``);
the native C++ cube loader in ``native/`` with ``g++`` at its first use.
"""

from . import core, data, engine, models, ops, parallel, solver, utils
from .api import assemble, build_dataset_from_cfg, resolve_device, serving_variant
from .config import Config

__all__ = ["core", "data", "engine", "models", "ops", "parallel", "solver", "utils", "assemble",
           "build_dataset_from_cfg", "resolve_device", "serving_variant", "Config"]
