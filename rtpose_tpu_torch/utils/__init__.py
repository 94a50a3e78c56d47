"""Utilities of the port: object-store IO, file IO, timer, progress bar,
config helpers, parameter / FLOP counts and parameter freezing.

Counterpart of ``rtpose_tpu/utils``.  ``rtpose_tpu/utils/platform.py`` has
no counterpart: it re-applies ``JAX_PLATFORMS`` for JAX; the port's device
rule is ``api.resolve_device``."""

from .config_tool import get_downsample_factor
from .fileio import dump as dump_file
from .fileio import load as load_file
from .flops import count_parameters, estimate_flops
from .freeze import freeze_mask, split_frozen
from .progressbar import ProgressBar
from .timer import Timer

__all__ = ["get_downsample_factor", "dump_file", "load_file", "count_parameters",
           "estimate_flops", "freeze_mask", "split_frozen", "ProgressBar", "Timer"]
