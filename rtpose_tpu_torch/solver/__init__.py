from .optim import (AdamOneCycle, build_optimizer_from_cfg, make_one_cycle_fns,
                    one_cycle_values)
from .schedules import piecewise_weight

__all__ = ["AdamOneCycle", "build_optimizer_from_cfg", "make_one_cycle_fns",
           "one_cycle_values", "piecewise_weight"]
