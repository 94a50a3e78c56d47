from .optim import (AdamOneCycle, build_optimizer_from_cfg, make_one_cycle_fns,
                    one_cycle_values)
from .schedules import (cosine_lr, exp_lr, exponential_decay_staircase, fixed_lr, inv_lr,
                        manual_stepping, piecewise_weight, poly_lr, step_lr, with_warmup)

__all__ = ["AdamOneCycle", "build_optimizer_from_cfg", "make_one_cycle_fns",
           "one_cycle_values", "cosine_lr", "exp_lr", "exponential_decay_staircase",
           "fixed_lr", "inv_lr", "manual_stepping", "piecewise_weight", "poly_lr",
           "step_lr", "with_warmup"]
