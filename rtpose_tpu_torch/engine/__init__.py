from .convert import load_checkpoint, save_checkpoint, state_dict_from_jax
from .evaluator import device_prefetch, run_eval, save_predictions
from .steps import make_eval_step, model_input_of, preprocess_raw

__all__ = ["load_checkpoint", "save_checkpoint", "state_dict_from_jax",
           "device_prefetch", "run_eval", "save_predictions", "make_eval_step",
           "model_input_of", "preprocess_raw"]
