from .checkpoint import (load_training_checkpoint, resolve_checkpoint,
                         save_training_checkpoint)
from .convert import (bind_sites, load_checkpoint, save_checkpoint, site_paths,
                      state_dict_from_jax)
from .evaluator import device_prefetch, run_eval, save_predictions
from .hooks import (PRIORITIES, CheckpointHook, Hook, HTTPLoggerHook, LoggerHook,
                    ProfilerHook, SamplerSeedHook)
from .log_buffer import LogBuffer
from .steps import (VOXEL_KEYS, EpochStep, EvalGraphs, TrainState, create_train_state,
                    make_epoch_step, make_eval_step, make_loss_fn, make_train_step,
                    model_input_of, preprocess_raw, targets_from_batch)
from .trainer import Preempted, Trainer, get_root_logger

__all__ = ["load_training_checkpoint", "resolve_checkpoint", "save_training_checkpoint",
           "bind_sites", "load_checkpoint", "save_checkpoint", "site_paths",
           "state_dict_from_jax",
           "device_prefetch", "run_eval", "save_predictions", "PRIORITIES",
           "CheckpointHook", "Hook", "HTTPLoggerHook", "LoggerHook", "ProfilerHook",
           "SamplerSeedHook", "LogBuffer", "VOXEL_KEYS", "EpochStep", "EvalGraphs",
           "TrainState",
           "create_train_state", "make_epoch_step", "make_eval_step", "make_loss_fn",
           "make_train_step", "model_input_of", "preprocess_raw",
           "targets_from_batch", "Preempted", "Trainer", "get_root_logger"]
