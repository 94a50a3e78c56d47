"""Eval steps: device preprocessing, forward and on-device decode.

Counterpart of ``rtpose_tpu/engine/steps.py:48-73, 242-329`` (the eval
side; the train step waits for the training slice).  Batches are dicts of
tensors on the model's device:
  rdr_tensor: (B, Z, Y, X, C) float32 normalized radar cube, or
  rdr_raw:    (B, D, Z', Y', X') ROI-cropped raw cube in its disk dtype.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..core.decode import decode_pose_sparse
from ..ops.preprocess import fused_preprocess_batch


def preprocess_raw(raw: torch.Tensor, norm: tuple) -> torch.Tensor:
    """(B, D, Z', Y', X') raw -> (B, Z', Y', X', D) float32 normalized: the
    card's replacement for the host ``get_cube`` (preprocess kernel)."""
    B, D, Z, Y, X = raw.shape
    roi = (0, Z - 1, 0, Y - 1, 0, X - 1)
    return fused_preprocess_batch(raw, roi, float(norm[0]), float(norm[1]))


def model_input_of(batch: Dict[str, torch.Tensor], input_key: str = "rdr_tensor",
                   preprocess: Optional[tuple] = None) -> torch.Tensor:
    """The model's input from a batch; a batch carrying 'rdr_raw' is
    preprocessed on the device first."""
    if input_key == "rdr_tensor" and "rdr_raw" in batch:
        if preprocess is None:
            raise ValueError("raw batches need the (norm_start, norm_scale) window")
        return preprocess_raw(batch["rdr_raw"], preprocess)
    return batch[input_key]


def make_eval_step(model, decode_spec, input_key: str = "rdr_tensor",
                   sparse: bool = False,
                   preprocess: Optional[tuple] = None) -> Callable:
    """Forward + decode; the step returns per-task (kpts, scores, labels).

    ``sparse=True`` (single-task one_hm configs): the reg tower runs only on
    the receptive-field patch around each heatmap peak
    (``RadarPoseNet.predict_sparse``).
    """
    @torch.inference_mode()
    def eval_step(batch):
        x = model_input_of(batch, input_key, preprocess)
        if sparse:
            hm, reg_at_peak, peak_ind = model.predict_sparse(x)
            return [decode_pose_sparse(hm, reg_at_peak, peak_ind, decode_spec)]
        return model.pose_head.predict(model(x), decode_spec)

    return eval_step
