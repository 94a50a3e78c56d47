"""Pose evaluation metrics — parity with the reference ``eval_util.py:5-11``
(a copy of ``rtpose_tpu/core/metrics.py``, which the port may not import).

* ``abs_pjpe``: per-joint L2 error in world coordinates.
* ``pjpe``: root-relative per-joint error (both prediction and ground truth
  are translated so joint 0 — the pelvis — sits at the origin).

Unlike the reference (which mutates its inputs in place), these are pure.
"""

from __future__ import annotations

import numpy as np


def abs_pjpe(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Absolute per-joint position error. pred, gt: (J, 3) -> (J,)."""
    return np.linalg.norm(np.asarray(pred, dtype=np.float64)
                          - np.asarray(gt, dtype=np.float64), axis=-1)


def pjpe(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Root-relative (pelvis-centered) per-joint position error."""
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    return abs_pjpe(pred - pred[:1, :], gt - gt[:1, :])
