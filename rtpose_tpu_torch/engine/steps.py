"""Train and eval steps.

Counterpart of ``rtpose_tpu/engine/steps.py:31-42, 48-194, 242-329``.
Batches are dicts of tensors on the model's device:
  rdr_tensor: (B, Z, Y, X, C) float32 normalized radar cube, or
  rdr_raw:    (B, D, Z', Y', X') ROI-cropped raw cube in its disk dtype;
  poses:      (B, max_poses, 15, 3) float32 world keypoints (training);
  num_poses:  (B,) int.
Training targets are assigned on the device from ``poses``
(``core.targets.assign_pose_targets``) unless the batch carries them.

The train step runs forward, loss, backward, the optimizer and the NaN/Inf
guard without reading anything back to the host: the guard is a
``torch.where`` on the device (``AdamOneCycle.step(finite=...)``), so the
host can queue the next step at once; the metrics come back as device
tensors, which the trainer reads once per log interval.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from ..core.decode import decode_pose_sparse
from ..core.targets import PoseTargetSpec, assign_pose_targets
from ..models.losses import fast_focal_loss_logits, masked_l1
from ..ops.preprocess import fused_preprocess_batch


@dataclasses.dataclass
class TrainState:
    """What a train step changes: the model's parameters (in place), the
    optimizer's moments and its own step count, and the global step, an
    int64 tensor on the parameters' device.  The global step advances on
    every step; the optimizer's count only on a step whose loss was finite
    (``rtpose_tpu/engine/steps.py:169-174, 191-192``)."""

    model: Any
    optimizer: Any
    step: torch.Tensor


def create_train_state(model, optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer,
                      step=torch.zeros((), dtype=torch.int64,
                                       device=next(model.parameters()).device))


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


def targets_from_batch(batch: Dict[str, torch.Tensor], spec: PoseTargetSpec):
    """Per-task target lists, assigned on the device unless precomputed;
    heatmaps channels-last (B, Z, Y, X, C)."""
    if "hm" in batch:
        return {k: batch[k] for k in ("hm", "ind", "mask", "cat", "anno_pose")}
    t = assign_pose_targets(batch["poses"], batch["num_poses"], spec)
    return dict(hm=[t["hm"].permute(0, 2, 3, 4, 1)], ind=[t["ind"]], mask=[t["mask"]],
                cat=[t["cat"]], anno_pose=[t["anno_pose"]])


def make_loss_fn(model, head, spec: PoseTargetSpec, input_key: str = "rdr_tensor",
                 sparse_reg: bool = False, remat: bool = False,
                 preprocess: Optional[tuple] = None,
                 loc_weight_fn: Optional[Callable] = None) -> Callable:
    """``loss_fn(batch, step) -> (total, losses)``: the train step's
    objective (``steps.py:122-162``), differentiable in the parameters.

    ``sparse_reg`` (single-task one_hm): the reg tower runs only on the 5^3
    receptive-field patches at the target indices, which is exactly the
    dense loss.  ``remat``: the forward and loss run under
    ``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes
    activations instead of keeping them; the device preprocess of a raw
    batch stays outside the recomputed region (it holds no parameter).
    ``loc_weight_fn``: ``step -> weight`` replacing ``head.weight`` in
    total = hm_loss + w(step) * loc_loss.
    """
    code_w = torch.tensor(head.code_weights, dtype=torch.float32)

    def sparse_losses(x, example):
        ind, mask = example["ind"][0], example["mask"][0]
        hm_logits, reg_at_ind = model.forward_sparse_train(x, ind)
        hm_loss = fast_focal_loss_logits(hm_logits, example["hm"][0], ind, mask,
                                         example["cat"][0])
        rl = masked_l1(reg_at_ind.float(), mask, example["anno_pose"][0])
        loc_loss = torch.sum(rl * code_w.to(rl.device))
        return {"loss": [hm_loss + head.weight * loc_loss], "hm_loss": [hm_loss],
                "loc_loss": [loc_loss], "loc_loss_elem": [rl],
                "num_positive": [mask.float().sum()]}

    def compute_losses(x, example):
        if sparse_reg:
            return sparse_losses(x, example)
        return head.loss(example, model(x))

    def loss_fn(batch, step):
        example = targets_from_batch(batch, spec)
        x = model_input_of(batch, input_key, preprocess)
        if remat:
            losses = torch.utils.checkpoint.checkpoint(compute_losses, x, example,
                                                       use_reentrant=False)
        else:
            losses = compute_losses(x, example)
        if loc_weight_fn is None:
            total = torch.stack(losses["loss"]).sum()
        else:
            total = (torch.stack(losses["hm_loss"]).sum()
                     + loc_weight_fn(step) * torch.stack(losses["loc_loss"]).sum())
        return total, losses

    return loss_fn


def make_train_step(model, head, spec: PoseTargetSpec, optimizer,
                    lr_fn: Optional[Callable] = None, input_key: str = "rdr_tensor",
                    sparse_reg: bool = False, remat: bool = False,
                    preprocess: Optional[tuple] = None,
                    loc_weight_fn: Optional[Callable] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: loss, backward,
    clipped one-cycle Adam, and the NaN/Inf guard that keeps parameters,
    moments and the optimizer's count when the loss is not finite.  The
    metrics are device tensors: loss, hm_loss, loc_loss, num_positive,
    grad_norm (before clipping), skipped, loc_loss_elem, and lr /
    loc_weight where their functions are given (at the global step)."""
    loss_fn = make_loss_fn(model, head, spec, input_key, sparse_reg, remat,
                           preprocess, loc_weight_fn)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("train_step: the state holds another model or optimizer")
        for p in params:
            p.grad = None
        loss, losses = loss_fn(batch, state.step)
        loss.backward()
        finite = torch.isfinite(loss.detach())
        grad_norm = optimizer.step(finite=finite)
        for p in params:
            p.grad = None
        metrics = dict(
            loss=loss.detach(),
            hm_loss=torch.stack(losses["hm_loss"]).sum().detach(),
            loc_loss=torch.stack(losses["loc_loss"]).sum().detach(),
            num_positive=torch.stack(losses["num_positive"]).sum().detach(),
            grad_norm=grad_norm,
            skipped=(~finite).to(torch.float32),
            loc_loss_elem=losses["loc_loss_elem"][0].detach())
        if lr_fn is not None:
            metrics["lr"] = lr_fn(state.step)
        if loc_weight_fn is not None:
            metrics["loc_weight"] = loc_weight_fn(state.step)
        state.step = state.step + 1
        return state, metrics

    return train_step


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
