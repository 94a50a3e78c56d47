"""Train, fused-epoch and eval steps.

Counterpart of ``rtpose_tpu/engine/steps.py:31-42, 48-329``.
Batches are dicts of tensors on the model's device:
  rdr_tensor: (B, Z, Y, X, C) float32 normalized radar cube, or
  rdr_raw:    (B, D, Z', Y', X') ROI-cropped raw cube in its disk dtype, or
  the LiDAR detector's voxel keys (``VOXEL_KEYS``; ``input_key`` None);
  poses:      (B, max_poses, 15, 3) float32 world keypoints (training);
  num_poses:  (B,) int.
Training targets are assigned on the device from ``poses``
(``core.targets.assign_pose_targets``) unless the batch carries them.

The train step runs forward, loss, backward, the optimizer and the NaN/Inf
guard without reading anything back to the host: the guard is a
``torch.where`` on the device (``AdamOneCycle.step(finite=...)``), so the
host can queue the next step at once; the metrics come back as device
tensors, which the trainer reads once per log interval.  Everything a step
changes (parameters, moments, both step counts) it changes in place, and it
copies nothing from the host, so a step can be captured in a CUDA graph:
``make_epoch_step`` runs a whole epoch over a device-cached dataset as
replays of one captured step.

Under a process group (data parallelism, ``parallel``) the train step is
the gradient of the global batch's loss: the losses divide by the global
positive counts, each rank back-propagates its additive share, and the
flat gradient is summed over the ranks together with the loss and metric
shares, so every rank takes the same clipped update, or skips the same
step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.utils.checkpoint

from .. import ops, parallel
from ..core.decode import (TTA_FLIPS, decode_pose_multi, decode_pose_preds,
                           decode_pose_sparse, unflip_pose_preds)
from ..core.targets import PoseTargetSpec, assign_pose_targets
from ..data.loader import gather_batch
from ..models.losses import fast_focal_loss_logits, masked_l1
from ..ops.preprocess import fused_preprocess_batch
from ..utils import trace


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

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a train step changes in place."""
        return [*self.model.state_dict().values(), self.optimizer.mu, self.optimizer.nu,
                self.optimizer.step_count, self.step]


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


VOXEL_KEYS = ("voxels", "num_points_per_voxel", "coors", "num_voxels")


def model_input_of(batch: Dict[str, torch.Tensor], input_key: Optional[str] = "rdr_tensor",
                   preprocess: Optional[tuple] = None):
    """The model's input from a batch: one tensor (``input_key``), or the
    voxel sub-dict when ``input_key`` is None (the VoxelNet batch layout).
    A batch carrying 'rdr_raw' is preprocessed on the device first."""
    if input_key is None:
        return {k: batch[k] for k in VOXEL_KEYS}
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


def make_loss_fn(model, head, spec: PoseTargetSpec, input_key: Optional[str] = "rdr_tensor",
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
    batch stays outside the recomputed region (it holds no parameter), and
    no RNG state is saved for the recomputation (the model draws no random
    numbers, and a graph capture refuses the read).
    ``loc_weight_fn``: ``step -> weight`` replacing ``head.weight`` in
    total = hm_loss + w(step) * loc_loss.

    ``loss_fn(batch, step, count_reduce)``: ``count_reduce`` maps the
    batch's per-task positive counts (T,) to those of the global batch
    (data parallelism: their sum over the ranks); the losses normalize by
    those, and the result is this batch's additive share of the global
    batch's loss.
    """
    def sparse_losses(x, example, num_pos):
        ind, mask = example["ind"][0], example["mask"][0]
        n = None if num_pos is None else num_pos[0]
        hm_logits, reg_at_ind = model.forward_sparse_train(x, ind)
        hm_loss = fast_focal_loss_logits(hm_logits, example["hm"][0], ind, mask,
                                         example["cat"][0], n)
        rl = masked_l1(reg_at_ind.float(), mask, example["anno_pose"][0], n)
        loc_loss = torch.sum(rl * head.code_w)
        return {"loss": [hm_loss + head.weight * loc_loss], "hm_loss": [hm_loss],
                "loc_loss": [loc_loss], "loc_loss_elem": [rl],
                "num_positive": [mask.float().sum()]}

    def compute_losses(x, example, num_pos):
        if sparse_reg:
            return sparse_losses(x, example, num_pos)
        return head.loss(example, model(x), num_pos)

    def loss_fn(batch, step, count_reduce: Optional[Callable] = None):
        example = targets_from_batch(batch, spec)
        num_pos = None
        if count_reduce is not None:
            num_pos = count_reduce(torch.stack([m.float().sum() for m in example["mask"]]))
        x = model_input_of(batch, input_key, preprocess)
        if remat:
            losses = torch.utils.checkpoint.checkpoint(
                compute_losses, x, example, num_pos, use_reentrant=False,
                preserve_rng_state=False)
        else:
            losses = compute_losses(x, example, num_pos)
        if loc_weight_fn is None:
            total = torch.stack(losses["loss"]).sum()
        else:
            total = (torch.stack(losses["hm_loss"]).sum()
                     + loc_weight_fn(step) * torch.stack(losses["loc_loss"]).sum())
        return total, losses

    return loss_fn


def make_train_step(model, head, spec: PoseTargetSpec, optimizer,
                    lr_fn: Optional[Callable] = None,
                    input_key: Optional[str] = "rdr_tensor",
                    sparse_reg: bool = False, remat: bool = False,
                    preprocess: Optional[tuple] = None,
                    loc_weight_fn: Optional[Callable] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: loss, backward,
    clipped one-cycle Adam, and the NaN/Inf guard that keeps parameters,
    moments and the optimizer's count when the loss is not finite.  The
    metrics are device tensors: loss, hm_loss, loc_loss, num_positive,
    grad_norm (before clipping), skipped, loc_loss_elem, and lr /
    loc_weight where their functions are given (at the global step).

    Built under a process group (``parallel.is_distributed()``), the step
    is the data-parallel one, with two collectives: the positive counts
    summed before the forward, then one sum of the flat gradient with the
    loss and metric shares appended; the guard, the norm, the clip and Adam
    see the global values, and the metrics are the global batch's."""
    loss_fn = make_loss_fn(model, head, spec, input_key, sparse_reg, remat,
                           preprocess, loc_weight_fn)
    params = [p for p in model.parameters() if p.requires_grad]
    data_parallel = parallel.is_distributed()
    n_grad = sum(optimizer.sizes)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("train_step: the state holds another model or optimizer")
        for p in params:
            p.grad = None
        with trace.span("train.forward"):
            loss, losses = loss_fn(batch, state.step,
                                   parallel.all_reduce_sum_ if data_parallel else None)
        with trace.span("train.backward"):
            loss.backward()
        terms = [loss.detach(), torch.stack(losses["hm_loss"]).sum().detach(),
                 torch.stack(losses["loc_loss"]).sum().detach(),
                 torch.stack(losses["num_positive"]).sum().detach(),
                 losses["loc_loss_elem"][0].detach()]
        grad = None
        if data_parallel:   # the ranks' gradients and shares, summed in one buffer
            with trace.span("train.allreduce"):
                total = parallel.all_reduce_sum_(
                    optimizer.flat_grad(*(t.reshape(-1) for t in terms)))
            grad, glob = total[:n_grad], total[n_grad:]
            terms = [glob[0], glob[1], glob[2], glob[3], glob[4:]]
        with trace.span("train.optimizer"):
            finite = torch.isfinite(terms[0])
            grad_norm = optimizer.step(finite=finite, grad=grad)
        for p in params:
            p.grad = None
        metrics = dict(loss=terms[0], hm_loss=terms[1], loc_loss=terms[2],
                       num_positive=terms[3], grad_norm=grad_norm,
                       skipped=(~finite).to(torch.float32), loc_loss_elem=terms[4])
        if lr_fn is not None:
            metrics["lr"] = lr_fn(state.step)
        if loc_weight_fn is not None:
            metrics["loc_weight"] = loc_weight_fn(state.step)
        state.step += 1
        return state, metrics

    return train_step


class EpochStep:
    """``epoch_fn(state, data, idx) -> (state, metrics)``: one epoch over a
    device-cached dataset with nothing read back and, on the card, no Python
    between the operations of a step.

    ``data`` is the loader's dict of (N, K) cache rows, ``idx`` the epoch's
    ``n_steps * batch_size`` sample indices (numpy); ``metrics`` maps each
    of the train step's metrics to its values stacked (n_steps, ...),
    float32, the scalar ones columns of one (n_steps, n_scalars) tensor
    (``scalars``, in the order of ``scalar_keys``).

    One step gathers its batch from ``data`` by row ``counter`` of the
    index buffer (``gather_batch``), runs ``train_step`` and writes its
    metrics to row ``counter`` of the stacked buffers, then advances
    ``counter``; index buffer, counter and metric buffers are device
    tensors that keep their place.  On a CUDA device the step is captured
    once in a CUDA graph (after one eager warm-up step on a side stream,
    which is undone: everything ``TrainState.tensors`` names is restored),
    and an epoch is ``n_steps`` replays; ``replays`` counts them.  A capture
    that fails raises.  A replay launches the hand kernels without passing
    their wrappers, so ``ops.launch_counts`` sees the warm-up step and the
    capture and no replay: ``launches_per_step`` holds what the wrappers
    counted while the step was captured, and a replay's own launches show
    only in a device trace.  On a CPU device the same step runs ``n_steps``
    times in a loop.

    The buffers are those of the first call: later calls must bring the same
    state, the same ``data`` tensors and as many indices, and the returned
    metrics are views of buffers that the next epoch overwrites.

    ``shard`` (a ``parallel.RowShard``): ``data`` holds this rank's rows of a
    cache split over the ranks, ``idx`` every rank's batches of a step back
    to back (``rows_per_step = world x batch_size`` indices a step), and a
    step builds this rank's batch with the shard's exchange, a collective
    that the graph captures with the step's own.  ``collectives_per_step``
    holds what ``parallel.collective_counts`` counted while the step was
    captured, as ``launches_per_step`` does for the kernels.
    """

    def __init__(self, train_step: Callable, batch_size: int, shapes: Dict[str, tuple],
                 orig_dtypes: Dict[str, torch.dtype], shard=None):
        self.train_step = train_step
        self.batch_size = batch_size
        self.shapes = shapes
        self.orig_dtypes = orig_dtypes
        self.shard = shard
        self.rows_per_step = batch_size * (shard.world if shard is not None else 1)
        self.replays = 0
        self.graph = None
        self.launches_per_step: Dict[str, int] = {}
        self.collectives_per_step: Dict[str, int] = {}
        self.scalar_keys: List[str] = []
        self.scalars = None                             # (n_steps, n_scalars)
        self.stacked: Dict[str, torch.Tensor] = {}      # the other metrics, (n_steps, ...)
        self._state = None

    def _setup(self, state: TrainState, data: Dict[str, torch.Tensor], n_steps: int):
        dev = state.step.device
        self._state, self._data, self._n = state, dict(data), n_steps
        self.idx = torch.zeros((n_steps, self.rows_per_step), dtype=torch.int64, device=dev)
        self.counter = torch.zeros((), dtype=torch.int64, device=dev)

    def _one_step(self):
        row = self.counter.view(1)
        sel = self.idx.index_select(0, row)[0]
        batch = gather_batch(self._data, sel, self.batch_size, self.shapes, self.orig_dtypes,
                             self.shard)
        _, metrics = self.train_step(self._state, batch)
        if self.scalars is None:    # the first step ever run: outside any capture
            self.scalar_keys = [k for k, v in metrics.items() if v.dim() == 0]
            self.scalars = torch.zeros((self._n, len(self.scalar_keys)), dtype=torch.float32,
                                       device=row.device)
            self.stacked = {k: torch.zeros((self._n, *v.shape), dtype=torch.float32,
                                           device=row.device)
                            for k, v in metrics.items() if v.dim() > 0}
        self.scalars.index_copy_(
            0, row, torch.stack([metrics[k].float() for k in self.scalar_keys])[None])
        for k, buf in self.stacked.items():
            buf.index_copy_(0, row, metrics[k].float()[None])
        self.counter += 1

    def _capture(self):
        """Warm up eagerly on a side stream, undo the warm-up step, capture
        one step."""
        state = self._state
        saved = [t.clone() for t in state.tensors()]
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._one_step()
        cur.wait_stream(side)
        for t, s in zip(state.tensors(), saved):
            t.copy_(s)
        self.counter.zero_()
        warm, warm_coll = ops.launch_counts(), parallel.collective_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._one_step()
        self.launches_per_step = {k: v - warm[k] for k, v in ops.launch_counts().items()}
        self.collectives_per_step = {k: v - warm_coll[k]
                                     for k, v in parallel.collective_counts().items()}

    def __call__(self, state: TrainState, data: Dict[str, torch.Tensor], idx):
        idx = torch.as_tensor(idx).to(torch.int64).reshape(-1, self.rows_per_step)
        if self._state is None:
            self._setup(state, data, idx.shape[0])
        elif (state is not self._state or idx.shape[0] != self._n
              or data.keys() != self._data.keys()
              or any(data[k] is not v for k, v in self._data.items())):
            raise ValueError("make_epoch_step: the state, the cache tensors and the number "
                             "of steps must be those of the first epoch")
        self.idx.copy_(idx)             # the epoch's one upload
        self.counter.zero_()
        if self.counter.device.type == "cuda":
            if self.graph is None:
                self._capture()
            for _ in range(self._n):
                self.graph.replay()
            self.replays += self._n
        else:
            for _ in range(self._n):
                self._one_step()
        metrics = {k: self.scalars[:, j] for j, k in enumerate(self.scalar_keys)}
        metrics.update(self.stacked)
        return state, metrics


def make_epoch_step(train_step: Callable, batch_size: int, shapes: Dict[str, tuple],
                    orig_dtypes: Dict[str, torch.dtype], shard=None) -> EpochStep:
    """A whole epoch of device-cached batches as one call (the JAX package's
    ``lax.scan`` over ``train_step``): see ``EpochStep``."""
    return EpochStep(train_step, batch_size, shapes, orig_dtypes, shard)


# the double-flip TTA's voxel sets: (key prefix, (flip x, flip y))
TTA_SETS = (("", (False, False)), *((f"{name}_", flips) for name, flips in TTA_FLIPS))


def make_eval_step(model, decode_spec, input_key: Optional[str] = "rdr_tensor",
                   sparse: bool = False,
                   preprocess: Optional[tuple] = None,
                   multi_poses: int = 0,
                   tta_double_flip: bool = False) -> Callable:
    """Forward + decode; the step returns per-task (kpts, scores, labels).

    ``sparse=True`` (single-task one_hm configs): the reg tower runs only on
    the receptive-field patch around each heatmap peak
    (``RadarPoseNet.predict_sparse``).  ``multi_poses=P`` (one_hm configs
    with ``max_poses > 1``): dense forward, local maxima and the top P
    (``core.decode.decode_pose_multi``); the step returns
    ``[(kpts (B, P, K, 3), scores (B, P))]``.

    ``tta_double_flip`` (the LiDAR detector, ``input_key`` None): the
    CenterPoint double-flip TTA (``rtpose_tpu/engine/steps.py:283-322``).
    One forward per voxel set the batch carries (the original and the
    pipeline's ``{yflip,xflip,double_flip}_*`` sets), each set's dense
    outputs unflipped, the heatmap probabilities and the regressions
    averaged, the mean probability taken back to a logit, one decode.
    """
    if tta_double_flip and input_key is None:
        @torch.inference_mode()
        def tta_step(batch):
            hms, regs = None, None
            n_sets = 0
            for prefix, (fx, fy) in TTA_SETS:
                if f"{prefix}voxels" not in batch:
                    continue
                preds = model({k: batch[f"{prefix}{k}"] for k in VOXEL_KEYS})
                n_sets += 1
                if hms is None:
                    hms, regs = [0.0] * len(preds), [0.0] * len(preds)
                for t, p in enumerate(preds):
                    hm, reg = unflip_pose_preds(p["hm"].float(), p["reg"].float(), fx, fy)
                    hms[t] = hms[t] + torch.sigmoid(hm)
                    regs[t] = regs[t] + reg
            out = []
            with trace.span("eval.decode"):
                for hm_sum, reg_sum in zip(hms, regs):
                    p = torch.clamp(hm_sum / n_sets, 1e-6, 1.0 - 1e-6)
                    logits = torch.log(p) - torch.log1p(-p)
                    out.append(decode_pose_preds(logits, reg_sum / n_sets, decode_spec))
            return out

        return tta_step

    @torch.inference_mode()
    def eval_step(batch):
        x = model_input_of(batch, input_key, preprocess)
        if multi_poses > 1:
            preds = model(x)
            with trace.span("eval.decode"):
                return [decode_pose_multi(preds[0]["hm"], preds[0]["reg"], decode_spec,
                                          max_objects=multi_poses)]
        if sparse:
            hm, reg_at_peak, peak_ind = model.predict_sparse(x)
            with trace.span("eval.decode"):
                return [decode_pose_sparse(hm, reg_at_peak, peak_ind, decode_spec)]
        preds = model(x)
        with trace.span("eval.decode"):
            return model.pose_head.predict(preds, decode_spec)

    return eval_step
