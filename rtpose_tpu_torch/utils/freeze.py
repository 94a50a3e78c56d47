"""Parameter freezing (the reference's ``PoseNet.freeze`` /
``FrozenBatchNorm`` capability).

Counterpart of ``rtpose_tpu/utils/freeze.py``, which routes the updates of
frozen subtrees to zero through ``optax.multi_transform``.  Here a frozen
tensor is kept out of the optimizer altogether and its ``requires_grad`` is
cleared: with decoupled weight decay (AdamW) a tensor that stays in a param
group moves even with no gradient, so ``requires_grad=False`` alone would
not keep it bit-equal.

Matching rule (the JAX package's): a tensor is frozen when any of the given
strings appears anywhere in its '/'-joined path, a substring and not a
prefix match.  The port's dotted names (``teacher.backbone.final_conv.
weight``) are joined with '/' (``teacher/backbone/final_conv/weight``)
before the match.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch


def _named(named_params) -> Iterable[Tuple[str, torch.Tensor]]:
    if isinstance(named_params, torch.nn.Module):
        return named_params.named_parameters()
    if isinstance(named_params, dict):
        return named_params.items()
    return named_params


def freeze_mask(named_params, frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """{dotted name: trainable} for a module, a {name: tensor} dict or an
    iterable of (name, tensor) pairs: False where any of
    ``frozen_prefixes`` appears in the name's '/'-joined path."""
    return {name: not any(pref in name.replace(".", "/") for pref in frozen_prefixes)
            for name, _ in _named(named_params)}


def split_frozen(optimizer_factory: Callable[[list], torch.optim.Optimizer],
                 model: torch.nn.Module,
                 frozen_prefixes: Sequence[str]) -> torch.optim.Optimizer:
    """The optimizer ``optimizer_factory(trainable_params)`` over the
    trainable parameters only; the frozen ones get ``requires_grad=False``
    and are in no param group, so a step leaves them bit-equal."""
    mask = freeze_mask(model, frozen_prefixes)
    trainable = []
    for name, p in model.named_parameters():
        if mask[name]:
            trainable.append(p)
        else:
            p.requires_grad_(False)
    return optimizer_factory(trainable)
