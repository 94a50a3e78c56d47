"""Training checkpoints with the reference's save / resume contract.

Counterpart of ``rtpose_tpu/engine/checkpoint.py`` (reference
``det3d/torchie/trainer/checkpoint.py`` and ``trainer.py:354-368,
494-509``), in the reference's own file format: ``epoch_<N>.pth`` under
``work_dir/checkpoints`` holding ``{"meta", "state_dict", "optimizer"}``
(``meta`` carries ``epoch`` and the global ``step``), and a ``latest`` file
naming the newest one.  ``tools.test`` and
``rtpose_tpu/engine/torch_import.py`` read these files as they are.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from .. import parallel
from .convert import load_checkpoint, save_checkpoint as save_pth

LATEST = "latest"


def checkpoint_dir(work_dir: str) -> str:
    return os.path.join(os.path.abspath(work_dir), "checkpoints")


def save_training_checkpoint(work_dir: str, model: torch.nn.Module, optimizer,
                             epoch: int, step: int, meta: Optional[dict] = None) -> str:
    """Write ``epoch_<epoch>.pth`` and point ``latest`` at it; returns its
    path.  Under a process group only rank 0 writes (the ranks hold the
    same state), and every rank returns after the write (a barrier)."""
    base = checkpoint_dir(work_dir)
    name = f"epoch_{epoch}.pth"
    path = os.path.join(base, name)
    if parallel.process_index() == 0:
        os.makedirs(base, exist_ok=True)
        tmp = f"{path}.tmp"
        save_pth(tmp, model.state_dict(), meta=dict(meta or {}, epoch=epoch, step=step),
                 optimizer=optimizer.state_dict())
        os.replace(tmp, path)
        with open(os.path.join(base, LATEST), "w") as f:
            f.write(name)
    parallel.barrier()
    return path


def resolve_checkpoint(path: str) -> str:
    """A ``.pth`` file as given; a directory holding ``latest`` (or a
    work_dir whose ``checkpoints/`` does) -> the file it names."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        return path
    for base in (path, checkpoint_dir(path)):
        latest = os.path.join(base, LATEST)
        if os.path.isfile(latest):
            with open(latest) as f:
                return os.path.join(base, f.read().strip())
    raise FileNotFoundError(f"no checkpoint at {path}")


def load_training_checkpoint(path: str) -> Dict[str, Any]:
    """The ``{"meta", "state_dict", "optimizer"}`` record at ``path``
    (resolved as ``resolve_checkpoint`` does)."""
    ckpt = load_checkpoint(resolve_checkpoint(path))
    if "optimizer" not in ckpt:
        raise ValueError(f"{path}: holds no optimizer state to resume from")
    return ckpt
