"""Dataset builder.

Counterpart of ``rtpose_tpu/data/builder.py`` (reference
``det3d/datasets/builder.py``): a config's dataset ``type`` resolves through
:mod:`.factory`, so it may name a registry key (``CRUW_POSE_Dataset``) or a
short factory name (``CRUW_POSE``, ``CRUW_POSE_LIDAR``, ...).
"""

from __future__ import annotations

from ..registry import DATASETS, build_from_cfg
from .factory import get_dataset


def build_dataset(cfg: dict, default_args: dict | None = None):
    cfg = dict(cfg)
    if isinstance(cfg.get("type"), str):
        cfg["type"] = get_dataset(cfg["type"])
    return build_from_cfg(cfg, DATASETS, default_args)
