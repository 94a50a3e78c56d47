"""Dataset wrappers: concatenation and repetition of map-style datasets.

Counterpart of ``rtpose_tpu/data/wrappers.py`` (reference
``det3d/datasets/dataset_wrappers.py:7-60``).  Both are flag-aware: the
aspect-group ``flag`` arrays of the children concatenate (``ConcatDataset``)
or tile (``RepeatDataset``), so a shuffled loader batches them through
``group_shard_indices`` in the JAX loader's order.  The keys that
``api.build_dataset_from_cfg`` adds (``split``, ``max_poses``,
``group_by_frame``, ``device_preprocess``) merge into every child
config, and attributes the wrapper lacks (the normalization window,
``evaluation``) come from the first child.
"""

from __future__ import annotations

import bisect

import numpy as np

from ..registry import DATASETS


def _build(cfg, common: dict):
    from .builder import build_dataset
    return build_dataset({**cfg, **common}) if isinstance(cfg, dict) else cfg


class _Delegating:
    """Attribute lookups the wrapper cannot answer go to its first child."""

    def _first(self):
        raise NotImplementedError

    def __getattr__(self, name):
        # private names (copy / pickle probes, attributes not set yet) are
        # the wrapper's own: delegating them would recurse
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._first(), name)


@DATASETS.register_module
class ConcatDataset(_Delegating):
    def __init__(self, datasets, **common):
        """``datasets``: dataset objects or config dicts."""
        self.datasets = [_build(d, common) for d in datasets]
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()
        # None when any child lacks flags, so lookups never fall through to
        # the first child's (wrong-length) array
        flags = [getattr(d, "flag", None) for d in self.datasets]
        self.flag = (np.concatenate(flags)
                     if all(f is not None for f in flags) else None)

    def _first(self):
        return self.__dict__["datasets"][0]

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        if ds_idx > 0:
            idx = idx - self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx]


@DATASETS.register_module
class RepeatDataset(_Delegating):
    def __init__(self, dataset, times, **common):
        self.dataset = _build(dataset, common)
        self.times = times
        self._ori_len = len(self.dataset)
        child_flag = getattr(self.dataset, "flag", None)
        self.flag = np.tile(child_flag, times) if child_flag is not None else None

    def _first(self):
        return self.__dict__["dataset"]

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def __len__(self):
        return self.times * self._ori_len
