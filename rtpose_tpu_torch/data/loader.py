"""Eval batch loader: sequential order, tail padding, parallel sample loads.

Counterpart of the eval side of ``rtpose_tpu/data/loader.py::BatchLoader``:
the same ``shard_indices`` order, every array key stacked on a new leading
axis, 'meta' as a list, and the final short batch padded by repeating its
last sample with ``valid`` carrying the real count (fixed shapes).  The
eval loop's prefetch thread (``engine.evaluator.device_prefetch``) runs the
loader ahead of the card; ``num_workers`` threads load a batch's samples in
parallel (``workers_per_gpu``).  The training order (shuffles,
aspect-group sampling) waits for the training slice of the port.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List

import numpy as np


def shard_indices(n: int, epoch: int, shuffle: bool, num_shards: int,
                  shard_id: int, drop_last: bool) -> np.ndarray:
    """Epoch-seeded global permutation, padded to a multiple of num_shards,
    sliced per shard (DistributedGroupSampler parity)."""
    if shuffle:
        order = np.random.default_rng(epoch).permutation(n)
    else:
        order = np.arange(n)
    if drop_last:
        order = order[:(n // num_shards) * num_shards]
    else:
        pad = (-len(order)) % num_shards
        if pad:
            order = np.concatenate([order, order[:pad]])
    return order[shard_id::num_shards]


class BatchLoader:
    """Iterates dict-of-numpy eval batches over a map-style dataset (one
    process: a single shard)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers

    def _indices(self) -> np.ndarray:
        return shard_indices(len(self.dataset), 0, False, 1, 0, drop_last=False)

    def __len__(self):
        return (len(self._indices()) + self.batch_size - 1) // self.batch_size

    @staticmethod
    def _collate(items: List[dict], valid: int) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        for k, v in items[0].items():
            if k == "meta":
                batch["meta"] = [it["meta"] for it in items]
            elif (isinstance(v, np.ndarray) or np.isscalar(v)) \
                    and np.issubdtype(np.asarray(v).dtype, np.number):
                batch[k] = np.stack([np.asarray(it[k]) for it in items])
            # non-numeric keys (e.g. 'mode') stay off the device batch
        batch["valid"] = np.int32(valid)
        return batch

    def _batches(self, pool) -> Iterator[Dict[str, Any]]:
        idx = self._indices()
        bs = self.batch_size
        for b in range(len(self)):
            sel = idx[b * bs : (b + 1) * bs]
            valid = len(sel)
            if valid < bs:  # pad the final eval batch to a fixed shape
                sel = np.concatenate([sel, np.repeat(sel[-1:], bs - valid)])
            if pool is not None:
                items = list(pool.map(self.dataset.__getitem__, [int(i) for i in sel]))
            else:
                items = [self.dataset[int(i)] for i in sel]
            yield self._collate(items, valid)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        pool = (ThreadPoolExecutor(max_workers=self.num_workers)
                if self.num_workers > 1 else None)
        try:
            yield from self._batches(pool)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
