"""Batch loader: epoch-seeded shuffles, aspect-group batching, prefetch.

Counterpart of ``rtpose_tpu/data/loader.py:21-209`` (``BatchLoader``,
reference ``det3d/datasets/loader/`` DataLoader + DistributedGroupSampler):

* the index order is the JAX loader's, bit for bit: ``group_shard_indices``
  when shuffling a dataset that carries a ``flag`` array (per-group
  epoch-seeded permutation, wrap-around padding to whole batches, the
  cross-group batch shuffle only with more than one group), else
  ``shard_indices`` (epoch-seeded permutation, tail dropped or padded);
  ``set_epoch`` reseeds it (the seed is ``seed + epoch``);
* every array key is stacked on a new leading axis, per-task list keys
  (``LIST_KEYS``) element-wise, 'meta' becomes a list; the final short
  batch of an unshuffled (eval) epoch is padded by repeating its last
  sample, with ``valid`` carrying the real count;
* ``num_workers`` threads load a batch's samples in parallel
  (``workers_per_gpu``); ``prefetch`` batches are assembled ahead on a
  background thread.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def group_shard_indices(flags, batch_size: int, epoch: int, shuffle: bool,
                        num_shards: int, shard_id: int) -> np.ndarray:
    """Flag-homogeneous batches (GroupSampler / DistributedGroupSampler
    parity): within each flag group an epoch-seeded shuffle, padded by
    wrap-around to a multiple of ``batch_size * num_shards``; the groups
    concatenated, whole batches shuffled (only with several groups), then
    each shard's contiguous slice."""
    flags = np.asarray(flags)
    rng = np.random.default_rng(epoch)
    groups = np.unique(flags)
    per = batch_size * num_shards
    chunks = []
    for f in groups:
        idx = np.flatnonzero(flags == f)
        if shuffle:
            idx = rng.permutation(idx)
        extra = (-len(idx)) % per
        if extra:
            idx = np.resize(idx, len(idx) + extra)
        chunks.append(idx)
    batches = np.concatenate(chunks).reshape(-1, batch_size)
    if shuffle and len(groups) > 1:
        batches = batches[rng.permutation(len(batches))]
    indices = batches.reshape(-1)
    num_samples = len(indices) // num_shards
    return indices[shard_id * num_samples: (shard_id + 1) * num_samples]


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
    """Iterates dict-of-numpy batches over a map-style dataset."""

    LIST_KEYS = ("hm", "ind", "mask", "cat", "anno_pose")

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: Optional[bool] = None, num_shards: int = 1,
                 shard_id: int = 0, prefetch: int = 2, seed: int = 0,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers

    def set_epoch(self, epoch: int) -> None:
        """DistSamplerSeedHook parity (hooks/sampler_seed.py:4-6)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        flags = getattr(self.dataset, "flag", None)
        if flags is not None and self.shuffle:
            return group_shard_indices(flags, self.batch_size, self.seed + self.epoch,
                                       self.shuffle, self.num_shards, self.shard_id)
        return shard_indices(len(self.dataset), self.seed + self.epoch, self.shuffle,
                             self.num_shards, self.shard_id, self.drop_last)

    def __len__(self):
        per_shard = len(self._indices())
        if self.drop_last:
            return per_shard // self.batch_size
        return (per_shard + self.batch_size - 1) // self.batch_size

    def _collate(self, items: List[dict], valid: int) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        for k, v in items[0].items():
            if k == "meta":
                batch["meta"] = [it["meta"] for it in items]
            elif k in self.LIST_KEYS:
                batch[k] = [np.stack([it[k][t] for it in items]) for t in range(len(v))]
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
            sel = idx[b * bs: (b + 1) * bs]
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
            if self.prefetch <= 0:
                yield from self._batches(pool)
            else:
                yield from self._prefetched(pool)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)

    def _prefetched(self, pool) -> Iterator[Dict[str, Any]]:
        """Batches assembled ``prefetch`` ahead on a background thread; a
        consumer that stops early stops the thread."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()
        err: List[Exception] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._batches(pool):
                    if not put(batch):
                        return
            except Exception as e:  # handed to the consumer, which re-raises it
                err.append(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            t.join()
