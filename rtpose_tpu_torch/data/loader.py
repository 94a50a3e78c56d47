"""Batch loaders: epoch-seeded shuffles, aspect-group batching, prefetch,
and the two loaders that keep the dataset on the device.

Counterpart of ``rtpose_tpu/data/loader.py`` (reference
``det3d/datasets/loader/`` DataLoader + DistributedGroupSampler).
``BatchLoader`` assembles numpy batches on the host:

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

``DeviceCachedLoader`` uploads every sample once and builds each batch with
a gather on the device (same index stream as ``BatchLoader``);
``StreamingDeviceLoader`` does the same one chunk at a time for datasets
larger than the device's memory, uploading the next chunk behind the
resident one's training.  Both yield batches of device tensors
(``device_resident``), optionally stored compressed (``cache_dtype``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..parallel import RowShard


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
    # fused-epoch training needs the whole dataset on the device; batches
    # here are numpy arrays on the host
    supports_fused_epochs = False
    device_resident = False

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


_COMPRESS_MIN_BYTES = 1024
# float8_e4m3fn: values above this round to the NaN encoding in the JAX
# package's cast (the tie between 448, the largest finite value, and the NaN
# encoding's 480 rounds to even, 448); torch's own cast saturates to 448
_F8_E4M3_OVERFLOW = 464.0


def cache_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in a cache dtype, rounded as the JAX package's cache rounds it
    (round to nearest even; float8_e4m3fn overflows to NaN, not to 448)."""
    if dtype == torch.float8_e4m3fn:
        x = x.float()
        x = torch.where(x.abs() > _F8_E4M3_OVERFLOW, float("nan"), x)
    return x.to(dtype)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from its name ('bfloat16', 'float8_e4m3fn'), a numpy
    dtype or itself."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None), torch.dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _numeric_spec(first: dict, cache_dtype):
    """Numeric-array spec of one sample: (keys, shapes, cache dtypes,
    original dtypes of compressed keys), dtypes as torch dtypes.  Shared by
    the device-resident loaders.

    ``cache_dtype`` compresses only float keys that are large (>= 1 KB per
    sample: the radar cubes) and that the cast shrinks (f32 -> bf16 yes,
    f16 -> bf16 no).  The pose labels always keep their dtype: a bf16
    quantum at 5-8 m world coordinates is 3-6 cm of label noise."""
    keys, shapes, dtypes, orig = [], {}, {}, {}
    cd = None if cache_dtype is None else _torch_dtype(cache_dtype)
    if cd is not None and not cd.is_floating_point:
        raise ValueError(f"cache_dtype must be a float dtype, got {cache_dtype!r}")
    for k, v in first.items():
        if k == "meta" or k in BatchLoader.LIST_KEYS:
            continue
        a = np.asarray(v)
        if not np.issubdtype(a.dtype, np.number):
            continue
        dt = _torch_dtype(a.dtype)
        if (cd is not None and dt.is_floating_point and cd.itemsize < dt.itemsize
                and a.nbytes >= _COMPRESS_MIN_BYTES):
            orig[k] = dt
            dt = cd
        keys.append(k)
        shapes[k] = a.shape
        dtypes[k] = dt
    if "poses" not in keys or "num_poses" not in keys:
        raise ValueError(
            "device-resident loaders require 'poses'/'num_poses' in dataset "
            "items (on-device target assignment); precomputed host targets "
            "(hm/ind/mask/...) are not cached — use BatchLoader")
    return keys, shapes, dtypes, orig


def _row_width(shape) -> int:
    return max(1, int(np.prod(shape)))


def _fill_rows(dataset, indices, keys, shapes, dtypes, pin: bool, first=None):
    """Host rows of ``dataset[i]`` for i in ``indices``: per key one
    (len(indices), K) tensor of the cache dtype (pinned for an upload), filled
    one sample at a time, so the host holds the cache's size and never the
    float32 dataset; and the samples' metas."""
    rows = {k: torch.empty((len(indices), _row_width(shapes[k])), dtype=dtypes[k],
                           pin_memory=pin) for k in keys}
    metas = []
    for j, i in enumerate(indices):
        it = first if (first is not None and j == 0) else dataset[int(i)]
        for k in keys:
            a = torch.from_numpy(np.ascontiguousarray(it[k]).reshape(-1))
            rows[k][j].copy_(cache_cast(a, dtypes[k]))
        metas.append(it.get("meta"))
    return rows, metas


def gather_batch(data: Dict[str, torch.Tensor], sel: torch.Tensor, bs: int,
                 shapes: Dict[str, tuple], orig_dtype: Dict[str, torch.dtype],
                 shard=None) -> Dict[str, torch.Tensor]:
    """A batch gathered on the device from (N, K)-stored cache rows:
    ``index_select`` by the (bs,) int64 ``sel``, compressed keys cast back,
    each key in its sample shape.  One-byte float rows are gathered as
    bytes (``index_select`` takes no float8 tensor on every device).
    With ``shard`` (a ``parallel.RowShard``) ``data`` holds this rank's rows
    of a cache split over the ranks, ``sel`` every rank's batch back to back
    (global row indices), and the shard's exchange returns this rank's."""
    rows = shard.exchange(data, sel) if shard is not None else None
    batch = {}
    for k, v in data.items():
        if rows is not None:
            g = rows[k]
        elif v.dtype.is_floating_point and v.dtype.itemsize == 1:
            g = v.view(torch.uint8).index_select(0, sel).view(v.dtype)
        else:
            g = v.index_select(0, sel)
        if k in orig_dtype:
            g = g.to(orig_dtype[k])
        batch[k] = g.reshape(bs, *shapes[k])
    return batch


class DeviceCachedLoader:
    """Device-resident dataset: every sample's arrays are uploaded once, and
    each batch is a gather on the device, so the training loop moves no
    sample from the host.  Gate by size (``max_bytes``): the cache must fit
    beside parameters and activations.

    Interface-compatible with ``BatchLoader`` on the training path
    (``set_epoch`` / ``len`` / iteration; the same epoch-seeded index stream,
    ``group_shard_indices`` for a dataset with a ``flag`` array, else
    ``shard_indices``); batches carry tensors on ``device`` plus the 'meta'
    list and the 'valid' count.  Rows are stored (N, K), which the fused
    epoch gathers (``data`` and ``fused_epoch()`` feed
    ``engine.steps.make_epoch_step``).  Precomputed host targets
    (``LIST_KEYS``) are not cached: device-cached training assigns targets
    on the device from the raw poses.

    ``shard_cache`` (``--cache_shard``): shard ``shard_id`` of ``num_shards``
    (the process's rank) reads and holds only its block of rows
    (``parallel.RowShard``), so the set a job can cache grows with the
    ranks; ``max_bytes`` caps those rows.  Each batch is then built by the
    shard's exchange (a collective that every rank runs in step) and equals
    the replicated cache's bit for bit; it carries no 'meta' (a rank holds
    the metas of its own rows only).  ``fused_epoch`` gives every rank's
    batches of a step back to back.
    """

    supports_fused_epochs = True
    device_resident = True

    def __init__(self, dataset, batch_size: int, *, device: torch.device,
                 shuffle: bool = True, drop_last: Optional[bool] = None,
                 num_shards: int = 1, shard_id: int = 0, seed: int = 0,
                 max_bytes: Optional[int] = None, cache_dtype=None,
                 shard_cache: bool = False):
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self.epoch = 0
        # aspect-group flags taken at build time (the dataset is not kept)
        flags = getattr(dataset, "flag", None)
        self._flags = None if flags is None else np.asarray(flags)

        n_items = len(dataset)
        self.shard = RowShard(n_items, shard_id, num_shards) if shard_cache else None
        lo, hi = (self.shard.lo, self.shard.hi) if shard_cache else (0, n_items)
        first = dataset[lo]
        keys, shapes, dtypes, self._orig_dtype = _numeric_spec(first, cache_dtype)
        self._shapes = shapes
        total = sum((hi - lo) * _row_width(shapes[k]) * dtypes[k].itemsize for k in keys)
        if max_bytes is not None and total > max_bytes:
            raise ValueError(
                f"DeviceCachedLoader: dataset needs {total / 1e9:.2f} GB on "
                f"device, over the {max_bytes / 1e9:.2f} GB cap — use "
                "BatchLoader for datasets that do not fit on the device")
        cuda = self.device.type == "cuda"
        rows, self.metas = _fill_rows(dataset, range(lo, hi), keys, shapes, dtypes,
                                      pin=cuda, first=first)
        self.nbytes = total
        self.n = n_items
        self.data = {k: v.to(self.device) for k, v in rows.items()}

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self, shard_id: Optional[int] = None) -> np.ndarray:
        shard_id = self.shard_id if shard_id is None else shard_id
        if self._flags is not None and self.shuffle:
            return group_shard_indices(self._flags, self.batch_size, self.seed + self.epoch,
                                       self.shuffle, self.num_shards, shard_id)
        return shard_indices(self.n, self.seed + self.epoch, self.shuffle,
                             self.num_shards, shard_id, self.drop_last)

    def _step_indices(self, n_batches: int) -> np.ndarray:
        """(n_batches, rows a step): this shard's padded indices, or with a
        sharded cache every shard's batches of a step back to back."""
        bs = self.batch_size
        shards = range(self.num_shards) if self.shard is not None else (self.shard_id,)
        per = []
        for r in shards:
            idx = self._indices(r)
            pad = n_batches * bs - len(idx)
            if pad > 0:      # final short eval batch: repeat the last sample
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            else:            # drop_last: the trailing remainder is not used
                idx = idx[: n_batches * bs]
            per.append(idx.reshape(n_batches, bs))
        return np.concatenate(per, axis=1)

    def _num_batches(self, per_shard: int) -> int:
        if self.drop_last and not (self._flags is not None and self.shuffle):
            return per_shard // self.batch_size
        return (per_shard + self.batch_size - 1) // self.batch_size

    def __len__(self):
        return self._num_batches(len(self._indices()))

    def fused_epoch(self):
        """What ``make_epoch_step`` takes for this epoch besides ``data``:
        ``(idx, shapes, orig_dtypes)``, the epoch's ``len(self) * batch_size``
        sample indices, each key's sample shape and the original dtype of each
        compressed key.  ``idx`` is None where the index stream does not fill
        ``len(self)`` whole batches (a fused epoch pads nothing)."""
        idx = self._indices()
        n_batches = self._num_batches(len(idx))
        if len(idx) < n_batches * self.batch_size:
            return None, self._shapes, self._orig_dtype
        return self._step_indices(n_batches).reshape(-1), self._shapes, self._orig_dtype

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self._indices()
        bs = self.batch_size
        n_batches = self._num_batches(len(idx))
        # the padded permutation goes up once per epoch; each batch is then
        # work queued on the device only
        steps = self._step_indices(n_batches)
        idx_dev = torch.from_numpy(steps.astype(np.int64)).to(self.device)
        for b in range(n_batches):
            batch: Dict[str, Any] = gather_batch(self.data, idx_dev[b], bs, self._shapes,
                                                 self._orig_dtype, self.shard)
            if self.shard is None:
                batch["meta"] = [self.metas[int(i)] for i in steps[b]]
            batch["valid"] = np.int32(min(bs, len(idx) - b * bs))
            yield batch


class StreamingDeviceLoader:
    """Device-resident batches for datasets larger than the device's memory.

    The sample space is split (by a construction-seeded permutation) into
    chunks whose rows fit a ``chunk_bytes`` budget.  Each epoch visits the
    chunks in an epoch-seeded random order; while the device trains on the
    resident chunk (the same gather as ``DeviceCachedLoader``), a background
    thread decodes the next chunk into pinned memory and uploads it on a
    side stream, so at most two chunks are resident (``max_resident``
    records the most seen) and the host path overlaps the device's work.

    The shuffle is a block shuffle (the construction-seeded permutation
    assigns samples to chunks; each epoch reshuffles the chunk order and the
    order within each chunk, seeded ``seed + epoch + 1``), not the global
    permutation of the other loaders; every sample is still visited once
    per epoch.  With ``shuffle=False`` samples stay in dataset order, so a
    single chunk equals ``DeviceCachedLoader`` unshuffled.

    Sharding: the global index list is padded to a multiple of
    ``num_shards`` before slicing (like ``shard_indices``), so every shard
    runs the same number of steps.  The shard's list is padded by repeats to
    a multiple of ``batch_size``; ``valid`` carries each batch's count of
    real samples (a contiguous prefix only when unshuffled).
    """

    supports_fused_epochs = False   # only one chunk is resident at a time
    device_resident = True

    def __init__(self, dataset, batch_size: int, chunk_bytes: int, *,
                 device: torch.device, shuffle: bool = True, seed: int = 0,
                 cache_dtype=None, num_shards: int = 1, shard_id: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_shards = num_shards
        self.shard_id = shard_id

        self._keys, self._shapes, self._dtypes, self._orig_dtype = \
            _numeric_spec(dataset[0], cache_dtype)
        per_sample = sum(_row_width(self._shapes[k]) * self._dtypes[k].itemsize
                         for k in self._keys)
        n_total = len(dataset)
        order = (np.random.default_rng(seed).permutation(n_total)
                 if shuffle else np.arange(n_total))   # mixes samples across chunks
        pad_sh = (-n_total) % num_shards
        if pad_sh:
            order = np.concatenate([order, order[:pad_sh]])
        mine = order[shard_id::num_shards]
        per_chunk = max(batch_size,
                        (chunk_bytes // max(per_sample, 1)) // batch_size * batch_size)
        self._n_real = len(mine)
        pad = (-len(mine)) % batch_size
        if pad:            # repeats; positions >= _n_real are padding
            mine = np.concatenate([mine, np.repeat(mine[-1:], pad)])
        self._chunk_start = list(range(0, len(mine), per_chunk))
        self.chunks = [mine[i:i + per_chunk] for i in self._chunk_start]
        self.n = len(mine)                            # padded count
        self.samples_per_chunk = per_chunk
        self.chunk_nbytes = per_chunk * per_sample
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        self._resident = 0
        self.max_resident = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return self.n // self.batch_size

    def _count_resident(self, delta: int) -> None:
        with self._lock:
            self._resident += delta
            self.max_resident = max(self.max_resident, self._resident)

    def _load_chunk(self, idx: np.ndarray, after):
        """Decode one chunk into pinned rows and upload it (on the prefetch
        thread).  ``after`` is the event behind the last step of the chunk
        whose place this one takes: the upload waits for it, so the device
        never holds a third chunk.  Returns (rows on the device, metas, the
        upload's event)."""
        cuda = self._copy_stream is not None
        rows, metas = _fill_rows(self.dataset, idx, self._keys, self._shapes,
                                 self._dtypes, pin=cuda)
        if not cuda:
            self._count_resident(+1)
            return rows, metas, None
        if after is not None:
            after.synchronize()
        self._count_resident(+1)
        with torch.cuda.stream(self._copy_stream):
            dev = {k: v.to(self.device, non_blocking=True) for k, v in rows.items()}
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, metas, ready

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed + self.epoch + 1)
        order = (rng.permutation(len(self.chunks)) if self.shuffle
                 else np.arange(len(self.chunks)))
        bs = self.batch_size
        cuda = self._copy_stream is not None
        data = done = None
        with self._lock:
            self._resident = 0      # an abandoned epoch left nothing behind
        with ThreadPoolExecutor(max_workers=1) as pool:
            nxt = pool.submit(self._load_chunk, self.chunks[order[0]], None)
            for ci, chunk_id in enumerate(order):
                if data is not None:    # the chunk before: its last step is queued
                    data = None
                    self._count_resident(-1)
                data, metas, ready = nxt.result()     # re-raises a loader error
                if cuda:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ready)
                    for v in data.values():
                        v.record_stream(cur)
                if ci + 1 < len(order):   # the next upload overlaps this chunk's steps
                    nxt = pool.submit(self._load_chunk, self.chunks[order[ci + 1]], done)
                m = len(self.chunks[chunk_id])
                within = rng.permutation(m) if self.shuffle else np.arange(m)
                within_dev = torch.from_numpy(within.astype(np.int64)).to(self.device)
                real = (self._chunk_start[chunk_id] + within) < self._n_real
                for b in range(m // bs):
                    sel = within[b * bs:(b + 1) * bs]
                    batch: Dict[str, Any] = gather_batch(
                        data, within_dev[b * bs:(b + 1) * bs], bs, self._shapes,
                        self._orig_dtype)
                    batch["meta"] = [metas[int(i)] for i in sel]
                    batch["valid"] = np.int32(real[b * bs:(b + 1) * bs].sum())
                    yield batch
                if cuda:    # resumed after the chunk's last step was queued
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
            self._count_resident(-1)
