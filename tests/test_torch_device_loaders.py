"""The port's device-resident loaders (``DeviceCachedLoader``,
``StreamingDeviceLoader``) against rtpose_tpu's, on the CPU, over the same
synthetic root (a dozen frames from the port's generator) and the same
in-memory datasets.

Tolerances: none.  The index streams are the same numpy code, an
uncompressed cache only moves bytes, and a compressed cache is the same
round-to-nearest-even cast in both libraries (float8_e4m3fn overflows to NaN
above 464 in the JAX package, and the port follows it), so every comparison
here is exact (NaN equal to NaN).
"""

import os
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rtpose_tpu.api import build_dataset_from_cfg as jax_dataset
from rtpose_tpu.config import Config as JaxConfig
from rtpose_tpu.data import DeviceCachedLoader as JaxCached
from rtpose_tpu.data import StreamingDeviceLoader as JaxStreaming
from rtpose_tpu.data.loader import _numeric_spec as jax_numeric_spec

from rtpose_tpu_torch.api import build_dataset_from_cfg
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.data import (BatchLoader, DeviceCachedLoader, StreamingDeviceLoader,
                                   generate_synthetic_dataset)
from rtpose_tpu_torch.data.loader import _numeric_spec, cache_cast, gather_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}  # -> grid (8, 16, 32)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(JAX dataset, port dataset) over one synthetic root of 11 train frames."""
    root = str(tmp_path_factory.mktemp("loader_data"))
    generate_synthetic_dataset(
        root, num_seqs=1, frames_per_seq=11, test_frames_per_seq=1, rdr_type="zyx_real",
        seed=7, pelvis_range={"x": (1.0, 2.0), "y": (-1.0, 1.0), "z": (-0.5, 1.2)},
        offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7))
    src = open(os.path.join(REPO, "tests", "test_e2e_cli.py")).read()
    tpl = re.search(r"CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1)
    cfg_path = str(tmp_path_factory.mktemp("loader_cfg") / "tiny.py")
    with open(cfg_path, "w") as f:
        f.write(tpl.format(root=root, roi=TINY_ROI))
    return (jax_dataset(JaxConfig.fromfile(cfg_path).data, "train", max_poses=1),
            build_dataset_from_cfg(Config.fromfile(cfg_path).data, "train"))


class MemoryDS:
    """In-memory items; ``scale`` spreads the cube's values (beyond float8's
    range at 300), ``fail_at`` raises at that index."""

    def __init__(self, n=16, scale=1.0, flag=None, fail_at=None):
        self.n, self.scale, self.fail_at = n, scale, fail_at
        if flag is not None:
            self.flag = np.asarray(flag)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise OSError(f"cannot read sample {i}")
        r = np.random.default_rng(77 + i)
        return {"meta": {"i": i},
                "rdr_tensor": (r.normal(size=(4, 6, 8, 4)) * self.scale).astype(np.float32),
                "poses": r.normal(size=(1, 15, 3)).astype(np.float32),
                "num_poses": np.int32(1), "mode": "train"}


def _same_batches(jax_loader, port_loader, epochs=(0, 1)):
    """Both loaders yield the same epochs: length, order, every array bit for
    bit (dtype included), meta and valid."""
    assert len(jax_loader) == len(port_loader)
    for epoch in epochs:
        jax_loader.set_epoch(epoch)
        port_loader.set_epoch(epoch)
        jb, pb = list(jax_loader), list(port_loader)
        assert len(jb) == len(pb) == len(port_loader)
        for j, p in zip(jb, pb):
            assert sorted(j) == sorted(p)
            assert j["meta"] == p["meta"] and int(j["valid"]) == int(p["valid"])
            for k in j:
                if k in ("meta", "valid"):
                    continue
                want = np.asarray(j[k])
                assert isinstance(p[k], torch.Tensor)
                got = p[k].numpy()
                assert got.dtype == want.dtype and got.shape == want.shape, k
                np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_cached_loader_matches_jax_on_synthetic_root(datasets, num_shards, shuffle):
    jds, pds = datasets
    for shard_id in range(num_shards):
        kw = dict(batch_size=3, shuffle=shuffle, seed=5, num_shards=num_shards,
                  shard_id=shard_id)
        jl = JaxCached(jds, **kw)
        pl = DeviceCachedLoader(pds, device=CPU, **kw)
        assert pl.nbytes == jl.nbytes > 0 and pl.n == jl.n == 11
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            np.testing.assert_array_equal(pl._indices(), jl._indices())
        _same_batches(jl, pl)


def test_fused_epoch_gives_whole_batches_or_none(datasets):
    """``fused_epoch()``: the epoch's first ``len * batch_size`` indices with
    the shapes and original dtypes ``gather_batch`` takes; no indices where the
    stream does not fill whole batches (unshuffled, remainder kept)."""
    _, pds = datasets
    pl = DeviceCachedLoader(pds, batch_size=3, device=CPU, shuffle=True, seed=5,
                            cache_dtype="bfloat16")
    pl.set_epoch(1)
    idx, shapes, orig = pl.fused_epoch()
    np.testing.assert_array_equal(idx, pl._indices()[:len(pl) * 3])
    assert len(idx) == len(pl) * 3 == 12
    assert set(shapes) == set(pl.data) and orig == {"rdr_tensor": torch.float32}
    first = next(iter(pl))
    again = gather_batch(pl.data, torch.from_numpy(idx[:3].astype(np.int64)), 3, shapes, orig)
    for k, v in again.items():
        assert torch.equal(v, first[k]), k
    ragged = DeviceCachedLoader(pds, batch_size=3, device=CPU, shuffle=False, drop_last=False)
    assert len(ragged) == 4 and ragged.fused_epoch()[0] is None
    dropped = DeviceCachedLoader(pds, batch_size=3, device=CPU, shuffle=False, drop_last=True)
    assert len(dropped) == 3 and len(dropped.fused_epoch()[0]) == 9


def test_cached_loader_matches_the_ports_batch_loader(datasets):
    """The same epochs as the host loader: order, arrays, meta, valid."""
    _, pds = datasets
    host = BatchLoader(pds, batch_size=3, shuffle=True, seed=5)
    dev = DeviceCachedLoader(pds, batch_size=3, device=CPU, shuffle=True, seed=5)
    assert len(host) == len(dev) == 4       # 11 samples wrap-pad to 4 full batches
    for epoch in (0, 1):
        host.set_epoch(epoch)
        dev.set_epoch(epoch)
        for h, d in zip(list(host), list(dev)):
            assert d["meta"] == h["meta"] and d["valid"] == h["valid"]
            for k in ("rdr_tensor", "poses", "num_poses"):
                np.testing.assert_array_equal(d[k].numpy(), h[k])


@pytest.mark.parametrize("flag,shuffle,drop_last", [
    (None, True, None), (None, False, None), (None, False, True),
    ([0] * 7 + [1] * 4, True, None), ([0] * 7 + [1] * 4, True, False),
    ([0] * 7 + [1] * 4, False, None)])
def test_cached_loader_len_and_order_with_flags(flag, shuffle, drop_last):
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=2)
    jl = JaxCached(MemoryDS(11, flag=flag), **kw)
    pl = DeviceCachedLoader(MemoryDS(11, flag=flag), device=CPU, **kw)
    _same_batches(jl, pl)


@pytest.mark.parametrize("cache_dtype,scale", [("bfloat16", 1.0), ("float8_e4m3fn", 1.0),
                                               ("float8_e4m3fn", 300.0)])
def test_compressed_cache_equals_the_jax_cast(cache_dtype, scale):
    """Compressed rows come back as the JAX cache's: the cube cast through
    the cache dtype (NaN above float8's range), labels untouched."""
    ds = MemoryDS(16, scale=scale)
    jl = JaxCached(ds, batch_size=4, shuffle=True, seed=0, cache_dtype=cache_dtype)
    pl = DeviceCachedLoader(ds, batch_size=4, device=CPU, shuffle=True, seed=0,
                            cache_dtype=cache_dtype)
    assert pl.nbytes == jl.nbytes
    assert pl.data["rdr_tensor"].dtype == getattr(torch, cache_dtype)
    assert pl.data["poses"].dtype == torch.float32 and "poses" not in pl._orig_dtype
    _same_batches(jl, pl)
    batch = next(iter(pl))
    idx = pl._indices()[:4]
    for row, i in enumerate(idx):
        item = ds[int(i)]
        want = np.asarray(jnp.asarray(item["rdr_tensor"]).astype(jnp.dtype(cache_dtype))
                          .astype(jnp.float32))
        np.testing.assert_array_equal(batch["rdr_tensor"][row].numpy(), want)
        np.testing.assert_array_equal(batch["poses"][row].numpy(), item["poses"])
    if scale > 100:
        assert torch.isnan(batch["rdr_tensor"]).any()     # the overflow case is in the data


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float8_e4m3fn", "float16"])
@pytest.mark.parametrize("src", [np.float32, np.float16])
def test_cache_cast_agrees_with_jax(cache_dtype, src):
    """``cache_cast`` against ``jnp.astype`` on random values, ties, subnormals,
    the largest float8 value and beyond it, infinities and NaN."""
    r = np.random.default_rng(0)
    special = [0.0, -0.0, 1.0, 0.1, 2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -9, 17.0, 18.0, 19.0,
               440.0, 447.9, 448.0, 449.0, 463.9, 464.0, 464.1, 465.0, 480.0, 500.0, 1000.0,
               60000.0, np.inf, np.nan]
    x = np.concatenate([r.normal(size=4096) * 3, r.normal(size=4096) * 200,
                        r.normal(size=512) * 1e-3, special, [-v for v in special]]).astype(src)
    want = np.asarray(jnp.asarray(x).astype(jnp.dtype(cache_dtype)).astype(jnp.float32))
    got = cache_cast(torch.from_numpy(x), getattr(torch, cache_dtype)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_float8_rows_gather_as_bytes():
    rows = cache_cast(torch.randn(10, 24), torch.float8_e4m3fn)
    sel = torch.tensor([7, 0, 7, 3])
    got = gather_batch({"x": rows}, sel, 4, {"x": (2, 3, 4)}, {"x": torch.float32})["x"]
    assert got.dtype == torch.float32 and got.shape == (4, 2, 3, 4)
    np.testing.assert_array_equal(got.reshape(4, 24).numpy(), rows.float().numpy()[[7, 0, 7, 3]])


def test_size_cap_raises_before_anything_is_uploaded(datasets):
    _, pds = datasets
    with pytest.raises(ValueError, match="GB cap"):
        DeviceCachedLoader(pds, batch_size=3, device=CPU, max_bytes=1000)


@pytest.mark.parametrize("cache_dtype", [None, "bfloat16", "float8_e4m3fn"])
def test_numeric_spec_matches_jax(cache_dtype):
    """Which keys are cached and which compressed: large float keys that the
    cast shrinks; labels, small keys and equal-width casts never."""
    item = {"meta": {}, "mode": "train", "hm": [np.zeros((2, 2), np.float32)],
            "rdr_tensor": np.zeros((4, 6, 8, 4), np.float32),   # 3 KB
            "rdr_raw": np.zeros((4, 6, 8, 4), np.float16),      # 1.5 KB
            "poses": np.zeros((1, 15, 3), np.float32),          # 180 B
            "num_poses": np.int32(1)}
    jkeys, jshapes, jdtypes, jorig = jax_numeric_spec(item, cache_dtype)
    keys, shapes, dtypes, orig = _numeric_spec(item, cache_dtype)
    assert keys == jkeys and shapes == jshapes and sorted(orig) == sorted(jorig)
    for k in keys:
        assert dtypes[k].itemsize == jdtypes[k].itemsize, k
    assert dtypes["poses"] == torch.float32 and dtypes["num_poses"] == torch.int32
    assert ("rdr_raw" in orig) == (cache_dtype == "float8_e4m3fn")


def test_loaders_need_poses():
    class NoPoses(MemoryDS):
        def __getitem__(self, i):
            item = super().__getitem__(i)
            del item["poses"]
            return item

    with pytest.raises(ValueError, match="poses"):
        DeviceCachedLoader(NoPoses(), batch_size=2, device=CPU)
    with pytest.raises(ValueError, match="poses"):
        StreamingDeviceLoader(NoPoses(), batch_size=2, chunk_bytes=10 ** 9, device=CPU)


PER_SAMPLE = 4 * 6 * 8 * 4 * 4 + 180 + 4     # MemoryDS item bytes, uncompressed


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n,bs,per_chunk,num_shards", [
    (16, 4, 16, 1), (11, 2, 4, 1), (11, 3, 3, 1), (10, 2, 4, 3), (5, 4, 100, 1)])
def test_streaming_loader_matches_jax(shuffle, n, bs, per_chunk, num_shards):
    """Chunk assignment, chunk and within-chunk order, batches, meta and
    ``valid`` over two epochs, for every shard."""
    for shard_id in range(num_shards):
        kw = dict(batch_size=bs, chunk_bytes=PER_SAMPLE * per_chunk, shuffle=shuffle, seed=4,
                  num_shards=num_shards, shard_id=shard_id)
        jl = JaxStreaming(MemoryDS(n), **kw)
        pl = StreamingDeviceLoader(MemoryDS(n), device=CPU, **kw)
        assert len(pl.chunks) == len(jl.chunks) and pl.n == jl.n
        assert pl.samples_per_chunk == jl.samples_per_chunk
        for a, b in zip(pl.chunks, jl.chunks):
            np.testing.assert_array_equal(a, b)
        _same_batches(jl, pl)
        assert 1 <= pl.max_resident <= 2


def test_streaming_loader_compressed_matches_jax():
    kw = dict(batch_size=2, chunk_bytes=PER_SAMPLE, shuffle=True, seed=1,
              cache_dtype="bfloat16")
    _same_batches(JaxStreaming(MemoryDS(9), **kw),
                  StreamingDeviceLoader(MemoryDS(9), device=CPU, **kw))


def test_streaming_sees_every_sample_once_and_reshuffles():
    pl = StreamingDeviceLoader(MemoryDS(12), batch_size=2, chunk_bytes=PER_SAMPLE * 4,
                               device=CPU, shuffle=True, seed=4)
    assert len(pl.chunks) == 3 and not pl.supports_fused_epochs

    def epoch(e):
        pl.set_epoch(e)
        return [m["i"] for b in pl for m in b["meta"]]

    e0, e1 = epoch(0), epoch(1)
    assert sorted(e0) == sorted(e1) == list(range(12)) and e0 != e1


def test_single_chunk_unshuffled_equals_cached_loader():
    ds = MemoryDS(8)
    sld = StreamingDeviceLoader(ds, batch_size=4, chunk_bytes=10 ** 12, device=CPU,
                                shuffle=False)
    dcl = DeviceCachedLoader(ds, batch_size=4, device=CPU, shuffle=False, drop_last=True)
    assert len(sld.chunks) == 1 and len(sld) == len(dcl) == 2
    for s, d in zip(list(sld), list(dcl)):
        assert s["meta"] == d["meta"] and s["valid"] == d["valid"] == 4
        for k in ("rdr_tensor", "poses", "num_poses"):
            assert torch.equal(s[k], d[k])


def test_streaming_valid_marks_padding():
    pl = StreamingDeviceLoader(MemoryDS(8), batch_size=3, chunk_bytes=10 ** 12, device=CPU,
                               shuffle=False)
    assert [int(b["valid"]) for b in pl] == [3, 3, 2]


def test_streaming_loader_error_reaches_the_consumer():
    """A read error on the prefetch thread is raised where the batches are
    consumed; an abandoned epoch leaves the loader usable."""
    pl = StreamingDeviceLoader(MemoryDS(8, fail_at=6), batch_size=2,
                               chunk_bytes=PER_SAMPLE * 4, device=CPU, shuffle=False)
    with pytest.raises(OSError, match="sample 6"):
        list(pl)
    pl.dataset.fail_at = None
    it = iter(pl)
    next(it)
    it.close()
    assert len(list(pl)) == 4
