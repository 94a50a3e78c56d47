"""The port's native C++ cube loader (``rtpose_tpu_torch.native``) against
the JAX package's (``rtpose_tpu.native``), on the CPU.

Both libraries are the same source built with the same flags, so they are
held bit for bit: ``probe``, ``load_cube`` (both layouts) and
``load_cube_batch``.  The loader normalizes as (v - n0) * (1 / scale), the
numpy path as (v - n0) / scale: held to at most one float32 ulp apart.  The
dataset's default ``get_cube`` (``use_native=True``) equals the JAX
dataset's default bit for bit, on a full-cube root and on an ROI-only one;
non-Doppler cubes and files the loader cannot read take the numpy path; a
source that does not compile raises with the compiler's output.
"""

import os
import time

import numpy as np
import pytest

from rtpose_tpu import native as jax_native
from rtpose_tpu.data import CRUWPoseDataset as JaxDataset
from rtpose_tpu.data.synthetic import dataset_cfg

from rtpose_tpu_torch import native
from rtpose_tpu_torch.data import CRUWPoseDataset, generate_synthetic_dataset

DOPPLER = 4


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """``rtpose_tpu.native`` builds its library with ``make`` at first use
    and keeps None for the rest of the process when loading fails, which
    can happen while another test worker is still linking the same file:
    ask again until the file is complete."""
    deadline = time.monotonic() + 120
    while jax_native.get_lib() is None and time.monotonic() < deadline:
        jax_native._tried = False
        time.sleep(1)
    assert jax_native.get_lib() is not None, "rtpose_tpu.native could not be built"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("native_roots")
    out = {}
    for name, kw in (("full", {}), ("roi", dict(roi_only=True)),
                     ("zyx", dict(rdr_type="zyx_real"))):
        out[name] = str(base / name)
        generate_synthetic_dataset(out[name], num_seqs=1, frames_per_seq=3,
                                   doppler_bins=DOPPLER, seed=5, test_frames_per_seq=0, **kw)
    return out


def _cfg(root, name):
    return dict(DATASET=dataset_cfg(root, rdr_type="zyx_real" if name == "zyx" else "dzyx_real",
                                    roi_only=name == "roi"))


def _paths(ds):
    return [ds._cube_path(s["seq"], s["rdr_frame"]) for s in ds.samples]


def test_probe_matches_jax(roots):
    ds = CRUWPoseDataset(_cfg(roots["full"], "full"), "Train.json")
    for path in _paths(ds):
        assert native.probe(path) == jax_native.probe(path) == ((DOPPLER, 32, 128, 256), "2")
    assert native.probe(os.path.join(roots["full"], "missing.npy")) is None


@pytest.mark.parametrize("channels_last", [True, False])
def test_load_cube_bit_equal_to_jax(roots, channels_last):
    ds = CRUWPoseDataset(_cfg(roots["full"], "full"), "Train.json")
    args = (ds.geom.roi_idx, ds.norm_start, ds.norm_scale, DOPPLER, ds.geom.grid_zyx)
    for path in _paths(ds):
        a = native.load_cube(path, *args, channels_last=channels_last)
        b = jax_native.load_cube(path, *args, channels_last=channels_last)
        assert a.shape == b.shape == ((16, 64, 160, DOPPLER) if channels_last
                                      else (DOPPLER, 16, 64, 160))
        assert a.tobytes() == b.tobytes()


def test_load_cube_batch_bit_equal_to_jax(roots):
    ds = CRUWPoseDataset(_cfg(roots["full"], "full"), "Train.json")
    args = (_paths(ds), ds.geom.roi_idx, ds.norm_start, ds.norm_scale, DOPPLER,
            ds.geom.grid_zyx)
    a = native.load_cube_batch(*args, nthreads=2)
    assert a.shape == (3, 16, 64, 160, DOPPLER)
    assert a.tobytes() == jax_native.load_cube_batch(*args, nthreads=2).tobytes()
    for i, path in enumerate(args[0]):
        assert a[i].tobytes() == native.load_cube(path, *args[1:]).tobytes()
    bad = native.load_cube_batch([args[0][0], "/nonexistent.npy"], *args[1:])
    assert bad is None


def test_native_within_one_ulp_of_numpy(roots):
    ds_np = CRUWPoseDataset(_cfg(roots["full"], "full"), "Train.json", use_native=False)
    ds_nat = CRUWPoseDataset(_cfg(roots["full"], "full"), "Train.json")
    differ = 0
    for i in range(len(ds_np)):
        a, b = ds_np[i]["rdr_tensor"], ds_nat[i]["rdr_tensor"]
        assert a.shape == b.shape == (16, 64, 160, DOPPLER) and b.dtype == np.float32
        ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1
        differ += int((ulps > 0).sum())
    assert differ > 0       # the two paths do round apart: the default matters


@pytest.mark.parametrize("root", ["full", "roi"])
def test_default_get_cube_bit_equal_to_jax_default(roots, root):
    """Both packages' datasets at their defaults (``use_native=True``) give
    the same host-loaded cubes, bit for bit."""
    cfg = _cfg(roots[root], root)
    pd, jd = CRUWPoseDataset(cfg, "Train.json"), JaxDataset(cfg, "Train.json")
    assert pd.use_native and jd.use_native
    for i in range(len(jd)):
        a, b = jd[i]["rdr_tensor"], pd[i]["rdr_tensor"]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # and with the numpy path asked for on both
    pd.use_native = jd.use_native = False
    assert pd[0]["rdr_tensor"].tobytes() == jd[0]["rdr_tensor"].tobytes()


def test_dispatch_by_input(roots, monkeypatch):
    """The native loader takes Doppler cubes on local paths only; cubes
    without Doppler and unreadable files take the numpy path."""
    calls = []
    real = native.load_cube
    monkeypatch.setattr(native, "load_cube", lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    zyx = CRUWPoseDataset(_cfg(roots["zyx"], "zyx"), "Train.json")
    jzyx = JaxDataset(_cfg(roots["zyx"], "zyx"), "Train.json")
    assert zyx[0]["rdr_tensor"].tobytes() == jzyx[0]["rdr_tensor"].tobytes()
    assert calls == []
    ds = CRUWPoseDataset(_cfg(roots["full"], "full"), "Train.json")
    ds[0]
    assert len(calls) == 1
    ds.use_native = False
    ds[1]
    assert len(calls) == 1
    # a file the loader refuses (f8) falls back to numpy, as in JAX
    path = ds._cube_path(ds.samples[2]["seq"], ds.samples[2]["rdr_frame"])
    arr = np.load(path)
    np.save(path, arr.astype(np.float64))
    try:
        ds.use_native = True
        assert native.probe(path) is None
        out = ds[2]["rdr_tensor"]
        ds.use_native = False
        assert out.tobytes() == ds[2]["rdr_tensor"].tobytes()
    finally:
        np.save(path, arr)


def test_bad_path_returns_none():
    assert native.load_cube("/nonexistent.npy", (0, 1, 0, 1, 0, 1), 0.0, 1.0, 2,
                            (2, 2, 2)) is None


def test_broken_source_fails_the_build(roots, tmp_path, monkeypatch):
    broken = tmp_path / "cube_loader.cpp"
    broken.write_text(open(native.SRC).read() + "\nint broken( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build(str(broken), str(tmp_path / "build"))
    assert "error" in str(e.value)
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
    # the dataset does not fall back to numpy when the library cannot be built
    monkeypatch.setattr(native, "SRC", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    ds = CRUWPoseDataset(_cfg(roots["full"], "full"), "Train.json")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ds[0]


def test_library_named_by_source_hash(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text(open(native.SRC).read())
    p1 = native.lib_path(str(src), str(tmp_path))
    src.write_text(open(native.SRC).read() + "\n// edited\n")
    assert native.lib_path(str(src), str(tmp_path)) != p1
    assert os.path.basename(native.lib_path()).startswith("cube_loader-")
