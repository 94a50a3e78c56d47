"""ctypes bindings for the native C++ cube loader (``cube_loader.cpp``).

Counterpart of ``rtpose_tpu/native/__init__.py``, with the port's own copy
of the source.  The library is built with ``g++`` at first use into
``rtpose_tpu_torch/build/`` (listed in ``.gitignore``) with the JAX
Makefile's flags, so both libraries round alike; its name carries a hash of
the source, the flags and the host's CPU model (``-march=native`` code is
the host's own), so an edited source is rebuilt and a stale or foreign
library is never loaded.  A failed build raises with the compiler's output:
there is no quiet fallback to numpy.  ``load_cube`` returns None for a file
it cannot read (not a C-order little-endian f2/f4 ``.npy``, or an ROI
outside the cube), and the dataset then takes its numpy path, as the JAX
package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "cube_loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
# rtpose_tpu/native/Makefile: CXXFLAGS, then -shared -o $@ $< -lpthread
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")

_lock = threading.Lock()
_lib = None


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def lib_path(src: Optional[str] = None, build_dir: Optional[str] = None) -> str:
    """The library's path for ``src`` (default ``SRC``) under ``build_dir``
    (default ``BUILD_DIR``)."""
    src, build_dir = src or SRC, build_dir or BUILD_DIR
    with open(src, "rb") as f:
        key = f.read() + " ".join(CXXFLAGS).encode() + _cpu_model().encode()
    return os.path.join(build_dir, f"cube_loader-{hashlib.sha1(key).hexdigest()[:12]}.so")


def build(src: Optional[str] = None, build_dir: Optional[str] = None) -> str:
    """Compile ``src`` (default ``SRC``) unless its library exists; returns
    the library's path.  Raises RuntimeError with g++'s output if the build
    fails."""
    src, build_dir = src or SRC, build_dir or BUILD_DIR
    path = lib_path(src, build_dir)
    if os.path.isfile(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXXFLAGS, "-shared", "-o", tmp, src, "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native cube loader: {' '.join(cmd)} failed: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native cube loader: g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use (raises if the build fails)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.rtp_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_char)]
        lib.rtp_probe.restype = ctypes.c_int
        lib.rtp_load_cube.argtypes = [
            ctypes.c_char_p] + [ctypes.c_long] * 6 + [
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int]
        lib.rtp_load_cube.restype = ctypes.c_int
        lib.rtp_load_cube_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long] + [ctypes.c_long] * 6 + [
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int, ctypes.c_int]
        lib.rtp_load_cube_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def probe(path: str):
    """(shape tuple, dtype char '2' or '4') of a .npy file, or None."""
    lib = get_lib()
    shape = (ctypes.c_long * 4)()
    ndim = ctypes.c_int()
    dt = ctypes.c_char()
    if lib.rtp_probe(path.encode(), shape, ctypes.byref(ndim), ctypes.byref(dt)) != 0:
        return None
    return tuple(shape[: ndim.value]), dt.value.decode()


def load_cube(path: str, roi_idx, norm_start: float, norm_scale: float,
              doppler_bins: int, out_zyx, channels_last: bool = True
              ) -> Optional[np.ndarray]:
    """Fused load + crop + normalize + clamp: (Z', Y', X', D) float32
    (``channels_last``) or (D, Z', Y', X'); None if the file cannot be read."""
    lib = get_lib()
    z0, z1, y0, y1, x0, x1 = (int(v) for v in roi_idx)
    zo, yo, xo = out_zyx
    out = np.empty((zo, yo, xo, doppler_bins) if channels_last
                   else (doppler_bins, zo, yo, xo), np.float32)
    rc = lib.rtp_load_cube(path.encode(), z0, z1, y0, y1, x0, x1,
                           float(norm_start), float(norm_scale),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
                           1 if channels_last else 0)
    return out if rc == 0 else None


def load_cube_batch(paths: Sequence[str], roi_idx, norm_start: float, norm_scale: float,
                    doppler_bins: int, out_zyx, nthreads: int = 4) -> Optional[np.ndarray]:
    """(B, Z', Y', X', D) float32: ``load_cube`` of every path on a C++
    thread pool; None if any file cannot be read."""
    lib = get_lib()
    z0, z1, y0, y1, x0, x1 = (int(v) for v in roi_idx)
    zo, yo, xo = out_zyx
    n = len(paths)
    out = np.empty((n, zo, yo, xo, doppler_bins), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.rtp_load_cube_batch(arr, n, z0, z1, y0, y1, x0, x1, float(norm_start),
                                 float(norm_scale),
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 out[0].size, 1, int(nthreads))
    return out if rc == 0 else None
