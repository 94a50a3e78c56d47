"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each source is a plain-C-interface ``.cu`` file compiled by ``nvcc`` for
``sm_90a`` into its own shared library under ``rtpose_tpu_torch/build/``
(listed in ``.gitignore``).  The first kernel launch builds every source
that has no library yet: one ``nvcc`` per source, all started together.
Libraries are named by a hash of their source, so an edited kernel is
rebuilt and a stale one is never loaded.  Nothing here runs at import.

Every kernel wrapper reaches its kernel through ``launch``, which runs it on
the current stream, raises on a CUDA error and counts the launch under one
of its library's counters (``launch_counts``).  ``dispatch_mode_active``
and ``sm_count`` are the rest of what the wrappers share: a wrapper goes
through its ``torch.ops.rtpose`` custom op (``ops/library.py``) while a
dispatch mode is active, takes its plain version on a CPU tensor, and
launches its kernel on a CUDA one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> (source file, exported function, its argument types (the
# last one the stream), the counters its launches are counted under)
KERNELS = {
    "preprocess": ("preprocess.cu", "rtpose_preprocess",
                   [_P, _P] + [_I] * 12 + [_F, _F, _P], ("preprocess", "preprocess_single")),
    "conv_k3": ("conv_k3.cu", "rtpose_conv3d_k3",
                [_P, _P, _P, _P] + [_I] * 10 + [_P], ("conv3d_k3", "conv3d_k3_bwd")),
    "conv_k3_int8": ("conv_k3_int8.cu", "rtpose_conv3d_k3_int8",
                     [_P] * 5 + [_I] * 11 + [_P], ("conv3d_k3_int8",)),
    "deform_conv": ("deform_conv.cu", "rtpose_deform_conv2d",
                    [_P] * 4 + [_I] * 8 + [_P], ("deform_conv2d",)),
    "group_norm": ("group_norm.cu", "rtpose_group_norm",
                   [_P] * 5 + [_I] * 6 + [_F, _P], ("group_norm",)),
    "resize_trilinear": ("resize_trilinear.cu", "rtpose_resize_trilinear",
                         [_P] * 3 + [_I] * 11 + [_P], ("resize_trilinear",)),
}
# counter -> kernel launches since the last ``reset_launch_counts``
_launches: Dict[str, int] = {c: 0 for *_, counters in KERNELS.values() for c in counters}

_lock = threading.Lock()
_funcs: Dict[str, ctypes._CFuncPtr] = {}
# library name -> {"seconds": build wall time (0.0 if cached), "log": nvcc output}
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(src: str) -> str:
    with open(os.path.join(CSRC_DIR, src), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{os.path.splitext(src)[0]}-{digest[:12]}.so")


def build_all() -> Dict[str, dict]:
    """Compile every kernel library not built yet (in parallel) and load
    all of them.  Raises with the compiler's output if a build fails."""
    with _lock:
        pending = [n for n in KERNELS if n not in _funcs]
        if not pending:
            return build_log
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in pending:
            src = KERNELS[name][0]
            path = _lib_path(src)
            if os.path.isfile(path):
                build_log[name] = {"seconds": 0.0, "log": "cached"}
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, path, time.perf_counter())
        failed = []
        for name, (proc, tmp, path, t0) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in pending:
            src, fn_name, argtypes, _ = KERNELS[name]
            fn = getattr(ctypes.CDLL(_lib_path(src)), fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _funcs[name] = fn
        return build_log


def launch(library: str, counter: str, device: torch.device, *args) -> None:
    """Run kernel library ``library`` on ``args`` and the current stream of
    ``device``, raise if it returns a CUDA error, and count one launch
    under ``counter``, one of the library's ``KERNELS`` counters."""
    if library not in _funcs:
        build_all()
    rc = _funcs[library](*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{counter} kernel launch failed with CUDA error {rc}")
    _launches[counter] += 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches per counter since the last reset.  Only ``launch``
    adds to them, so the replays of a captured CUDA graph, which pass no
    wrapper, are not in them."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for c in _launches:
        _launches[c] = 0


def dispatch_mode_active() -> bool:
    """True while a ``TorchDispatchMode`` is active on this thread (a
    ``FlopCounterMode``, the trace of ``torch.export``): a launch on raw
    pointers is invisible to it, so the wrappers go through their custom
    ops instead."""
    return torch._C._len_torch_dispatch_stack() > 0


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (one without an index: the current one)."""
    return _multiprocessors(torch.cuda.current_device() if device.index is None
                            else device.index)
