"""The name table that puts the card's operations into classes.

Part of the yardstick: the per-layer metrics that sum device time by
class (``conv_lib_ms``, ``norm_eltwise_ms``, ``resize_ms``, ``nccl_ms``,
``h2d_ms``, the kernels' rooflines) read it.  The first matching rule
wins; the patterns are matched against the trace's kernel names.
"""

from __future__ import annotations

import re

RULES = [
    ("k3", r"conv3d_k3_kernel"),                    # the conv kernel (csrc/conv_k3.cu)
    ("k3_int8", r"conv3d_k3_int8_kernel"),
    ("k1", r"preprocess_kernel"),                   # csrc/preprocess.cu
    ("nccl", r"(?i)nccl"),
    ("h2d", r"Memcpy HtoD"),
    ("d2h", r"Memcpy DtoH"),
    ("memcpy", r"Memcpy|Memset"),
    ("resize", r"upsample_trilinear3d"),            # trilinear resize, forward and backward
    ("conv_lib", r"(?i)cudnn|xmma|implicit_convolve|implicit_gemm|conv|wgrad|dgrad|fprop"
                 r"|cutlass|sm90_|sm80_|gemm"),
    ("norm_eltwise", r"(?i)elementwise|reduce|norm|welford|softmax|cat|copy|fill|index|"
                     r"where|clamp|pow|exp|sigmoid|relu|threshold|scatter|gather|arange|sum|mean"),
]
_COMPILED = [(c, re.compile(p)) for c, p in RULES]


def classify(name: str) -> str:
    for cls, pat in _COMPILED:
        if pat.search(name):
            return cls
    return "other"
