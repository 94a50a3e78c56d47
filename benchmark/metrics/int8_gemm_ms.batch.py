"""Device ms a batch of the int8 stock route's GEMMs (``torch._int_mm``,
``ops/quant.py::int8_conv_acc``): the kernels named by ``GEMM``, taken from
the card's trace of the int8 serving cell; None where the stretch has none,
or where their count is not the stock route's sites a forward
(``Trace.extra["quant_forward"]["int_mm"]``, counted on an eager forward:
the loaded program runs no Python site; None from a program without the
counter) times the batches traced."""

import re

# the int8 GEMMs torch._int_mm launches on the H100 (PyTorch 2.11: CUTLASS's
# cutlass_80_tensorop_i16832gemm_s8_{128x64_128x3,64x64_128x6}_tn_align16)
GEMM = re.compile(r"(?i)gemm_s8|s8s8|imma")


def read(trace):
    ops = [(s, e) for n, s, e in trace.ops if GEMM.search(n) and "k3" not in n]
    per = (trace.extra.get("quant_forward") or {}).get("int_mm")
    if not ops or not per or len(ops) != per * trace.units:
        return None
    return sum(e - s for s, e in ops) / 1e3 / trace.units
