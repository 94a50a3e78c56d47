"""The int8 serving cell's arithmetic: operations and bytes of the int8 K3
kernel (``csrc/conv_k3_int8.cu``), from shapes alone.

* ``k3_int8_bound_s``: the least time of one launch on an H100:
  max(operations / the int8 peak, bytes / bandwidth), the int8 input read
  once, the prepared weights read once and the bf16 output written once.
* ``k3_int8_roofline_pct``: the int8 K3 launches of a traced stretch against
  that bound, over their device time.  The launches' shapes are the
  forward's K3-shaped convs (``counts.k3_shapes``: 14 a flagship forward,
  each an int8 site of the artifact); a stretch whose launch count differs
  reads nothing.
"""

from __future__ import annotations

from typing import Optional

from benchmark.harness import counts, readers

INT8_PEAK = 1979e12     # H100 SXM, dense int8 OP/s (NVIDIA's data sheet)
KERNEL = "conv3d_k3_int8_kernel"
WEIGHT_BYTES = 27 * counts.K3_C * counts.K3_C     # the prepared int8 weights


def k3_int8_bound_s(b: int, z: int, y: int, x: int) -> float:
    vox = b * z * y * x
    ops = 2 * vox * counts.K3_C * counts.K3_C * 27
    nbytes = vox * counts.K3_C * 1 + WEIGHT_BYTES + vox * counts.K3_C * 2
    return max(ops / INT8_PEAK, nbytes / counts.HBM_BW)


def k3_int8_roofline_pct(trace) -> Optional[float]:
    cell = trace.extra["cell"]
    shapes = counts.k3_shapes(cell.cfg, readers.batch(trace), cell.bench_dir)
    ops = trace.ops_named(KERNEL)
    if not ops or len(ops) != trace.units * len(shapes):
        return None
    bound = trace.units * sum(k3_int8_bound_s(*s) for s in shapes)
    return 100.0 * bound / (sum(e - s for _, s, e in ops) / 1e6)
