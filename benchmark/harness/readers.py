"""Shared arithmetic of the per-layer metrics' readers (``metrics/*.py``).

Each reader takes the ``Trace`` of a run's traced stretch and returns a
number, or None where the stretch holds nothing to read.  A share of a
roofline or of a peak is never reported as 0: with no launch of its kernel
the reader returns None.
"""

from __future__ import annotations

import statistics
from typing import Optional

from benchmark.harness import counts


def seconds_per_unit(trace, unprofiled: bool = False) -> Optional[float]:
    """A unit's seconds in the traced stretch, or (``unprofiled``) over the
    window's units before the profiler first started, by the host clock:
    profiling slows a host-bound loop, so its own stretch reads a B=1
    frame too long."""
    if unprofiled:
        return trace.extra.get("unprofiled_s")
    return trace.window_s / trace.units if trace.window_s > 0 else None


def idle_pct(trace, unprofiled: bool = False) -> Optional[float]:
    """The share of a unit's time in which the card ran nothing: the traced
    stretch's device-busy seconds a unit over ``seconds_per_unit``."""
    s = seconds_per_unit(trace, unprofiled)
    if not s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.units / s)


def batch(trace) -> int:
    return int(trace.extra["cell"].traffic.get("batch_per_rank", 1))


def mfu_pct(trace, kind: str, unprofiled: bool = False) -> Optional[float]:
    """The whole step's (or frame's) operations over ``seconds_per_unit``,
    as a share of one card's bf16 peak (each rank traces its own card, so
    the share is per card)."""
    flops = counts.model_flops(trace.extra["cell"].cfg, batch(trace), kind)
    s = seconds_per_unit(trace, unprofiled)
    if not flops or not s:
        return None
    return 100.0 * flops / s / counts.BF16_PEAK


def k3_roofline_pct(trace, launches_per_shape: int) -> Optional[float]:
    """Least time of every K3 launch of the stretch over their device time.
    The launches' shapes are the forward's K3 convs (``counts.k3_shapes``),
    ``launches_per_shape`` times a unit (2 in training: the forward and the
    grad-input); a stretch whose launch count differs reads nothing."""
    shapes = counts.k3_shapes(trace.extra["cell"].cfg, batch(trace))
    ops = [o for o in trace.ops_named("conv3d_k3_kernel") if "int8" not in o[0]]
    if not ops or len(ops) != trace.units * launches_per_shape * len(shapes):
        return None
    bound = trace.units * launches_per_shape * sum(counts.k3_bound_s(*s) for s in shapes)
    return 100.0 * bound / (sum(e - s for _, s, e in ops) / 1e6)


def k1_roofline_pct(trace) -> Optional[float]:
    cfg = trace.extra["cell"].cfg
    ops = trace.ops_named("preprocess_kernel")
    if not ops or len(ops) != trace.units:
        return None
    z, y, x = counts.grid(cfg)
    bound = trace.units * counts.k1_bound_s(batch(trace), counts.in_channels(cfg), z, y, x)
    return 100.0 * bound / (sum(e - s for _, s, e in ops) / 1e6)


def median_host_ms(trace) -> Optional[float]:
    ms = trace.extra.get("host_ms")
    return statistics.median(ms) if ms else None
