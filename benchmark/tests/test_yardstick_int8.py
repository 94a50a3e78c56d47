"""The int8 serving configuration and its cell,
``hrradarpose_doppler_int8.serve_b8``: it resolves to the plain int8
reference ``reference/int8.py``, to the serving loop
``harness/serve_artifact.py`` and to its readers; ``mfu.batch`` counts the
flagship's operations; the seeded weights (the flagship's) and the
calibrated scales at the tiny grid are frozen; the cell cut to a CPU-sized
grid runs and checks out within its limits; the loop refuses a program
that serves the loaded artifact eagerly; the readers read a trace and
read nothing where a launch is missing.  On the card, at the cell's own
size, both controls (the bf16 artifact, and the int8 artifact with every
activation scale doubled) come out not correct, and both readers return
numbers on a real trace:

    python -m pytest -p no:cacheprovider benchmark/tests/test_yardstick_int8.py -m cuda
"""

import dataclasses
import hashlib
import math
import os

import pytest
import torch

from benchmark.harness import check, data, int8_counts, serve_artifact
from benchmark.harness.cells import BENCH_DIR, resolve
from benchmark.harness.dist import Ranks
from benchmark.harness.trace import Trace
from benchmark.tests.test_yardstick_weights import digest
from benchmark.tests.tiny import shrink

NAME = "hrradarpose_doppler_int8.serve_b8"
CPU = torch.device("cpu")
SEED = 2 ** 33 + 9
READERS = ("k3_int8_roofline.batch", "int8_gemm_ms.batch")


def test_the_cell_resolves_to_the_int8_reference_and_the_serving_loop():
    cell = resolve(NAME)
    assert cell.config == "hrradarpose_doppler_int8"
    assert os.path.samefile(cell.reference.__file__, os.path.join(BENCH_DIR, "reference",
                                                                  "int8.py"))
    assert cell.loop is serve_artifact
    assert cell.traffic["batch_per_rank"] == 8 and cell.cfg["int8"]["sites"] == 51
    assert {m["name"] for m in cell.end_to_end} == {"batch_frames_per_s", "batch_ms_p50",
                                                      "batch_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle.batch", "mfu.batch", "h2d_ms.batch", "step_host_ms.batch", *READERS}
    assert set(cell.limits) == {"answers_off", "scale_ulps"}
    for m in READERS:
        assert callable(cell.reader(m))


def test_mfu_counts_the_flagships_operations():
    from benchmark.harness import counts
    cell = resolve(NAME)
    assert counts.model_flops(cell.cfg, 8, "predict") == 1_090_419_525_120
    assert len(counts.k3_shapes(cell.cfg, 8)) == 14
    assert round(int8_counts.k3_int8_bound_s(8, 16, 64, 160) * 1e3, 4) == 0.0376


def test_the_weights_and_scales_are_frozen():
    cell = resolve(NAME)
    assert digest(data.make_weights(cell.cfg, 7, CPU)) == (
        "0cdc9b44e9ec07a9a9a07a335108c26b0179c041011ee9c2bd54e68e21d412ef")
    from rtpose_tpu_torch import export
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    cell = shrink(cell, frames=2)
    asm = assemble(Config(cell.cfg))
    asm.model.load_state_dict(data.make_weights(cell.cfg, 7, CPU))
    asm.model.eval()
    x = serve_artifact.prepared_frames(cell.cfg, cell.traffic, 7 + serve_artifact.CALIB_SEED,
                                       CPU)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scales = export.calibrate_predict(asm, [x])
    finally:
        torch.set_num_threads(n)
    h = hashlib.sha256()
    for k in sorted(scales):
        h.update(f"{k}={scales[k]!r};".encode())
    assert len(scales) == 51 and h.hexdigest() == SCALES_SHA256


SCALES_SHA256 = "13912019e631fff5e5c09213c4e5047ad091e45afebf91d595610a965fc18f9c"


def test_the_cut_cell_runs_and_checks_out():
    """At the tiny grid on the CPU the program's scales lie within the
    reference's own calibration (``scale_ulps``); the answers' limit is the
    card's, at full size (the ``cuda`` case): here every answer drifts by a
    voxel or two (four answers of the seed 2^33 + 9 read 1.5-2.7 on 16
    frames against the reference at the program's scales)."""
    cell = shrink(resolve(NAME))
    cell.cfg["int8"]["calib_batches"] = 1
    res = serve_artifact.run(cell, SEED, 0.3, False, CPU)
    assert res["units"] >= 1 and res["failed"] == 0
    assert all(math.isfinite(v) for v in res["numbers"].values()), res["numbers"]
    assert res["numbers"]["scale_ulps"] <= cell.limits["scale_ulps"], res["numbers"]


def test_the_loop_refuses_an_artifact_served_eagerly():
    def eager(model_input):
        return model_input

    with pytest.raises(SystemExit) as e:
        serve_artifact.replayed(eager)
    assert e.value.code != 0
    eager.graphs = object()
    assert serve_artifact.replayed(eager) is eager


def _trace(ops, units=2, int_mm=37):
    cell = resolve(NAME)
    return Trace(ops=ops, start_us=0.0, end_us=1e6, units=units, host_ops=[],
                 extra={"cell": cell, "quant_forward": {"int_mm": int_mm}})


GEMM = ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16>"
        "(cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16::Params)")


def test_the_readers_read_a_trace_and_nothing_where_a_launch_is_missing():
    k3 = [(f"void {int8_counts.KERNEL}<...>", 100.0 * i, 100.0 * i + 70.0) for i in range(28)]
    mm = [(GEMM, 5000.0 + 10 * i, 5000.0 + 10 * i + 8.0) for i in range(74)]
    other = [("conv3d_k3_kernel", 9000.0, 9100.0), ("Memcpy HtoD (Pinned -> Device)", 9100.0,
                                                    9200.0)]
    cell = resolve(NAME)
    roof, gemm = (cell.reader(m) for m in READERS)
    tr = _trace(k3 + mm + other)
    bound = sum(int8_counts.k3_int8_bound_s(*s) for s in [(8, 16, 64, 160)] * 8
                + [(8, 8, 32, 80)] * 6)
    assert roof(tr) == pytest.approx(100.0 * bound / (14 * 70e-6))
    assert gemm(tr) == pytest.approx(37 * 8.0 / 1e3)
    assert roof(_trace(k3[1:] + mm)) is None
    assert gemm(_trace(k3 + mm[1:])) is None
    assert gemm(_trace(k3 + mm, int_mm=0)) is None
    assert roof(_trace(other)) is None and gemm(_trace(other)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2390000001, 2390000002])
def test_both_controls_fail_and_the_readers_read_a_real_trace(card, seed):
    from rtpose_tpu_torch.api import resolve_device
    cell = resolve(NAME)
    dev = resolve_device("cuda")
    res = serve_artifact.run(cell, seed, 4.0, True, dev, Ranks(),
                             extra=("bf16", "double_scale"))
    assert check.verdict(res["numbers"], cell.limits), res["numbers"]
    for name in ("bf16", "double_scale"):
        assert not check.verdict(res["extra"][name], cell.limits), res["extra"]
        # the answers alone tell each control apart, its scales aside
        assert res["extra"][name]["answers_off"] > cell.limits["answers_off"], res["extra"]
    tr = res["trace"]
    tr.extra.update(cell=cell)
    for m in READERS:
        v = cell.reader(m)(tr)
        assert v is not None and v > 0, m
    assert cell.reader("k3_int8_roofline.batch")(tr) <= 100.0
    for m, part in zip(READERS, (int8_counts.KERNEL, "gemm")):
        first = next(i for i, o in enumerate(tr.ops) if part in o[0].lower())
        cut = dataclasses.replace(tr, ops=tr.ops[:first] + tr.ops[first + 1:])
        assert cell.reader(m)(cut) is None, m
