"""The deformable-head configuration and its cell, ``hrradarpose_dcn.eval_b8``:
it resolves from the repo's ``BENCHMARK.json`` to its own reference
(``reference/dcn.py``), its seeded weights are frozen and draw the offset
convs from N(0, 0.05^2), the cell cut to a CPU-sized grid runs and checks
out within its limits, and the reader of ``deform_gather_ms.batch`` sums the
gathers of a trace.  On the card, at the cell's own size, a program that
ignores the offsets and the int8 control both come out not correct:

    python -m pytest -p no:cacheprovider benchmark/tests/test_yardstick_dcn.py -m cuda
"""

import math
import os
import types

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import check, data, eval_stream
from benchmark.harness.cells import BENCH_DIR, resolve
from benchmark.harness.dist import Ranks
from benchmark.harness.trace import Trace
from benchmark.tests.test_yardstick_weights import LARGE, digest
from benchmark.tests.tiny import shrink

NAME = "hrradarpose_dcn.eval_b8"
OFFSETS = [f"pose_head.tasks.0.feature_adapt_{b}.conv_offset.weight" for b in ("cls", "reg")]


def test_the_cell_resolves_to_its_own_reference():
    cell = resolve(NAME)
    assert cell.config == "hrradarpose_dcn" and cell.cfg["model"]["pose_head"]["dcn_head"]
    assert os.path.samefile(cell.reference.__file__, os.path.join(BENCH_DIR, "reference",
                                                                  "dcn.py"))
    assert cell.traffic["kind"] == "eval_stream" and cell.traffic["batch_per_rank"] == 8
    assert {m["name"] for m in cell.end_to_end} == {"batch_frames_per_s", "batch_ms_p50",
                                                      "batch_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle.batch", "mfu.batch", "k3_roofline.batch", "k1_roofline.batch",
        "h2d_ms.batch", "step_host_ms.batch", "deform_gather_ms.batch"}
    assert set(cell.limits) == {"kpt_gap"}


@pytest.mark.parametrize("seed,sha256", [
    (7, "e9bf7f2b683fb5a1e1c7b99d227908b7ebf03e264aeb0b4da3b9c1f0e3d02ec1"),
    (LARGE, "23a87b2125cfadbee6511c14caf1fe1ac602d3cf1b67a94af07150e98f375129"),
])
def test_the_weights_are_frozen_and_draw_the_offsets(seed, sha256):
    cell = resolve(NAME)
    weights = data.make_weights(cell.cfg, seed, "cpu")
    assert digest(weights) == sha256
    ref = cell.reference
    specs = ref.param_specs(ref.build(cell.cfg["model"], 32, "meta"))
    assert [n for n, _, k in specs if k == "offset"] == OFFSETS
    assert ref.INIT["offset"] == ("normal", 0.05)
    # after every He-normal kernel, the offsets from the same generator at 0.05
    g = data.generator(seed, 0, "cpu")
    torch.randn(sum(math.prod(s) for _, s, k in specs if ref.INIT[k][0] == "he_normal"),
                generator=g)
    want = torch.randn(2 * 72 * 128, generator=g) * 0.05
    assert torch.equal(torch.cat([weights[n].reshape(-1) for n in OFFSETS]), want)
    assert 0.045 < float(want.std()) < 0.055


def test_the_cut_cell_runs_and_checks_out():
    cell = shrink(resolve(NAME))
    res = eval_stream.run(cell, 2 ** 33 + 5, 0.3, False, torch.device("cpu"))
    assert res["units"] >= 1 and res["failed"] == 0
    assert all(math.isfinite(v) for v in res["numbers"].values())
    assert check.verdict(res["numbers"], cell.limits), res["numbers"]


def _trace(ops, units=3):
    cell = types.SimpleNamespace(cfg={}, traffic={"batch_per_rank": 8}, bench_dir=BENCH_DIR)
    return Trace(ops=ops, start_us=0.0, end_us=1e6, units=units, host_ops=[],
                 extra={"cell": cell})


def test_the_gather_reader_sums_the_gathers_a_batch():
    read = resolve(NAME).reader("deform_gather_ms.batch")
    ops = [("void at::native::(anonymous namespace)::indexSelectLargeIndex<c10::BFloat16, "
            "long, unsigned int, 2, 2, -2, true>(...)", 0.0, 4000.0),
           ("void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, "
            "long, long, long, long, bool)", 4000.0, 4500.0),
           ("deformable_im2col_kernel", 5000.0, 7000.0),
           ("void at::native::index_elementwise_kernel<128, 4>(...)", 8000.0, 9000.0),
           ("void at::native::_scatter_gather_elementwise_kernel<128, 8>(...)", 9000.0, 9500.0),
           ("conv3d_k3_kernel", 10000.0, 12000.0)]
    assert read(_trace(ops)) == pytest.approx((4000.0 + 500.0 + 2000.0) / 1e3 / 3)
    assert read(_trace(ops[3:])) is None
    assert read(_trace([])) is None


def _ignore_offsets(self, x):
    return F.relu(self.conv_adaption(x, torch.zeros_like(self.conv_offset(x))))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7201, 7202, 7203])
def test_the_eval_control_and_ignored_offsets_fail(card, monkeypatch, seed):
    from rtpose_tpu_torch.api import resolve_device
    from rtpose_tpu_torch.models import dcn_head
    cell = resolve(NAME)
    dev = resolve_device("cuda")
    res = eval_stream.run(cell, seed, 2.0, False, dev, Ranks(), extra=("control",))
    assert check.verdict(res["numbers"], cell.limits), res["numbers"]
    assert not check.verdict(res["extra"]["control"], cell.limits), res["extra"]
    monkeypatch.setattr(dcn_head.FeatureAdaption, "forward", _ignore_offsets)
    res = eval_stream.run(cell, seed, 2.0, False, dev, Ranks())
    assert not check.verdict(res["numbers"], cell.limits), res["numbers"]
