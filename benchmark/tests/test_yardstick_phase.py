"""The complex-cube configuration and its cell, ``hrradarpose_phase.eval_complex_b1``:
it resolves to the plain reference ``reference/model.py`` and to the loop
for host-prepared tensors, ``harness/eval_tensor.py``; the cell cut to a
CPU-sized grid runs and checks out within its limits, an altered answer
fails the check, and the program's old patch route (the head's shared
conv applied to each 5^3 patch) reads far above the program; the reader of
``conv_lib_ms.eval`` sums the library's convs of a trace; the reference
runs with TF32 off and leaves the settings as it found them.  On the card,
at the cell's own size, the int8 control and the old patch route both come
out not correct:

    python -m pytest -p no:cacheprovider benchmark/tests/test_yardstick_phase.py -m cuda
"""

import math
import os
import types

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import check, data, eval_tensor
from benchmark.harness.cells import BENCH_DIR, resolve
from benchmark.harness.dist import Ranks
from benchmark.harness.trace import Trace
from benchmark.tests.tiny import shrink

NAME = "hrradarpose_phase.eval_complex_b1"
CPU = torch.device("cpu")
SEED = 2 ** 33 + 5


def test_the_cell_resolves_to_the_plain_reference_and_the_tensor_loop():
    cell = resolve(NAME)
    assert cell.config == "hrradarpose_phase" and cell.cfg["DATASET"]["RDR_TYPE"] == "dzyx_complex"
    assert os.path.samefile(cell.reference.__file__, os.path.join(BENCH_DIR, "reference",
                                                                  "model.py"))
    assert cell.loop is eval_tensor
    assert cell.traffic["batch_per_rank"] == 1 and cell.traffic["cube"]["kind"] == "tensor"
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "frame_ms_p50",
                                                      "frame_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle.eval", "mfu.eval", "h2d_ms.eval", "step_host_ms.eval", "conv_lib_ms.eval"}
    assert set(cell.limits) == {"kpt_gap"}


def test_the_cut_cell_runs_and_checks_out():
    cell = shrink(resolve(NAME))
    res = eval_tensor.run(cell, SEED, 0.3, False, CPU)
    assert res["units"] >= 1 and res["failed"] == 0
    assert set(res) >= {"units", "frames", "window_s", "frame_ms", "call_ms", "host_ms",
                        "numbers"}
    assert all(math.isfinite(v) for v in res["numbers"].values())
    assert check.verdict(res["numbers"], cell.limits), res["numbers"]


def _drive(cell, seconds=0.5):
    args = types.SimpleNamespace(seed=SEED, seconds=seconds, trace=0, t_start=None)
    return run.drive(cell, args, CPU, Ranks())


def test_an_answer_altered_fails(monkeypatch):
    from rtpose_tpu_torch.engine import steps
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "cpu")
    decode = steps.decode_pose_sparse

    def altered(hm, reg, peak, spec):
        kpts, scores, labels = decode(hm, reg, peak, spec)
        return kpts + torch.tensor([10 * spec.voxel_size_xyz[0], 0.0, 0.0]), scores, labels

    monkeypatch.setattr(steps, "decode_pose_sparse", altered)
    assert _drive(shrink(resolve(NAME)))["correct"] is False


def patch_route(monkeypatch):
    """The program's route before its shared conv ran once: the head
    applies its shared conv to whatever it is given, the 5^3 patches
    included."""
    from rtpose_tpu_torch.models import detectors
    from rtpose_tpu_torch.models.center_head import CenterHead
    heads = CenterHead.heads
    monkeypatch.setattr(detectors.RadarPoseNet, "shared", lambda self, feat: feat)
    monkeypatch.setattr(CenterHead, "heads", lambda self, x, branch=None, inner_mask=None:
                        heads(self, self.shared(x), branch, inner_mask))


def test_the_old_patch_route_reads_far_above_the_program(monkeypatch):
    """At the tiny grid the old route read 3.4-4.0 voxels and the program
    0.06-0.08 (two seeds); its failure of the limit is a card test, at the
    cell's own size."""
    cell = shrink(resolve(NAME), frames=16)
    cell.traffic["check_frames"] = 8
    sound = eval_tensor.run(cell, SEED, 0.5, False, CPU)["numbers"]["kpt_gap"]
    patch_route(monkeypatch)
    old = eval_tensor.run(cell, SEED, 0.5, False, CPU)["numbers"]["kpt_gap"]
    assert old > 10 * sound, (old, sound)


def _trace(ops, units=3):
    cell = types.SimpleNamespace(cfg={}, traffic={"batch_per_rank": 1}, bench_dir=BENCH_DIR)
    return Trace(ops=ops, start_us=0.0, end_us=1e6, units=units, host_ops=[],
                 extra={"cell": cell})


def test_the_conv_lib_reader_sums_the_library_convs_a_frame():
    read = resolve(NAME).reader("conv_lib_ms.eval")
    ops = [("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 0.0, 3000.0),
           ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>(...)", 3000.0, 3400.0),
           ("sm80_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nchwkcrsc_nchw", 4000.0, 4600.0),
           ("conv3d_k3_kernel", 5000.0, 7000.0),
           ("group_norm_stats_kernel", 7000.0, 7100.0),
           ("void at::native::upsample_trilinear3d_out_frame<c10::BFloat16>(...)", 8000.0,
            9000.0),
           ("Memcpy HtoD (Pinned -> Device)", 9000.0, 9900.0)]
    assert read(_trace(ops)) == pytest.approx((3000.0 + 400.0 + 600.0) / 1e3 / 3)
    assert read(_trace(ops[3:])) is None
    assert read(_trace([])) is None


def test_the_reference_runs_without_tf32_and_restores_it(monkeypatch):
    from benchmark.reference import evaluate
    cell = shrink(resolve(NAME), frames=2)
    host = data.make_frames(cell.cfg, cell.traffic, SEED, CPU)
    answers = {0: (0, np.zeros((15, 3), np.float32), 0.5),
               1: (1, np.zeros((15, 3), np.float32), 0.5)}
    seen = []
    candidates = evaluate.candidates

    def recording(net, cube, spec):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return candidates(net, cube, spec)

    monkeypatch.setattr(evaluate, "candidates", recording)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        numbers, _ = eval_tensor.reference_check(cell, SEED, CPU, host, [0, 1], answers)
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert seen == [(False, False)] * 2
    assert after == (True, True)
    assert set(numbers) == {"peak_gap", "kpt_gap", "score_gap"}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7301, 7302])
def test_the_eval_control_and_the_patch_route_fail(card, monkeypatch, seed):
    from rtpose_tpu_torch.api import resolve_device
    cell = resolve(NAME)
    dev = resolve_device("cuda")
    res = eval_tensor.run(cell, seed, 2.0, False, dev, Ranks(), extra=("control",))
    assert check.verdict(res["numbers"], cell.limits), res["numbers"]
    assert not check.verdict(res["extra"]["control"], cell.limits), res["extra"]
    patch_route(monkeypatch)
    res = eval_tensor.run(cell, seed, 2.0, False, dev, Ranks())
    assert not check.verdict(res["numbers"], cell.limits), res["numbers"]
