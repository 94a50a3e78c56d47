"""Broken runs come out not correct: the harness drives the rest of a run
(on the CPU, at a tiny grid, the card's look skipped) with the timed path
broken underneath, once for each fault an eval cell can have (an answer
altered where it is produced; a peak that is not the maximum, in one slot
of the batch), and the control (the program's own int8
path, the precision below the configuration's bfloat16) reads far above
the program.
"""

import types

import pytest
import torch

from benchmark import run
from benchmark.harness import check, eval_stream
from benchmark.harness.dist import Ranks
from benchmark.reference.evaluate import MARGIN
from benchmark.tests.tiny import tiny

pytest.importorskip("rtpose_tpu_torch")
EVAL = "hrradarpose_doppler.eval_b1"
CELLS = [EVAL, "hrradarpose_doppler.eval_b8"]
CPU = torch.device("cpu")


def drive(cell, seed=2 ** 33 + 17, seconds=0.5):
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0, t_start=None)
    return run.drive(cell, args, CPU, Ranks())


@pytest.fixture
def no_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(no_card_name, name):
    assert drive(tiny(name, frames=16))["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered(monkeypatch, no_card_name, name):
    from rtpose_tpu_torch.engine import steps
    decode = steps.decode_pose_sparse

    def altered(hm, reg, peak, spec):
        kpts, scores, labels = decode(hm, reg, peak, spec)
        return kpts + torch.tensor([10 * spec.voxel_size_xyz[0], 0.0, 0.0]), scores, labels

    monkeypatch.setattr(steps, "decode_pose_sparse", altered)
    assert drive(tiny(name, frames=16))["correct"] is False


def lower_peak(argmax):
    """``flat_argmax`` broken in the last slot of each batch: the best voxel
    that lies more than twice ``MARGIN`` below the heatmap's maximum.  (A
    voxel within the margin is a near-tie that rounding alone can pick: the
    sound program did, up to 0.98 logits below.)"""

    def broken(v, dim=1):
        ind = argmax(v, dim).clone()
        last = v[-1].float()
        ind[-1] = argmax(torch.where(last < last.max() - 2 * MARGIN, last, -torch.inf)[None])[0]
        return ind

    return broken


@pytest.mark.parametrize("name", CELLS)
def test_a_peak_that_is_not_the_maximum(monkeypatch, no_card_name, name):
    """The answer of a lower peak is judged against the near-ties alone, so
    it reads far from them, in any slot: eight answers of eight batches or
    more are judged, so the sample holds the last slot at B=8 as the cells'
    16 do.  (At the tiny grid the decodes of two voxels lie closer than at
    the cells' size, so the limit's failure is a card test:
    ``test_yardstick_card.py``.)"""
    from rtpose_tpu_torch.models import detectors

    def kpt_gap():
        cell = tiny(name, frames=16)
        cell.traffic["check_frames"] = 8
        return drive(cell, seconds=3.0)["checks"]["kpt_gap"]["value"]

    sound = kpt_gap()
    monkeypatch.setattr(detectors, "flat_argmax", lower_peak(detectors.flat_argmax))
    assert kpt_gap() > 3 * sound


def test_the_eval_control_reads_above_the_program():
    """The control's machinery at a size a CPU test holds: the int8 path
    reads well above the bfloat16 program.  (Its failure of the limits is
    a card test, at the cell's own size: ``test_yardstick_card.py``.)"""
    cell = tiny(EVAL)
    res = eval_stream.run(cell, 29, 0.5, False, CPU, extra=("control",))
    assert check.verdict(res["numbers"], cell.limits)
    assert res["extra"]["control"]["kpt_gap"] > 3 * res["numbers"]["kpt_gap"]
