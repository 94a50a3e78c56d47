"""On the card, at the cell's own size: the control (the program's own
int8 path) and a decode of a peak that is not the maximum in one slot of
the batch come out not correct, and a sound run correct.  Run there with
``python -m pytest -p no:cacheprovider benchmark/tests/test_yardstick_card.py``."""

import pytest

from benchmark.harness import check, eval_stream
from benchmark.harness.cells import resolve
from benchmark.harness.dist import Ranks
from benchmark.tests.test_yardstick_faults import lower_peak

CELLS = ["hrradarpose_doppler.eval_b1", "hrradarpose_doppler.eval_b8"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [7001, 7002, 7003])
def test_the_eval_control_fails(card, name, seed):
    from rtpose_tpu_torch.api import resolve_device
    cell = resolve(name)
    res = eval_stream.run(cell, seed, 2.0, False, resolve_device("cuda"), Ranks(),
                          extra=("control",))
    assert check.verdict(res["numbers"], cell.limits)
    assert not check.verdict(res["extra"]["control"], cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [7101, 7102, 7103])
def test_a_peak_that_is_not_the_maximum_fails(card, monkeypatch, name, seed):
    from rtpose_tpu_torch.api import resolve_device
    from rtpose_tpu_torch.models import detectors
    monkeypatch.setattr(detectors, "flat_argmax", lower_peak(detectors.flat_argmax))
    cell = resolve(name)
    res = eval_stream.run(cell, seed, 2.0, False, resolve_device("cuda"), Ranks())
    assert not check.verdict(res["numbers"], cell.limits), res["numbers"]
