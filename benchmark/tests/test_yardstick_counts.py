"""The yardstick's frozen counts against the figures the records hold:
the port's card = CPU FLOP counts of the sparse predict and of the train
step's loss forward and backward at B=1, and PERF.md's K3 and K1 bounds."""

import json
import os

import pytest

from benchmark.harness import counts

CFG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                   "hrradarpose_doppler.json")


@pytest.fixture(scope="module")
def cfg():
    with open(CFG) as f:
        return json.load(f)


@pytest.mark.parametrize("kind,flops", [("predict", 136_302_440_640),
                                        ("train", 408_907_321_920)])
def test_flops_at_b1(cfg, kind, flops):
    assert counts.model_flops(cfg, 1, kind) == flops


def test_flops_scale_with_batch(cfg):
    assert counts.model_flops(cfg, 8, "train") == 8 * counts.model_flops(cfg, 1, "train")


def test_k3_shapes(cfg):
    shapes = counts.k3_shapes(cfg, 8)
    assert len(shapes) == 14
    assert shapes.count((8, 16, 64, 160)) == 8 and shapes.count((8, 8, 32, 80)) == 6


def test_k3_bound():
    assert round(counts.k3_bound_s(8, 16, 64, 160) * 1e3, 4) == 0.0733


def test_k1_bound():
    assert round(counts.k1_bound_s(1, 32, 16, 64, 160) * 1e3, 4) == 0.0094
