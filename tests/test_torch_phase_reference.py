"""The complex-cube model (``hrradarpose_phase``: the feat64 trunk, 64 input
channels, and the head's shared conv, GroupNorm + 3x3x3 256 -> 128 + ReLU)
against the benchmark's plain float32 reference (``benchmark/reference/
model.py``) on the CPU, on the seeded weights the benchmark draws, at a
small grid of the configuration's widths.

* The dense forward; ``predict_sparse``'s regression at the peak against
  the reference's ``predict(sparse=True)`` and its dense regression
  gathered at the same voxel; ``forward_sparse_train``'s regression at
  target voxels on the volume's faces and corners.  The sparse paths apply
  the shared conv once, densely, and cut the regression's 5^3 patches from
  the shared feature, as the reference does.
* The old patch route (the shared conv applied to each 5^3 patch: its
  GroupNorm takes the statistics of 125 voxels, its conv sees zeros at the
  patch's faces) fails every sparse comparison, in float32 and in bf16.
* For a configuration without a shared conv (the flagship), the sparse
  paths give, bit for bit, what the old route gives.

Tolerances, of the reference's range (max |want|): float32 1e-4 (the same
arithmetic summed in other orders; read here 2.4e-6 to 3.7e-6).  bf16, the
configuration's compute dtype, ``BF16_TOL`` = 0.05: read here (seed SEED)
0.0145 on the dense heatmap, 0.0198 on the dense regression, 0.0139 on the
sparse predict's and 0.0098 on the sparse training's regression, the bf16
trunk's rounding layer by layer (as ``tests/test_torch_dcn_reference.py``'s
whole forward, 0.05).  The old route reads 0.36-0.40 on each.
"""

import json
import os

import pytest
import torch

from benchmark.harness import data
from benchmark.reference import model as ref
from benchmark.tests.tiny import TINY_ROI
from rtpose_tpu_torch.api import assemble
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.models import detectors
from rtpose_tpu_torch.models.center_head import CenterHead

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "benchmark", "configs")
SEED = 2 ** 33 + 21
GRID = (8, 16, 32)          # TINY_ROI's
BF16_TOL = 0.05
# target voxels: corners, faces and the interior
Z, Y, X = GRID
POINTS = [(0, 0, 0), (Z - 1, Y - 1, X - 1), (0, Y - 1, 3), (1, 0, X - 2), (Z - 2, 7, 0),
          (4, 8, 16), (2, 1, 30)]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the cores: cap torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(name: str, dtype: str) -> dict:
    """The benchmark's configuration at the small grid, computing in ``dtype``."""
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    ds = cfg["DATASET"]
    ds["ROI"][ds["RDR_CUBE"]["ROI_TYPE"]] = dict(TINY_ROI)
    cfg["test_cfg"]["pc_range"] = [TINY_ROI[a][0] for a in "xyz"]
    for part in ("backbone", "pose_head"):
        cfg["model"][part]["dtype"] = dtype
    return cfg


def _models(name: str, dtype: str):
    """The port and the reference, both on the benchmark's seeded weights."""
    cfg = _config(name, dtype)
    weights = data.make_weights(cfg, SEED, "cpu")
    port = assemble(Config(cfg)).model
    port.load_state_dict(weights)
    channels = 64 if name == "hrradarpose_phase" else 32
    net = ref.load(ref.build(cfg["model"], channels, "cpu"), weights)
    return port.eval(), net.eval(), channels


def _cube(channels: int, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, *GRID, channels), generator=g)


@pytest.fixture
def old_route(monkeypatch):
    """The route the port took before the shared conv ran once: none in the
    detector, and the head applying it to whatever it is given (the 5^3
    patches included)."""
    def on():
        heads = CenterHead.heads
        monkeypatch.setattr(detectors.RadarPoseNet, "shared", lambda self, feat: feat)
        monkeypatch.setattr(CenterHead, "heads",
                            lambda self, x, branch=None, inner_mask=None:
                            heads(self, self.shared(x), branch, inner_mask))
    return on


def _gap(got, want) -> float:
    """The largest gap over the reference's range (max |want|)."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _tol(dtype: str) -> float:
    return 1e-4 if dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_dense_forward_against_the_reference(dtype):
    port, net, c = _models("hrradarpose_phase", dtype)
    x = _cube(c)
    with torch.no_grad():
        hm_want, reg_want = net.dense(x)
        got = port(x)[0]
    assert _gap(got["hm"].permute(0, 4, 1, 2, 3), hm_want) <= _tol(dtype)
    assert _gap(got["reg"].permute(0, 4, 1, 2, 3), reg_want) <= _tol(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["shared_once", "old"])
def test_predict_sparse_against_the_reference(dtype, route, old_route):
    """The regression at the peak against the reference's sparse predict
    and its dense regression gathered there; the heatmap and the peak as
    the reference's."""
    port, net, c = _models("hrradarpose_phase", dtype)
    x = _cube(c)
    with torch.no_grad():
        hm_dense, reg_dense = net.dense(x)
        _, reg_sparse, peak_want = net.predict(x, sparse=True)
        if route == "old":
            old_route()
        hm, reg, peak = port.predict_sparse(x)
    assert torch.equal(peak, peak_want)
    assert _gap(hm.permute(0, 4, 1, 2, 3), hm_dense) <= _tol(dtype)
    at_peak = reg_dense.reshape(1, reg_dense.shape[1], -1)[:, :, peak[0]]
    assert _gap(reg_sparse, at_peak) <= 1e-5         # the reference's own two routes
    gaps = _gap(reg, reg_sparse), _gap(reg, at_peak)
    assert all((g <= _tol(dtype)) == (route == "shared_once") for g in gaps), gaps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["shared_once", "old"])
def test_forward_sparse_train_at_faces_and_corners(dtype, route, old_route):
    """The training forward's regression at target voxels on the volume's
    faces and corners, against the reference's sparse and dense training
    outputs."""
    port, net, c = _models("hrradarpose_phase", dtype)
    x = _cube(c, seed=2)
    ind = torch.tensor([[(z * Y + y) * X + xx for z, y, xx in POINTS]])
    with torch.no_grad():
        hm_want, reg_dense = net.train_outputs(x, ind, sparse=False)
        _, reg_sparse = net.train_outputs(x, ind, sparse=True)
        if route == "old":
            old_route()
        hm, reg = port.forward_sparse_train(x, ind)
    assert reg.shape == reg_dense.shape == (1, len(POINTS), 45)
    assert _gap(hm.permute(0, 4, 1, 2, 3), hm_want) <= _tol(dtype)
    gaps = _gap(reg, reg_sparse), _gap(reg, reg_dense)
    assert all((g <= _tol(dtype)) == (route == "shared_once") for g in gaps), gaps


@pytest.mark.parametrize("path", ["predict_sparse", "forward_sparse_train"])
def test_without_a_shared_conv_the_sparse_paths_are_the_old_route(path, old_route):
    """The flagship (no shared conv): both sparse paths bit-equal to the old
    route, and nothing shared counted."""
    port, _, c = _models("hrradarpose_doppler", "bfloat16")
    assert port.pose_head.shared_conv is None
    x = _cube(c, seed=3)
    ind = torch.tensor([[(z * Y + y) * X + xx for z, y, xx in POINTS]])
    call = ((lambda: port.predict_sparse(x)) if path == "predict_sparse"
            else (lambda: port.forward_sparse_train(x, ind)))
    detectors.reset()
    with torch.no_grad():
        now = call()
        assert detectors.counts()["shared_calls"] == 0
        old_route()
        before = call()
    assert all(torch.equal(a, b) for a, b in zip(now, before))
