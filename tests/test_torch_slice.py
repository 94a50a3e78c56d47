"""The port's eval slice as a whole against rtpose_tpu on the same weights:
synthetic data -> config -> checkpoint -> eval -> MPJPE.

JAX side: ``make_eval_step`` + ``run_eval`` (what tools/test.py runs).
Port side: ``rtpose_tpu_torch.tools.test.main([... "--device", "cpu"])``.
Both run in float32 (the tiny config sets no compute dtype).  Tolerances:
the two frameworks sum the convs in different orders, so float32 outputs
differ by ~1e-4 relative after the network's ~20 layers; keypoints agree to
ATOL_M meters (seen: 1e-6 m) and MPJPE to 0.01 mm (seen: 3e-5 mm), and the
heatmap peaks are identical.
"""

import json
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from rtpose_tpu.api import assemble as jax_assemble
from rtpose_tpu.api import build_dataset_from_cfg as jax_dataset
from rtpose_tpu.config import Config as JaxConfig
from rtpose_tpu.data import BatchLoader as JaxLoader
from rtpose_tpu.data import generate_synthetic_dataset as jax_generate
from rtpose_tpu.engine import make_eval_step as jax_eval_step
from rtpose_tpu.engine import run_eval as jax_run_eval

from rtpose_tpu_torch.data import generate_synthetic_dataset
from rtpose_tpu_torch.engine import save_checkpoint, state_dict_from_jax
from rtpose_tpu_torch.tools import test as port_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}  # -> grid (8, 16, 32)
ATOL_M = 1e-4        # keypoints, meters
MPJPE_TOL_MM = 0.01


def _config_text(root):
    src = open(os.path.join(REPO, "tests", "test_e2e_cli.py")).read()
    tpl = re.search(r"CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1)
    return tpl.format(root=root, roi=TINY_ROI)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice_data"))
    generate_synthetic_dataset(
        root, num_seqs=2, frames_per_seq=1, test_frames_per_seq=3,
        rdr_type="zyx_real", seed=4,
        pelvis_range={"x": (1.0, 2.0), "y": (-1.0, 1.0), "z": (-0.5, 1.2)},
        offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7))
    cfg_path = str(tmp_path_factory.mktemp("slice_cfg") / "tiny.py")
    with open(cfg_path, "w") as f:
        f.write(_config_text(root))
    cfg = JaxConfig.fromfile(cfg_path)
    asm = jax_assemble(cfg)
    params = asm.model.init(jax.random.PRNGKey(3), asm.example_input())
    params = jax.tree.map(np.array, params)
    # He-init regression outputs are tens of voxels; scale them to the
    # sub-voxel offsets of a trained head so MPJPE is on a realistic scale
    params["params"]["head_m"]["task0"]["reg_out"]["kernel"] *= 0.01
    work = tmp_path_factory.mktemp("slice_work")
    ckpt = save_checkpoint(str(work / "epoch_1.pth"), state_dict_from_jax(params),
                           meta={"epoch": 1})
    return dict(root=root, cfg_path=cfg_path, cfg=cfg, asm=asm, params=params,
                ckpt=ckpt, work=work)


def _jax_eval(env, device_preprocess):
    cfg, asm = env["cfg"], env["asm"]
    ds = jax_dataset(cfg.data, "test", max_poses=1,
                     device_preprocess=device_preprocess)
    pre = (ds.norm_start, ds.norm_scale) if device_preprocess else None
    loader = JaxLoader(ds, batch_size=int(cfg.data["samples_per_gpu"]),
                       shuffle=False, drop_last=False)
    step = jax_eval_step(asm.model, asm.head, asm.decode_spec, sparse=True,
                         preprocess=pre)
    # the Pallas preprocess kernel runs as the JAX package's own tests run
    # it on the CPU: in interpret mode
    with pltpu.force_tpu_interpret_mode():
        det, _ = jax_run_eval(step, env["params"], loader, asm.decode_spec)
    res, _ = ds.evaluation(det, testset=True)
    return ds, det, res["results"]


def _port_eval(env, tag, *extra):
    work = str(env["work"] / tag)
    out = port_test.main([env["cfg_path"], "--checkpoint", env["ckpt"],
                          "--work_dir", work, "--testset", "--device", "cpu",
                          *extra])
    return out, work


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_slice_matches_jax(env, device_preprocess, capsys):
    ds, jdet, jres = _jax_eval(env, device_preprocess)
    extra = ["--device_preprocess", "--speed_test"] if device_preprocess else []
    out, work = _port_eval(env, f"pp{int(device_preprocess)}", *extra)
    stdout = capsys.readouterr().out
    assert "Evaluation MPJPE" in stdout
    if device_preprocess:
        assert "Total time per frame" in stdout
    pdet = out["detections"]
    assert sorted(pdet) == sorted(jdet) and len(pdet) == len(ds) == 6
    for key in jdet:
        a = np.asarray([p[1:4] for p in jdet[key]["keypoints"]])
        b = np.asarray([p[1:4] for p in pdet[key]["keypoints"]])
        assert a.shape == b.shape == (15, 3)
        np.testing.assert_allclose(b, a, atol=ATOL_M)
        assert [p[0] for p in pdet[key]["keypoints"]] == list(range(15))
    assert abs(out["results"]["MPJPE"] - jres["MPJPE"]) <= MPJPE_TOL_MM
    assert abs(out["results"]["ABS_MPJPE"] - jres["ABS_MPJPE"]) <= MPJPE_TOL_MM
    pred = json.load(open(os.path.join(work, "epoch_1", "test_prediction.json")))
    assert sum(len(v) for v in pred.values()) == 6
    assert os.path.isfile(os.path.join(work, "epoch_1",
                                       "epoch_1_seq_results_test.json"))


def test_peak_indices_match(env):
    """Same frames through both models' sparse predict: identical peaks."""
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.engine import load_checkpoint

    cfg = Config.fromfile(env["cfg_path"])
    asm = assemble(cfg)
    asm.model.load_state_dict(load_checkpoint(env["ckpt"])["state_dict"])
    ds = jax_dataset(env["cfg"].data, "test", max_poses=1)
    x = np.stack([ds[i]["rdr_tensor"] for i in range(len(ds))])
    _, jreg, jind = env["asm"].model.apply(env["params"], jnp.asarray(x),
                                           method="predict_sparse")
    with torch.no_grad():
        _, preg, pind = asm.model.predict_sparse(torch.from_numpy(x))
    np.testing.assert_array_equal(pind.numpy(), np.asarray(jind))
    scale = np.abs(np.asarray(jreg)).max()
    np.testing.assert_allclose(preg.numpy(), np.asarray(jreg), atol=1e-3 * scale)


def test_cuda_device_required_unless_cpu_asked(env):
    """The entry point runs on the card by default and refuses to carry on
    quietly on the CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test.main([env["cfg_path"], "--checkpoint", env["ckpt"]])


GENERATOR_KINDS = {
    "zyx_real": dict(rdr_type="zyx_real", pose_mode="skeleton"),
    "dzyx_real_roi_only": dict(rdr_type="dzyx_real", doppler_bins=2, roi_only=True),
    "persons_per_frame=2": dict(rdr_type="dzyx_real", doppler_bins=2, roi_only=True,
                                pose_mode="skeleton", persons_per_frame=2),
    "seq_offset": dict(rdr_type="zyx_real", seq_offset=48),
    "dzyx_complex": dict(rdr_type="dzyx_complex", doppler_bins=2),
    "dzyx_complex_roi_only": dict(rdr_type="dzyx_complex", doppler_bins=2, roi_only=True),
}


@pytest.mark.parametrize("kind", list(GENERATOR_KINDS))
def test_generator_matches_jax(tmp_path, kind):
    """The port's generator writes byte-identical files for the same seed."""
    kw = dict(num_seqs=1, frames_per_seq=1, test_frames_per_seq=1, seed=7,
              **GENERATOR_KINDS[kind])
    a, b = tmp_path / "jax", tmp_path / "port"
    ka = jax_generate(str(a), **kw)
    kb = generate_synthetic_dataset(str(b), **kw)
    assert ka == kb
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert len(files) == 5
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
