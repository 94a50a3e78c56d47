"""The port's training slice as a whole, on the CPU in float32:

* six steps of the port's ``Trainer`` against rtpose_tpu's ``Trainer``
  from the same weights on the same synthetic root and loader order, with
  one-cycle up to LR_MAX: the first step's loss (same weights, same batch)
  agrees to 1e-5 relative; the later ones to 5 %.  The two frameworks sum
  in different orders, and Adam moves an element whose gradient is near
  zero by a full lr step in the direction of its sign, so the elements
  whose sign differs move 2 lr apart from the first step on and the
  trajectories drift: measured 1e-4 at step 2 and 2.1 % at step 6 (with
  the config's own lr_max of 8e-3, 35 % by step 4);
* ``python -m rtpose_tpu_torch.tools.train ... --device cpu`` for two
  epochs (with ``--validate``) writes ``epoch_1.pth``, ``epoch_2.pth`` and ``latest``; a run
  stopped after epoch 1 and resumed ends equal to the uninterrupted run
  (within 1e-6: with one intra-op thread the CPU run is deterministic);
  ``tools.test`` evaluates the
  checkpoint as it is; ``import_torch_state_dict`` carries it into flax
  with no missing key.
"""

import json
import os
import re

import numpy as np
import pytest
import jax
import torch

from rtpose_tpu.api import assemble as jax_assemble
from rtpose_tpu.api import build_dataset_from_cfg as jax_dataset
from rtpose_tpu.config import Config as JaxConfig
from rtpose_tpu.data import BatchLoader as JaxLoader
from rtpose_tpu.engine import Trainer as JaxTrainer
from rtpose_tpu.engine import TrainState as JaxTrainState
from rtpose_tpu.engine import make_train_step as jax_make_train_step
from rtpose_tpu.engine.torch_import import import_torch_state_dict
from rtpose_tpu.models.hrnet3d import MODEL_CONFIGS
from rtpose_tpu.parallel import make_mesh
from rtpose_tpu.solver import build_optimizer_from_cfg as jax_build_opt
from rtpose_tpu.solver import make_one_cycle_fns as jax_one_cycle_fns

from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.data import BatchLoader, generate_synthetic_dataset
from rtpose_tpu_torch.engine import (Trainer, create_train_state, load_checkpoint,
                                     make_train_step, state_dict_from_jax)
from rtpose_tpu_torch.solver import build_optimizer_from_cfg, make_one_cycle_fns
from rtpose_tpu_torch.tools import test as port_test
from rtpose_tpu_torch.tools import train as port_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}  # -> grid (8, 16, 32)
LOSS_RTOL = [1e-5] + [5e-2] * 5
LR_MAX = 5e-4
TOTAL_EPOCHS, STOP_EPOCH = 3, 2


def _config_text(root):
    src = open(os.path.join(REPO, "tests", "test_e2e_cli.py")).read()
    tpl = re.search(r"CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1)
    text = tpl.format(root=root, roi=TINY_ROI)
    # a checkpoint after every epoch, for the resume check
    return text.replace("checkpoint_config = dict(interval=2)",
                        "checkpoint_config = dict(interval=1)")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    # 10 train frames, batches of 4: the group path pads the epoch to 12
    generate_synthetic_dataset(
        root, num_seqs=2, frames_per_seq=5, test_frames_per_seq=2, rdr_type="zyx_real",
        seed=4, pelvis_range={"x": (1.0, 2.0), "y": (-1.0, 1.0), "z": (-0.5, 1.2)},
        offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7))
    cfg_path = str(tmp_path_factory.mktemp("train_cfg") / "tiny.py")
    with open(cfg_path, "w") as f:
        f.write(_config_text(root))
    return dict(root=root, cfg_path=cfg_path, tmp=tmp_path_factory)


def _losses(json_log):
    with open(json_log) as f:
        return [json.loads(line)["loss"] for line in f]


def test_trainer_matches_jax_trainer(env):
    tmp = env["tmp"]
    jcfg = JaxConfig.fromfile(env["cfg_path"])
    jcfg.lr_config["lr_max"] = LR_MAX
    jasm = jax_assemble(jcfg)
    jds = jax_dataset(jcfg.data, "train", max_poses=1)
    bs = int(jcfg.data["samples_per_gpu"])
    jloader = JaxLoader(jds, batch_size=bs, shuffle=True, seed=0)
    total = len(jloader) * TOTAL_EPOCHS
    # host copies: the JAX trainer donates the state it is given
    params = jax.tree.map(np.array, jasm.model.init(jax.random.PRNGKey(1),
                                                    jasm.example_input()))
    jopt = jax_build_opt(jcfg, total)
    jlr, _ = jax_one_cycle_fns(total, float(jcfg.lr_config["lr_max"]))
    jparams = jax.tree.map(jax.numpy.asarray, params)
    jstate = JaxTrainState(params=jparams, opt_state=jopt.init(jparams),
                           step=jax.numpy.zeros((), jax.numpy.int32))
    jstep = jax_make_train_step(jasm.model, jasm.head, jasm.target_spec, jopt, lr_fn=jlr,
                                sparse_reg=jasm.sparse_head)
    jtrainer = JaxTrainer(jstep, jstate, work_dir=str(tmp.mktemp("jax_work")),
                          total_epochs=TOTAL_EPOCHS, lr_fn=jlr, mesh=make_mesh(1),
                          log_interval=1, checkpoint_interval=10,
                          enable_tensorboard=False, stop_epoch=STOP_EPOCH)
    jtrainer.run(jloader)
    want = _losses(jtrainer.json_log)

    cfg = Config.fromfile(env["cfg_path"])
    cfg.lr_config["lr_max"] = LR_MAX
    asm = assemble(cfg)
    model = asm.model
    model.load_state_dict(state_dict_from_jax(params))
    loader = BatchLoader(build_dataset_from_cfg(cfg.data, "train"), batch_size=bs,
                         shuffle=True, seed=0)
    assert len(loader) == len(jloader) == 3
    opt = build_optimizer_from_cfg(cfg, list(model.parameters()), total)
    lr_fn, _ = make_one_cycle_fns(total, float(cfg.lr_config["lr_max"]))
    step = make_train_step(model, asm.head, asm.target_spec, opt, lr_fn=lr_fn,
                           sparse_reg=asm.sparse_head)
    trainer = Trainer(step, create_train_state(model, opt),
                      work_dir=str(tmp.mktemp("port_work")), total_epochs=TOTAL_EPOCHS,
                      device=torch.device("cpu"), lr_fn=lr_fn, log_interval=1,
                      checkpoint_interval=10, enable_tensorboard=False,
                      stop_epoch=STOP_EPOCH)
    trainer.run(loader)
    got = _losses(trainer.json_log)
    assert len(got) == len(want) == STOP_EPOCH * 3
    np.testing.assert_array_less(np.abs(np.subtract(got, want)),
                                 np.multiply(LOSS_RTOL, np.abs(want)))
    assert got[-1] < 0.5 * got[0] and want[-1] < 0.5 * want[0]   # both learn
    assert int(trainer.state.step) == int(jtrainer.state.step) == 6
    assert int(opt.step_count) == 6


@pytest.fixture(scope="module")
def cli_runs(env):
    full = str(env["tmp"].mktemp("cli_full"))
    part = str(env["tmp"].mktemp("cli_part"))
    base = [env["cfg_path"], "--seed", "0", "--device", "cpu"]
    # one intra-op thread: with several, the CPU's parallel reductions sum in
    # an order that varies from run to run, and runs drift apart in the last
    # bits, which Adam then amplifies
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port_train.main(base + ["--work_dir", full, "--validate"])
        port_train.main(base + ["--work_dir", part, "--stop_epoch", "1"])
        assert not os.path.isfile(os.path.join(part, "checkpoints", "epoch_2.pth"))
        port_train.main(base + ["--work_dir", part, "--resume_from", part])
    finally:
        torch.set_num_threads(threads)
    return full, part


def test_cli_writes_checkpoints(cli_runs):
    full, _ = cli_runs
    ckpts = os.path.join(full, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["epoch_1.pth", "epoch_2.pth", "latest"]
    assert open(os.path.join(ckpts, "latest")).read() == "epoch_2.pth"
    ck = load_checkpoint(os.path.join(ckpts, "epoch_2.pth"))
    assert sorted(ck) == ["meta", "optimizer", "state_dict"]
    assert ck["meta"]["epoch"] == 2 and ck["meta"]["step"] == 6
    assert int(ck["optimizer"]["state"][0]["step"]) == 6
    assert os.path.isfile(os.path.join(full, "exp_config.py"))
    # --validate ran the port's eval between the epochs
    logs = [f for f in os.listdir(full) if f.startswith("exp_") and f.endswith(".log")]
    text = "".join(open(os.path.join(full, f)).read() for f in logs)
    assert "[val epoch 1] MPJPE" in text and "[val epoch 2] MPJPE" in text


def test_resume_ends_equal_to_uninterrupted_run(cli_runs):
    full, part = cli_runs
    a = load_checkpoint(os.path.join(full, "checkpoints", "epoch_2.pth"))
    b = load_checkpoint(os.path.join(part, "checkpoints", "epoch_2.pth"))
    assert a["meta"]["step"] == b["meta"]["step"]
    for k, v in a["state_dict"].items():
        np.testing.assert_allclose(b["state_dict"][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    for i, s in a["optimizer"]["state"].items():
        t = b["optimizer"]["state"][i]
        assert int(t["step"]) == int(s["step"])
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(t[k].numpy(), s[k].numpy(), rtol=0, atol=1e-6)


def test_checkpoint_evaluates_and_loads_into_flax(cli_runs, env, capsys):
    full, _ = cli_runs
    out = port_test.main([env["cfg_path"], "--checkpoint", full, "--work_dir",
                          os.path.join(full, "eval"), "--testset", "--device", "cpu"])
    assert "Evaluation MPJPE" in capsys.readouterr().out
    assert len(out["detections"]) == 4 and np.isfinite(out["results"]["MPJPE"])
    jasm = jax_assemble(JaxConfig.fromfile(env["cfg_path"]))
    # the tree's shapes are all the import needs: no compile
    shapes = jax.eval_shape(jasm.model.init, jax.random.PRNGKey(0), jasm.example_input())
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    sd = {k: v.numpy() for k, v in
          load_checkpoint(os.path.join(full, "checkpoints", "epoch_2.pth"))["state_dict"].items()}
    new, report = import_torch_state_dict(sd, params, MODEL_CONFIGS["hr_tiny_feat16_zyx_l4"])
    assert not report["missing"] and not report["unexpected"] and not report["mismatched"]
    leaf = new["params"]["head_m"]["task0"]["hm_out"]["bias"]
    np.testing.assert_array_equal(np.asarray(leaf), sd["pose_head.tasks.0.hm.2.bias"])


def test_test_cli_profile_writes_a_trace(cli_runs, env):
    """``tools.test --profile``: a Chrome trace of the whole eval under
    ``<work_dir>/profile``, with the forward's operations in it."""
    full, _ = cli_runs
    work = os.path.join(full, "eval_profile")
    out = port_test.main([env["cfg_path"], "--checkpoint", full, "--work_dir", work,
                          "--testset", "--profile", "--device", "cpu"])
    assert len(out["detections"]) == 4
    with open(os.path.join(work, "profile", "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv3d" in names


def test_train_cli_needs_a_card_unless_cpu_asked(env, tmp_path):
    """The train entry point runs on the card by default and refuses to go
    on quietly on the CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main([env["cfg_path"], "--work_dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        port_train.main([env["cfg_path"], "--loc_weight_early", "2.0", "--device", "cpu"])
