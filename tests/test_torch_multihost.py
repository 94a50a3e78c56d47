"""The port's data parallelism executed: two ranks of a ``torchrun`` job
over gloo on the CPU, against rtpose_tpu's one-device train step on the
union of the ranks' batches (the JAX package's two-process layout).

* ``torchrun --standalone --nproc_per_node 2 -m rtpose_tpu_torch.tools.train
  <tiny cfg> --multihost --device cpu``, two epochs of two steps (15 frames
  padded to 16 by the flag-group sampler, 4 a rank a step): every logged
  loss against a reference made here, the JAX ``BatchLoader`` with
  ``num_shards=2``, shards 0 and 1 zipped and concatenated, through JAX's
  train step from the same initial weights (``import_torch_state_dict``).
  Tolerances as ``tests/test_torch_train_slice.py``'s: 1e-5 relative at
  the first step (same weights, same batch), 5 % after it, where the two
  frameworks' trajectories drift apart (``lr_max`` 5e-4, as there).  Only
  rank 0 wrote the checkpoint and the logs.  ``tools.test --multihost`` on
  its checkpoint (9 test frames: the sampler's wrap-around gives rank 1
  frame 0 again) gives the one-process ``tools.test``'s detections and MPJPE
  (the ranks' detections merged in the dataset's order: equal as a float).
* ``tests/torch_multihost_worker.py`` under the same launcher: two train
  steps on a global batch of 8 frames, one without a person, from the same
  weights as JAX's step on the whole batch: losses rtol 1e-4, the
  parameters identical on both ranks and within ``tests/test_parallel.py``'s
  Adam bound of JAX's (every element within 2.05 lr, fewer than 0.5 % of
  them more than 1e-5 apart); a NaN batch on rank 1 only skips the step on
  both ranks; ``all_gather_objects`` returns both ranks' objects in rank
  order; ``--device_cache --fuse_epochs`` with ``--cache_shard`` equals the
  replicated-cache run of the same two ranks (bit for bit on the CPU).
* ``--cache_shard`` without ``--device_cache`` exits with the JAX CLI's
  message; ``--multihost`` outside a torchrun job raises.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rtpose_tpu.api import assemble as jax_assemble
from rtpose_tpu.api import build_dataset_from_cfg as jax_dataset
from rtpose_tpu.config import Config as JaxConfig
from rtpose_tpu.data import BatchLoader as JaxLoader
from rtpose_tpu.engine import TrainState as JaxTrainState
from rtpose_tpu.engine import make_train_step as jax_make_train_step
from rtpose_tpu.engine.torch_import import import_torch_state_dict
from rtpose_tpu.models.hrnet3d import MODEL_CONFIGS
from rtpose_tpu.solver import build_optimizer_from_cfg as jax_build_opt
from rtpose_tpu.solver import make_one_cycle_fns as jax_one_cycle_fns

from rtpose_tpu_torch.api import assemble
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.data import generate_synthetic_dataset
from rtpose_tpu_torch.engine import create_train_state, make_train_step, state_dict_from_jax
from rtpose_tpu_torch.models import init_weights
from rtpose_tpu_torch.solver import build_optimizer_from_cfg, make_one_cycle_fns
from rtpose_tpu_torch.tools import test as port_test
from rtpose_tpu_torch.tools import train as port_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_multihost_worker as worker  # noqa: E402

TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625],
            "x": [0.7703125, 2.2203125]}  # -> grid (8, 16, 32)
LR_MAX = 5e-4
WORLD = 2
EPOCHS = 2
LOSS_RTOL = [1e-5] + [5e-2] * 3
RUN_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, as the ranks have: six test workers share the cores,
    and the CPU convs sum in the same order in every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torchrun(args, log):
    """``torchrun --standalone`` (a free rendezvous port of its own) with two
    single-threaded ranks; fails with the ranks' output."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(WORLD), *args]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=RUN_TIMEOUT_S)
    with open(log, "w") as f:
        f.write(out.stdout + out.stderr)
    assert out.returncode == 0, (out.stdout + out.stderr)[-6000:]
    return out.stdout + out.stderr


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    root = str(tmp / "data")
    generate_synthetic_dataset(
        root, num_seqs=3, frames_per_seq=5, test_frames_per_seq=3, rdr_type="zyx_real",
        seed=4, pelvis_range={"x": (1.0, 2.0), "y": (-1.0, 1.0), "z": (-0.5, 1.2)},
        offset_scale=(0.08, 0.08, 0.1), z_clip=(-1.0, 1.7))
    src = open(os.path.join(REPO, "tests", "test_e2e_cli.py")).read()
    tpl = re.search(r"CONFIG_TEMPLATE = '''(.*?)'''", src, re.S).group(1)
    cfg_path = str(tmp / "tiny.py")
    with open(cfg_path, "w") as f:
        f.write(tpl.format(root=root, roi=TINY_ROI))
    cli_work = str(tmp / "cli_work")
    cli_log = _torchrun(["-m", "rtpose_tpu_torch.tools.train", cfg_path, "--work_dir", cli_work,
                         "--seed", "0", "--device", "cpu", "--multihost",
                         "--lr_max", str(LR_MAX)], tmp / "cli.log")
    out = str(tmp / "worker")
    os.makedirs(out)
    _torchrun([os.path.join(REPO, "tests", "torch_multihost_worker.py"), cfg_path, out,
               cli_work, str(LR_MAX)], tmp / "worker.log")
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(WORLD)]
    params = [dict(np.load(os.path.join(out, f"rank{r}_params.npz"))) for r in range(WORLD)]
    return dict(tmp=tmp, cfg_path=cfg_path, cli_work=cli_work, cli_log=cli_log,
                ranks=ranks, params=params)


@pytest.fixture(scope="module")
def jax_ref(env):
    """JAX's one-device train step (jitted once, B=8) and the flax params of
    the port's seed-0 initial weights."""
    jcfg = JaxConfig.fromfile(env["cfg_path"])
    jcfg.lr_config["lr_max"] = LR_MAX
    jasm = jax_assemble(jcfg)
    template = jasm.model.init(jax.random.PRNGKey(0), jasm.example_input())
    port = init_weights(assemble(Config.fromfile(env["cfg_path"])).model,
                        torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, report = import_torch_state_dict(
        sd, template, MODEL_CONFIGS[jcfg.model["backbone"]["backbone_cfg"]])
    assert not report["missing"] and not report["mismatched"]
    opt = jax_build_opt(jcfg, worker.TOTAL_STEPS)
    lr_fn, _ = jax_one_cycle_fns(worker.TOTAL_STEPS, LR_MAX)
    step = jax.jit(jax_make_train_step(jasm.model, jasm.head, jasm.target_spec, opt, lr_fn=lr_fn,
                                       sparse_reg=jasm.sparse_head))

    def run(batches):
        p = jax.tree.map(jnp.asarray, params)
        state = JaxTrainState(params=p, opt_state=opt.init(p), step=jnp.zeros((), jnp.int32))
        losses = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        return losses, state

    return dict(jcfg=jcfg, jasm=jasm, run=run)


def test_cli_losses_match_jax_on_the_union_of_the_shards(env, jax_ref):
    jcfg = jax_ref["jcfg"]
    ds = jax_dataset(jcfg.data, "train", max_poses=1)
    bs = int(jcfg.data["samples_per_gpu"])
    loaders = [JaxLoader(ds, batch_size=bs, shuffle=True, seed=0, num_shards=WORLD, shard_id=r)
               for r in range(WORLD)]
    assert len(loaders[0]) * EPOCHS == worker.TOTAL_STEPS
    batches = []
    for epoch in range(EPOCHS):
        for ld in loaders:
            ld.set_epoch(epoch)
        for parts in zip(*loaders):
            batches.append({k: np.concatenate([p[k] for p in parts])
                            for k in ("rdr_tensor", "poses", "num_poses")})
    want, _ = jax_ref["run"](batches)
    logs = [f for f in os.listdir(env["cli_work"]) if f.endswith(".log.json")]
    assert len(logs) == 1
    with open(os.path.join(env["cli_work"], logs[0])) as f:
        got = [json.loads(line)["loss"] for line in f]
    assert len(got) == len(want) == worker.TOTAL_STEPS
    np.testing.assert_array_less(np.abs(np.subtract(got, want)),
                                 np.multiply(LOSS_RTOL, np.abs(want)))
    assert "start training: 2 epochs x 2 steps on cpu, 2 process(es)" in env["cli_log"]


def test_cli_only_rank0_wrote(env):
    work = env["cli_work"]
    files = sorted(os.listdir(work))
    assert [f for f in files if f.endswith(".log.json")] and len(files) == 4, files
    assert "exp_config.py" in files and sum(f.startswith("exp_2") for f in files) == 1
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == ["epoch_2.pth", "latest"]
    text = open(os.path.join(work, next(f for f in files if f.startswith("exp_2")))).read()
    assert text.count("Epoch [2/2][2/2]") == 1 and text.count("saved checkpoint") == 1


def test_multihost_eval_equals_one_process_eval(env, tmp_path):
    one = port_test.main([env["cfg_path"], "--checkpoint", env["cli_work"], "--testset",
                          "--device", "cpu", "--work_dir", str(tmp_path)])
    r0, r1 = (r["test"] for r in env["ranks"])
    assert r1["mpjpe"] is None          # rank 1 evaluates nothing itself
    assert r0["keys"] == r1["keys"] == sorted(one["detections"])
    # the test set's 9 frames, none missing; rank 1's shard repeats frame 0
    assert len(r0["keys"]) == 9
    assert r0["mpjpe"] == one["results"]["MPJPE"]


def _adam_distance(model, flat, want_sd):
    """(largest difference, share of elements more than 1e-5 apart) between
    the flat parameters ``flat`` loaded into ``model`` and ``want_sd``."""
    torch.nn.utils.vector_to_parameters(torch.from_numpy(flat), model.parameters())
    total = mismatched = 0
    dmax = 0.0
    for k, v in model.state_dict().items():
        d = np.abs(v.numpy() - want_sd[k].numpy())
        dmax = max(dmax, float(d.max()))
        total += d.size
        mismatched += int((d > 1e-5).sum())
    return dmax, mismatched / total


def test_two_steps_match_jax_on_the_whole_batch(env, jax_ref):
    """Losses of both steps against JAX's; the parameters after the first
    step within the Adam bound of JAX's (a one-step bound: an element whose
    gradient is near zero moves +-lr with the sign of noise); after the
    second, within 2.05 lr_max of JAX's and within the one-step bound of the
    port's own one-process steps on the whole batch (the two ranks' sum only
    reassociates)."""
    cfg = Config.fromfile(env["cfg_path"])
    cfg.lr_config["lr_max"] = LR_MAX
    asm = assemble(cfg)
    batch = worker.global_batch(asm)
    want, state1 = jax_ref["run"]([batch])
    want2, state2 = jax_ref["run"]([batch, batch])
    for rank in env["ranks"]:
        got = [s["loss"] for s in rank["steps"]]
        np.testing.assert_allclose(got, [want[0], want2[1]], rtol=1e-4)
        assert [s["skipped"] for s in rank["steps"]] == [0.0, 0.0]
        assert rank["steps"][0]["num_positive"] == sum(worker.NUM_POSES)
    p0, p1 = env["params"]
    for k in ("step1", "step2"):
        assert np.array_equal(p0[k], p1[k]), k       # the ranks hold one state
    model = init_weights(asm.model, torch.Generator().manual_seed(0))
    lr0 = LR_MAX / float(cfg.lr_config["div_factor"])       # one-cycle's first lr
    dmax, share = _adam_distance(model, p0["step1"],
                                 state_dict_from_jax(jax.device_get(state1.params)))
    assert dmax <= 2.05 * lr0 and share < 5e-3, (dmax, share)
    dmax, _ = _adam_distance(model, p0["step2"],
                             state_dict_from_jax(jax.device_get(state2.params)))
    assert dmax <= 2.05 * LR_MAX, dmax

    model = init_weights(assemble(cfg).model, torch.Generator().manual_seed(0))
    opt = build_optimizer_from_cfg(cfg, list(model.parameters()), worker.TOTAL_STEPS)
    lr_fn, _ = make_one_cycle_fns(worker.TOTAL_STEPS, LR_MAX)
    step = make_train_step(model, asm.head, asm.target_spec, opt, lr_fn=lr_fn,
                           sparse_reg=asm.sparse_head)
    st = create_train_state(model, opt)
    whole = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = [float(step(st, whole)[1]["loss"]) for _ in range(2)]
    np.testing.assert_allclose([s["loss"] for s in env["ranks"][0]["steps"]], losses, rtol=1e-5)
    one_sd = {k: v.clone() for k, v in model.state_dict().items()}
    dmax, share = _adam_distance(model, p0["step2"], one_sd)
    assert dmax <= 2.05 * LR_MAX and share < 5e-3, (dmax, share)


def test_nan_on_one_rank_skips_the_step_on_every_rank(env):
    for rank in env["ranks"]:
        nan = rank["nan_step"]
        assert not np.isfinite(nan["loss"]) and nan["skipped"] == 1.0
        assert nan["unchanged"] and nan["optimizer_steps"] == 2 and nan["global_step"] == 3


def test_all_gather_objects_in_rank_order(env):
    for rank in env["ranks"]:
        assert [g["rank"] for g in rank["gathered"]] == list(range(WORLD))
        assert rank["gathered"][rank["rank"]]["last_loss"] == rank["steps"][-1]["loss"]


def test_sharded_cache_run_equals_replicated_cache_run(env):
    p0, p1 = env["params"]
    for rank in env["ranks"]:
        cache, shard = rank["cache"], rank["cache_shard"]
        assert cache["fused"] and shard["fused"] and shard["shard"] and not cache["shard"]
        assert len(cache["losses"]) == worker.TOTAL_STEPS
        assert shard["losses"] == cache["losses"]
    assert np.array_equal(p0["cache_shard"], p0["cache"])
    assert np.array_equal(p0["cache_shard"], p1["cache_shard"])
    for tag in ("cache", "cache_shard"):     # one rank's logs and checkpoints
        files = env["ranks"][0][tag]["files"]
        assert sum(f.endswith(".log.json") for f in files) == 1 and len(files) == 4, files


def test_sync_bn_over_two_ranks_equals_one_process(env):
    """The RPN neck with ``sync_bn_axis`` on two gloo ranks, each on half of
    the batch, equals the neck on the whole batch in one process: outputs,
    running statistics and input gradients to 1e-5 of their largest value,
    the parameter gradients summed over the ranks likewise."""
    x, w = worker.sync_bn_input()
    whole = worker.sync_bn_case(x, w, None)
    ranks = [r["sync_bn"] for r in env["ranks"]]

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    close(np.concatenate([r["out"] for r in ranks]), whole["out"])
    close(np.concatenate([r["grad_x"] for r in ranks]), whole["grad_x"])
    for name, want in whole["buffers"].items():
        for r in ranks:
            close(np.asarray(r["buffers"][name]), want)
    for name, want in whole["grad_params"].items():
        close(sum(np.asarray(r["grad_params"][name]) for r in ranks), want)
    # unsynchronized halves would not: their statistics differ
    half = worker.sync_bn_case(x[:2], w[:2], None)
    assert not np.allclose(half["buffers"]["block0_bn0.running_mean"],
                           whole["buffers"]["block0_bn0.running_mean"], atol=1e-4)


def test_cache_shard_needs_device_cache(env):
    with pytest.raises(SystemExit, match="--cache_shard shards the device cache: it requires "
                                         "--device_cache"):
        port_train.main([env["cfg_path"], "--cache_shard", "--device", "cpu"])


def test_multihost_outside_torchrun_raises(env, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="--multihost joins a torchrun job"):
        port_test.main([env["cfg_path"], "--checkpoint", env["cli_work"], "--device", "cpu",
                        "--multihost"])
