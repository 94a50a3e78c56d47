"""One rank of the port's data-parallel run on the CPU (``tests/test_torch_multihost.py``).

Launched by ``python -m torch.distributed.run --standalone --nproc_per_node 2``;
joins the job as the CLIs do (``resolve_device("cpu", multihost=True)``,
gloo) and, on the tiny config and root the test made:

1. two train steps (``make_train_step`` under the group) on this rank's half
   of a deterministic global batch of 8 frames, one of them without a
   person, from ``init_weights`` of seed 0, the optimizer the config builds
   for 4 steps at ``lr_max`` LR_MAX;
2. a third step whose batch is NaN on rank 1 only;
3. ``all_gather_objects`` of the rank's id and last loss;
   then an RPN neck with ``sync_bn_axis`` in train mode, twice, on this
   rank's half of a deterministic (4, 6, 6, 3) batch (``sync_bn_case``):
   its output, running statistics, input gradient and parameter gradients;
4. ``tools.train.main`` with ``--multihost --device_cache --fuse_epochs``,
   with and without ``--cache_shard``;
5. ``tools.test.main --multihost`` on the checkpoint of the CLI run the test
   made before.

Writes ``<out>/rank<R>.json`` and ``<out>/rank<R>_params.npz`` (the flat
parameters after steps 1, 2 and each run of 4).

Usage: torch_multihost_worker.py CONFIG OUT CLI_WORK_DIR LR_MAX
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtpose_tpu_torch import parallel  # noqa: E402
from rtpose_tpu_torch.api import assemble, resolve_device  # noqa: E402
from rtpose_tpu_torch.config import Config  # noqa: E402
from rtpose_tpu_torch.engine import create_train_state, make_train_step  # noqa: E402
from rtpose_tpu_torch.models import init_weights  # noqa: E402
from rtpose_tpu_torch.solver import build_optimizer_from_cfg, make_one_cycle_fns  # noqa: E402
from rtpose_tpu_torch.tools import test as port_test  # noqa: E402
from rtpose_tpu_torch.tools import train as port_train  # noqa: E402

GLOBAL_BATCH = 8
NUM_POSES = [1, 1, 0, 1, 1, 1, 1, 1]
TOTAL_STEPS = 4


def global_batch(asm):
    """The deterministic global batch (the same numpy draws on every rank
    and in the test)."""
    z, y, x, c = asm.input_shape_zyxc
    spec = asm.target_spec
    rng = np.random.default_rng(0)
    extent = np.array([x, y, z]) * np.array(spec.voxel_size_xyz)
    poses = (np.array(spec.pc_range_min_xyz)
             + rng.uniform(0.2, 0.8, size=(GLOBAL_BATCH, 1, 15, 3)) * extent)
    return {"rdr_tensor": rng.normal(size=(GLOBAL_BATCH, z, y, x, c)).astype(np.float32),
            "poses": poses.astype(np.float32),
            "num_poses": np.asarray(NUM_POSES, np.int32)}


SYNC_BN_RPN = dict(layer_nums=(1,), ds_layer_strides=(1,), ds_num_filters=(4,),
                   us_layer_strides=(1,), us_num_filters=(5,), num_input_features=3)


def sync_bn_input():
    """The deterministic global batch of the sync BatchNorm case and the
    weights of its loss, sum(out * weights)."""
    rng = np.random.default_rng(1)
    return (rng.normal(loc=0.3, size=(4, 6, 6, 3)).astype(np.float32),
            rng.normal(size=(4, 6, 6, 5)).astype(np.float32))


def sync_bn_case(x, w, sync_bn_axis):
    """Two train-mode calls of a seed-0 RPN on ``x``; the second's loss
    sum(out * w) differentiated.  Returns output, running stats, input
    gradient and the parameters' gradients as lists."""
    from rtpose_tpu_torch.models import RPN
    rpn = init_weights(RPN(**SYNC_BN_RPN, sync_bn_axis=sync_bn_axis),
                       torch.Generator().manual_seed(0))
    xt = torch.from_numpy(x).requires_grad_(True)
    rpn(xt, train=True)
    out = rpn(xt, train=True)
    (out * torch.from_numpy(w)).sum().backward()
    return dict(out=out.detach().numpy().tolist(),
                buffers={k: v.numpy().tolist() for k, v in rpn.named_buffers()},
                grad_x=xt.grad.numpy().tolist(),
                grad_params={k: p.grad.numpy().tolist() for k, p in rpn.named_parameters()})


def flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy().copy()


def main():
    cfg_path, out, cli_work, lr_max = sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4])
    torch.set_num_threads(1)
    device = resolve_device("cpu", multihost=True)
    rank, world = parallel.process_index(), parallel.process_count()
    res = {"rank": rank, "world": world}
    params = {}

    cfg = Config.fromfile(cfg_path)
    cfg.lr_config["lr_max"] = lr_max
    asm = assemble(cfg)
    model = init_weights(asm.model, torch.Generator().manual_seed(0))
    opt = build_optimizer_from_cfg(cfg, list(model.parameters()), TOTAL_STEPS)
    lr_fn, _ = make_one_cycle_fns(TOTAL_STEPS, lr_max)
    parallel.broadcast_state(model, opt)
    step = make_train_step(model, asm.head, asm.target_spec, opt, lr_fn=lr_fn,
                           sparse_reg=asm.sparse_head)
    state = create_train_state(model, opt)
    n = GLOBAL_BATCH // world
    mine = {k: torch.from_numpy(v[rank * n:(rank + 1) * n])
            for k, v in global_batch(asm).items()}
    res["steps"] = []
    for i in range(2):
        state, m = step(state, mine)
        res["steps"].append({k: float(m[k]) for k in ("loss", "hm_loss", "loc_loss",
                                                      "num_positive", "grad_norm", "skipped")})
        params[f"step{i + 1}"] = flat_params(model)

    bad = dict(mine, rdr_tensor=torch.full_like(mine["rdr_tensor"], float("nan"))) \
        if rank == 1 else mine
    state, m = step(state, bad)
    res["nan_step"] = dict(loss=float(m["loss"]), skipped=float(m["skipped"]),
                           optimizer_steps=int(opt.step_count), global_step=int(state.step),
                           unchanged=bool(np.array_equal(flat_params(model), params["step2"])))

    x, w = sync_bn_input()
    half = x.shape[0] // world
    res["sync_bn"] = sync_bn_case(x[rank * half:(rank + 1) * half],
                                  w[rank * half:(rank + 1) * half], "data")

    res["gathered"] = parallel.all_gather_objects({"rank": rank,
                                                   "last_loss": res["steps"][-1]["loss"]})

    base = [cfg_path, "--seed", "0", "--device", "cpu", "--multihost", "--device_cache",
            "--fuse_epochs", "--lr_max", str(lr_max)]
    for tag, extra in (("cache", []), ("cache_shard", ["--cache_shard"])):
        work = os.path.join(out, tag)
        trainer = port_train.main(base + ["--work_dir", work] + extra)
        es = trainer.epoch_step
        res[tag] = dict(losses=list(trainer.log_buffer.val_history["loss"]),
                        fused=es is not None, replays=es.replays if es else 0,
                        shard=getattr(trainer.loader, "shard", None) is not None,
                        files=sorted(os.listdir(work)))
        params[tag] = flat_params(trainer.state.model)

    out_test = port_test.main([cfg_path, "--checkpoint", cli_work, "--testset", "--device",
                               "cpu", "--multihost", "--work_dir", os.path.join(out, "test")])
    res["test"] = dict(mpjpe=None if out_test["results"] is None
                       else out_test["results"]["MPJPE"],
                       keys=sorted(out_test["detections"]))

    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out, f"rank{rank}_params.npz"), **params)
    parallel.shutdown()


if __name__ == "__main__":
    main()
