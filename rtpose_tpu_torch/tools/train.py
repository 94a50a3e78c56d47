"""Train a detector with the port (PyTorch; CUDA by default).

The CLI of ``tools/train.py`` plus ``--device``::

    python -m rtpose_tpu_torch.tools.train CONFIG [--work_dir DIR] \
        [--resume_from CKPT] [--validate] [--seed N] [--total_epochs N] \
        [--stop_epoch N] [--lr_max X] [--pct_start X] [--div_factor X] \
        [--loc_weight X] [--loc_weight_early X --loc_weight_early_steps N] \
        [--device_preprocess] [--remat] [--device_cache] [--cache_dtype DTYPE] \
        [--stream_cache_gb G] [--fuse_epochs] [--cache_shard] [--multihost] \
        [--profile N] [--device {cuda,cpu}]

Writes ``<work_dir>/exp_config.py``, the text and JSON logs, and
``<work_dir>/checkpoints/epoch_N.pth`` with a ``latest`` pointer, which
``python -m rtpose_tpu_torch.tools.test`` evaluates as they are.  The seed
initializes the weights (``models.init_weights`` on a ``torch.Generator``)
and the loader's shuffle.  TensorBoard scalars are written when the
config's ``log_config.hooks`` lists ``TensorboardLoggerHook`` and the
``tensorboard`` package is installed.

``--device_cache`` (or ``data.device_cache`` in the config) uploads the
training set once and gathers every batch on the device; ``--cache_dtype``
stores its large float arrays compressed; ``--stream_cache_gb`` does the
same chunk by chunk for a set larger than the device's memory;
``--fuse_epochs`` (with ``--device_cache``) runs each epoch as replays of
one captured CUDA graph of the train step, with no Python between a step's
operations (on the CPU: a plain loop).

``--multihost``: data parallelism over the processes of a ``torchrun`` job,
one per card (NCCL; gloo with ``--device cpu``)::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m rtpose_tpu_torch.tools.train CONFIG --multihost ...

Each rank trains on its shard of every global batch of
``samples_per_gpu x N`` samples, and the step is the gradient of the global
batch's loss (``parallel``); only rank 0 writes logs and checkpoints.
``--cache_shard`` (with ``--device_cache``) splits the device cache by rows
over the ranks, so the cacheable set grows with them; each batch is then
exchanged by a collective.  The LiDAR
config (``configs/lidar/voxelnet_pose.py``, VoxelNet on voxel batches)
trains with the same flags except ``--device_preprocess`` (radar cubes
only; refused, as the JAX CLI fails on it).
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector (PyTorch port)")
    p.add_argument("config", help="train config file path")
    p.add_argument("--work_dir", help="dir to save logs and models")
    p.add_argument("--resume_from", help="checkpoint (.pth, or a dir with 'latest') to resume from")
    p.add_argument("--validate", action="store_true",
                   help="evaluate on the val set during training")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--total_epochs", type=int, default=None,
                   help="override cfg.total_epochs")
    p.add_argument("--stop_epoch", type=int, default=None,
                   help="stop after this many epochs without shortening the lr "
                        "schedule (total_epochs still sizes one-cycle)")
    p.add_argument("--lr_max", type=float, default=None,
                   help="override cfg.lr_config.lr_max (one-cycle peak)")
    p.add_argument("--pct_start", type=float, default=None,
                   help="override cfg.lr_config.pct_start (warm-up fraction)")
    p.add_argument("--div_factor", type=float, default=None,
                   help="override cfg.lr_config.div_factor (start lr = lr_max / div_factor)")
    p.add_argument("--loc_weight", type=float, default=None,
                   help="override the head's hm-vs-loc loss balance weight")
    p.add_argument("--loc_weight_early", type=float, default=None,
                   help="use this loc weight for the first --loc_weight_early_steps steps")
    p.add_argument("--loc_weight_early_steps", type=int, default=0)
    p.add_argument("--device_preprocess", action="store_true",
                   help="ship ROI-cropped raw cubes; cast/normalize/layout run on "
                        "the card (preprocess kernel)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward "
                        "(torch.utils.checkpoint) instead of keeping activations")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="capture a torch.profiler trace of N train steps into "
                        "<work_dir>/profile/trace.json")
    p.add_argument("--device_cache", action="store_true",
                   help="upload the whole training set to the device once and build "
                        "batches with gathers there (sets that fit in half of the "
                        "card's free memory; no per-step host-to-device traffic)")
    p.add_argument("--cache_dtype", default=None,
                   help="store the device cache compressed (bfloat16 halves it, "
                        "float8_e4m3fn quarters it: run the trajectory gate before "
                        "trusting a new dtype); only large float keys (the cubes) "
                        "compress, pose labels keep full precision; batches are cast "
                        "back after the gather")
    p.add_argument("--stream_cache_gb", type=float, default=None,
                   help="device-resident batches for sets larger than the device's "
                        "memory: chunks of this many GB, the next one uploaded while "
                        "the resident one trains (block-shuffle semantics)")
    p.add_argument("--fuse_epochs", action="store_true",
                   help="with --device_cache: run each epoch as replays of one "
                        "captured CUDA graph of the train step (no per-step host "
                        "dispatch; per-iteration hooks do not fire)")
    p.add_argument("--cache_shard", action="store_true",
                   help="shard the device cache by rows across the ranks (cacheable "
                        "set scales with the cards instead of one card's memory; "
                        "batch gathers ride collectives)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun job (torch.distributed from torchrun's "
                        "environment, one process per card)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run on the card (default) or the CPU")
    return p.parse_args(argv)


def device_cache_cap(device):
    """Most bytes ``--device_cache`` may put on the card: half of the memory
    free on it when the cache is built; the other half stays for the
    parameters, the optimizer's state and a step's activations.  No cap on
    the CPU, where the cache lies in host memory."""
    if device.type != "cuda":
        return None
    import torch
    return torch.cuda.mem_get_info(device)[0] // 2


def main(argv=None):
    """Run the training; returns the Trainer."""
    args = parse_args(argv)
    if args.loc_weight_early is not None and args.loc_weight_early_steps <= 0:
        raise SystemExit("--loc_weight_early needs --loc_weight_early_steps N (> 0)")
    if args.fuse_epochs and args.stream_cache_gb:
        raise SystemExit("--fuse_epochs needs the whole dataset resident "
                         "(--device_cache); the streaming loader runs "
                         "per-step — drop one of the flags")
    import numpy as np
    import torch

    from rtpose_tpu_torch import parallel
    from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg, resolve_device
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import BatchLoader, DeviceCachedLoader, StreamingDeviceLoader
    from rtpose_tpu_torch.engine import (ProfilerHook, Trainer, create_train_state,
                                         get_root_logger, make_eval_step, make_train_step,
                                         run_eval)
    from rtpose_tpu_torch.models import init_weights
    from rtpose_tpu_torch.solver import (build_optimizer_from_cfg, make_one_cycle_fns,
                                         piecewise_weight)

    cfg = Config.fromfile(args.config)
    device_cache = args.device_cache or cfg.data.get("device_cache", False)
    if args.cache_shard and not device_cache:
        raise SystemExit("--cache_shard shards the device cache: it requires "
                         "--device_cache")
    device = resolve_device(args.device, multihost=args.multihost)
    writer = parallel.process_index() == 0
    work_dir = args.work_dir or os.path.join(
        "./work_dirs", os.path.basename(args.config)[:-3],
        datetime.now().strftime("%Y%m%d_%H%M%S"))
    os.makedirs(work_dir, exist_ok=True)
    # the text log file and the config backup are rank 0's
    logger = get_root_logger(cfg.get("log_level", "INFO"), work_dir=work_dir if writer else None)
    if writer:
        with open(os.path.join(work_dir, "exp_config.py"), "w") as f:
            f.write(cfg.text)
    seed = args.seed or 0
    if args.seed is not None:
        logger.info(f"Set random seed to {args.seed}")
        np.random.seed(args.seed)

    asm = assemble(cfg)
    if args.device_preprocess and asm.sensor != "radar":
        # the JAX CLI fails here too (its LiDAR dataset takes no such argument)
        raise SystemExit("--device_preprocess ships raw radar cubes; the LiDAR config "
                         "(VoxelNet) reads point clouds — drop the flag")
    total_epochs = args.total_epochs or int(cfg.total_epochs)
    dataset = build_dataset_from_cfg(cfg.data, "train", max_poses=asm.target_spec.max_poses,
                                     device_preprocess=args.device_preprocess)
    preprocess = ((dataset.norm_start, dataset.norm_scale)
                  if dataset.device_preprocess else None)
    # samples_per_gpu per rank: the global batch is that times the ranks
    batch_size = int(cfg.data["samples_per_gpu"])
    num_workers = int(cfg.data.get("workers_per_gpu", 0))
    shards = dict(num_shards=parallel.process_count(), shard_id=parallel.process_index())
    if device_cache:
        loader = DeviceCachedLoader(dataset, batch_size=batch_size, device=device,
                                    shuffle=True, seed=seed, cache_dtype=args.cache_dtype,
                                    max_bytes=device_cache_cap(device),
                                    shard_cache=args.cache_shard, **shards)
        held = (f"rows {loader.shard.lo}-{loader.shard.hi - 1} of {len(dataset)} samples"
                if loader.shard is not None else f"{len(dataset)} samples")
        logger.info(f"device-cached {held} ({loader.nbytes / 1e9:.2f} GB on {device})")
    elif args.stream_cache_gb:
        loader = StreamingDeviceLoader(dataset, batch_size=batch_size,
                                       chunk_bytes=int(args.stream_cache_gb * 1e9),
                                       device=device, shuffle=True, seed=seed,
                                       cache_dtype=args.cache_dtype, **shards)
        logger.info(f"streaming device cache: {len(loader.chunks)} chunks x "
                    f"{loader.samples_per_chunk} samples (double-buffered)")
    else:
        loader = BatchLoader(dataset, batch_size=batch_size, shuffle=True, seed=seed,
                             num_workers=num_workers, **shards)
    total_steps = len(loader) * total_epochs

    lr_cfg = dict(cfg.lr_config)
    for k in ("lr_max", "pct_start", "div_factor"):
        if getattr(args, k) is not None:
            lr_cfg[k] = getattr(args, k)
            cfg.lr_config[k] = getattr(args, k)   # build_optimizer_from_cfg reads cfg
    lr_fn, _ = make_one_cycle_fns(total_steps, float(lr_cfg["lr_max"]),
                                  tuple(lr_cfg.get("moms", (0.95, 0.85))),
                                  float(lr_cfg.get("div_factor", 10.0)),
                                  float(lr_cfg.get("pct_start", 0.4)))

    model = init_weights(asm.model, torch.Generator().manual_seed(seed)).to(device)
    optimizer = build_optimizer_from_cfg(cfg, list(model.parameters()), total_steps)
    state = create_train_state(model, optimizer)
    parallel.broadcast_state(model, optimizer)     # the JAX package's replicate
    logger.info(f"Model parameter count: {sum(p.numel() for p in model.parameters())}")

    loc_weight_fn = None
    if args.loc_weight is not None or args.loc_weight_early is not None:
        base_w = args.loc_weight if args.loc_weight is not None else float(asm.head.weight)
        loc_weight_fn = piecewise_weight(base_w, args.loc_weight_early,
                                         args.loc_weight_early_steps)
        logger.info(f"loc-weight schedule: base={base_w} early={args.loc_weight_early}"
                    f"@{args.loc_weight_early_steps} steps")
    train_step = make_train_step(model, asm.head, asm.target_spec, optimizer, lr_fn=lr_fn,
                                 input_key=asm.input_key, sparse_reg=asm.sparse_head,
                                 remat=args.remat,
                                 preprocess=preprocess, loc_weight_fn=loc_weight_fn)
    log_cfg = dict(cfg.log_config)
    # TensorBoard scalars where the config lists the reference's hook
    tensorboard = any(dict(h).get("type") == "TensorboardLoggerHook"
                      for h in log_cfg.get("hooks", []))
    trainer = Trainer(train_step, state, work_dir=work_dir, total_epochs=total_epochs,
                      device=device, lr_fn=lr_fn, enable_tensorboard=tensorboard,
                      log_interval=int(log_cfg.get("interval", 20)),
                      checkpoint_interval=int(dict(cfg.checkpoint_config).get("interval", 5)),
                      meta=dict(config=cfg.text), logger=logger,
                      fuse_epochs=args.fuse_epochs, stop_epoch=args.stop_epoch)
    if args.profile:
        trainer.register_hook(ProfilerHook(num_steps=args.profile))
    if args.resume_from or cfg.get("resume_from"):
        trainer.resume(args.resume_from or cfg.resume_from)

    eval_fn = val_loader = None
    if args.validate:
        val_dataset = build_dataset_from_cfg(cfg.data, "val",
                                             max_poses=asm.target_spec.max_poses,
                                             device_preprocess=args.device_preprocess)
        val_loader = BatchLoader(val_dataset, batch_size=batch_size, num_workers=num_workers,
                                 **shards)
        eval_step = make_eval_step(model, asm.decode_spec, input_key=asm.input_key,
                                   sparse=asm.sparse_head, preprocess=preprocess,
                                   multi_poses=asm.multi_poses)

        def eval_fn(state, loader, epoch):
            dets, _ = run_eval(eval_step, loader, asm.decode_spec, device=device,
                               one_hm=asm.one_hm, logger=logger)
            if not writer:
                return
            res, _ = val_dataset.evaluation(dets)
            for k, v in res["results"].items():
                logger.info(f"[val epoch {epoch}] {k}: {v:.2f}")

    workflow = [tuple(w) for w in cfg.get("workflow", [("train", 1)])]
    if args.validate and ("val", 1) not in workflow:
        workflow.append(("val", 1))
    trainer.run(loader, val_loader, workflow=workflow, eval_fn=eval_fn)
    logger.info("training complete")
    return trainer


if __name__ == "__main__":
    main()
    from rtpose_tpu_torch import parallel
    parallel.shutdown()
