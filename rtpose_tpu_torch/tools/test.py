"""Evaluate a checkpoint with the port (PyTorch; CUDA by default).

Same CLI as ``tools/test.py`` plus ``--device``::

    python -m rtpose_tpu_torch.tools.test CONFIG --checkpoint CKPT.pth \
        [--work_dir DIR] [--testset] [--speed_test] [--device_preprocess] \
        [--final_dtype {bfloat16,float32}] [--profile] [--multihost] [--device {cuda,cpu}]
    python -m rtpose_tpu_torch.tools.test CONFIG --exported model.pt2 \
        [--testset] [--speed_test] [--device {cuda,cpu}]

``--checkpoint`` is a reference-format ``.pth`` (``{"meta", "state_dict"}``,
as ``rtpose_tpu_torch.tools.train`` writes them), or a directory whose
``latest`` file names one.
Writes ``<work_dir>/<ckpt>/{split}_prediction.json`` and
``<ckpt>_seq_results_{split}.json`` and prints ``Evaluation MPJPE: ...``;
``--speed_test`` runs batch 1 and prints ``Total time per frame``;
``--profile`` writes a ``torch.profiler`` Chrome trace of the whole eval to
``<work_dir>/profile/trace.json``.  ``--exported`` evaluates a serving
artifact (``rtpose_tpu_torch.tools.export``) instead of the live model: the
weights, the int8 program and ``final_dtype`` come baked in, the batch size
is the artifact's, and the outputs are named after the artifact file.

``--multihost`` (under ``python -m torch.distributed.run --nproc_per_node N``):
each rank evaluates its shard of the frames, the detections of every rank
are gathered and merged by key, and only rank 0 writes the predictions and
prints the evaluation; ``--speed_test`` times each rank's own frames.

The LiDAR config evaluates voxel batches; with ``test_cfg.double_flip``
(and the test pipeline's ``Voxelization.double_flip``) the live model runs
the double-flip TTA, one forward per voxel set of a frame.  An artifact
runs the plain forward, as the JAX CLI's does.  ``--device_preprocess`` is
refused on it (radar cubes only).
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a detector (PyTorch port)")
    p.add_argument("config", help="config file path")
    p.add_argument("--work_dir", help="output dir")
    p.add_argument("--checkpoint",
                   help="checkpoint .pth file, or a work_dir / checkpoints dir with "
                        "'latest'; required unless --exported (artifacts bake their weights)")
    p.add_argument("--speed_test", action="store_true")
    p.add_argument("--testset", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun job (torch.distributed from torchrun's "
                        "environment, one process per card)")
    p.add_argument("--device_preprocess", action="store_true",
                   help="ship ROI-cropped RAW cubes; cast/normalize/layout "
                        "run on the card (preprocess kernel)")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of the whole eval into "
                        "<work_dir>/profile/trace.json")
    p.add_argument("--final_dtype", default=None, choices=("bfloat16", "float32"),
                   help="override the head OUTPUT convs' compute dtype")
    p.add_argument("--exported", default=None, metavar="ARTIFACT",
                   help="evaluate a serving artifact (rtpose_tpu_torch.tools.export) "
                        "instead of the live model")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run on the card (default) or the CPU")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the evaluation; returns the results dict (also printed).  On a
    rank other than 0 its ``results`` are None: that rank writes and prints
    nothing."""
    args = parse_args(argv)
    from rtpose_tpu_torch import parallel
    from rtpose_tpu_torch.api import (assemble, build_dataset_from_cfg,
                                      resolve_device, serving_variant)
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import BatchLoader
    from rtpose_tpu_torch.engine import (EvalGraphs, load_checkpoint, make_eval_step,
                                         model_input_of, resolve_checkpoint, run_eval,
                                         save_predictions)
    from rtpose_tpu_torch.engine.hooks import start_trace, stop_trace

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("rtpose_tpu_torch")
    if not args.checkpoint and not args.exported:
        raise SystemExit("one of --checkpoint or --exported is required")
    if args.exported and args.final_dtype:
        raise SystemExit("--final_dtype applies to the live model; exported artifacts "
                         "bake their own (tools/export.py --final_dtype)")
    if args.exported and args.device_preprocess:
        raise SystemExit("--exported artifacts bake the normalized-input predict path; "
                         "--device_preprocess (raw cubes) would feed them un-normalized "
                         "data — drop one of the flags")
    device = resolve_device(args.device, multihost=args.multihost)
    cfg = Config.fromfile(args.config)
    ckpt_path = resolve_checkpoint(args.checkpoint) if args.checkpoint else None
    work_dir = args.work_dir or os.path.dirname(os.path.abspath(ckpt_path or args.exported))
    asm = assemble(cfg)
    if args.device_preprocess and asm.sensor != "radar":
        # the JAX CLI fails here too (its LiDAR dataset takes no such argument)
        raise SystemExit("--device_preprocess ships raw radar cubes; the LiDAR config "
                         "(VoxelNet) reads point clouds — drop the flag")
    if args.exported:
        from rtpose_tpu_torch.export import load_predict
        predict = load_predict(args.exported, device=device.type)
        batch_size = int(predict.meta["batch_size"])
        logger.info(f"serving artifact: device={predict.meta['device']}, batch={batch_size}, "
                    f"int8 sites={predict.meta['int8_sites']}, "
                    f"final_dtype={predict.meta['final_dtype']}")
        if args.speed_test and batch_size != 1:
            logger.warning(f"--speed_test with --exported times the artifact's baked batch "
                           f"size ({batch_size}), NOT the reference's batch-1 protocol — "
                           f"export with --batch_size 1 for comparable numbers")
    else:
        asm.model.load_state_dict(load_checkpoint(ckpt_path)["state_dict"])
        if args.final_dtype:
            asm = serving_variant(asm, args.final_dtype)
            logger.info(f"head output convs overridden to {args.final_dtype}")
        model = asm.model.to(device).eval()
        logger.info("Model parameter count: "
                    f"{sum(p.numel() for p in model.parameters())}")
        batch_size = 1 if args.speed_test else int(cfg.data["samples_per_gpu"])

    split = "test" if args.testset else "val"
    print("Use Test Set" if args.testset else "Use Val Set")
    dataset = build_dataset_from_cfg(cfg.data, split, max_poses=asm.target_spec.max_poses,
                                     device_preprocess=args.device_preprocess)
    preprocess = ((dataset.norm_start, dataset.norm_scale)
                  if dataset.device_preprocess else None)
    loader = BatchLoader(dataset, batch_size=batch_size,
                         num_workers=int(cfg.data.get("workers_per_gpu", 0)),
                         num_shards=parallel.process_count(),
                         shard_id=parallel.process_index())
    if args.exported:
        def eval_step(batch):
            return predict(model_input_of(batch, asm.input_key))
    else:
        eval_step = make_eval_step(model, asm.decode_spec, input_key=asm.input_key,
                                   sparse=asm.sparse_head, preprocess=preprocess,
                                   multi_poses=asm.multi_poses,
                                   tta_double_flip=asm.tta_double_flip)
        if asm.tta_double_flip:
            logger.info("double-flip TTA: averaging the unflipped forwards of every "
                        "voxel set per frame (test_cfg.double_flip)")
    prof = start_trace(device) if args.profile else None
    try:
        detections, sec_per_frame = run_eval(
            eval_step, loader, asm.decode_spec, device=device, one_hm=asm.one_hm,
            speed_test=args.speed_test, logger=logger)
    finally:
        if prof is not None:
            path = stop_trace(prof, device, os.path.join(work_dir, "profile"))
            logger.info(f"profiler trace written to {path}")
    if sec_per_frame is not None:
        print(f"\n Total time per frame: {sec_per_frame}")
    # the eval step's (or the artifact's) CUDA graph counters (its replays
    # pass no kernel wrapper)
    replayed = predict.graphs if args.exported else eval_step
    graphs = replayed.counts() if isinstance(replayed, EvalGraphs) else None
    if parallel.process_index() != 0:
        sys.stdout.flush()
        return dict(results=None, sec_per_frame=sec_per_frame, detections=detections,
                    eval_graphs=graphs)

    os.makedirs(work_dir, exist_ok=True)
    # an artifact's outputs are named after the artifact file
    ckpt_name = os.path.basename(ckpt_path or args.exported).split(".")[0]
    tag = "test" if args.testset else "train"
    save_predictions(detections, work_dir, ckpt_name, tag)
    result_dict, _ = dataset.evaluation(copy.deepcopy(detections),
                                        output_dir=work_dir, testset=args.testset)
    for k, v in result_dict["results"].items():
        print(f"Evaluation {k}: {v}")
    seq_path = os.path.join(work_dir, ckpt_name, f"{ckpt_name}_seq_results_{tag}.json")
    with open(seq_path, "w") as f:
        json.dump(dict(sorted(result_dict["seq_results"].items())), f, indent=2)
    sys.stdout.flush()
    return dict(results=result_dict["results"], sec_per_frame=sec_per_frame,
                detections=detections, eval_graphs=graphs)


if __name__ == "__main__":
    main()
    from rtpose_tpu_torch import parallel
    parallel.shutdown()
