"""Attribute the int8 serving path's accuracy loss on a checkpoint (port).

Same CLI as ``tools/int8_diag.py``, on the port's ``.pth``, plus
``--device``::

    python -m rtpose_tpu_torch.tools.int8_diag CONFIG --checkpoint CKPT.pth \
        [--frames 64] [--calib_batches 8] [--quantile 0.999] [--groups] \
        [--device {cuda,cpu}]

1. prints the calibrated activation-scale spectrum, largest first (an
   absmax blown up by outliers crushes the useful int8 range);
2. the MPJPE of the live (bf16) model on a test subset, then of int8 with
   every site, and with ``--groups`` of int8 on only one group of sites and
   on all but one group; with ``--quantile`` of quantile-clipped scales.

It reads radar cubes: the LiDAR config is refused, as the JAX tool fails on
it; its int8 artifact is measured with ``tools.test --exported``.
"""

from __future__ import annotations

import argparse

# site groups by path substring (backbone stages against head towers)
GROUPS = [
    ("reader/first convs", ("reader", "stem", "layer1")),
    ("stage2", ("stage2",)),
    ("stage3", ("stage3",)),
    ("stage4", ("stage4",)),
    ("transitions", ("transition",)),
    ("final_conv", ("final_conv",)),
    ("head shared conv", ("shared_conv",)),
    ("hm tower", ("hm",)),
    ("reg tower", ("reg",)),
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="int8 serving-path diagnosis (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--frames", type=int, default=64,
                   help="test-subset size for the MPJPE probes")
    p.add_argument("--calib_batches", type=int, default=8)
    p.add_argument("--quantile", type=float, default=None,
                   help="also probe percentile-clipped calibration")
    p.add_argument("--groups", action="store_true",
                   help="run the exclusion-group bisection probes")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the probes; returns {"base_mm", "scales", "probes": {label: mm}}."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from rtpose_tpu_torch.api import assemble, build_dataset_from_cfg, resolve_device
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.engine import load_checkpoint, resolve_checkpoint
    from rtpose_tpu_torch.export import calibrate_predict, make_predict_fn
    from rtpose_tpu_torch.ops import quant

    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    asm = assemble(cfg)
    if asm.sensor != "radar":
        # the JAX tool reads radar cubes only (it fails on the LiDAR config)
        raise SystemExit("int8_diag reads radar cubes; the LiDAR config (VoxelNet) is not "
                         "supported — measure its int8 artifact with tools.test --exported")
    asm.model.load_state_dict(load_checkpoint(resolve_checkpoint(args.checkpoint))["state_dict"])
    asm.model.to(device).eval()

    B = 8
    calib_ds = build_dataset_from_cfg(cfg.data, "val")
    test_ds = build_dataset_from_cfg(cfg.data, "test")

    def batch_of(ds, lo):
        items = [ds[i % len(ds)] for i in range(lo, lo + B)]
        # np.stack keeps the items' transposed layout; the kernels take contiguous inputs
        x = torch.from_numpy(np.ascontiguousarray(np.stack([it["rdr_tensor"] for it in items])))
        x = x.to(device)
        return x, np.stack([np.asarray(it["poses"][0]) for it in items])

    calib = [batch_of(calib_ds, i * B)[0] for i in range(args.calib_batches)]
    n_eval = min(args.frames, len(test_ds)) // B * B
    eval_batches = [batch_of(test_ds, i) for i in range(0, n_eval, B)]
    print(f"# calib {len(calib)}xB{B} val, eval {n_eval} test frames")

    def mpjpe_of(predict):
        errs = []
        for x, gt in eval_batches:
            kp = predict(x)[0][0].float().cpu().numpy()
            errs.append(np.linalg.norm(kp - gt, axis=-1).mean(axis=1))
        return float(np.concatenate(errs).mean() * 1000.0)

    base = mpjpe_of(make_predict_fn(asm))
    print(f"live subset MPJPE: {base:.2f} mm")
    probes = {}

    scales = calibrate_predict(asm, calib)
    print(f"\n# {len(scales)} calibrated sites; act absmax spectrum (scale*127), "
          f"largest first:")
    for k, v in sorted(scales.items(), key=lambda kv: -kv[1]):
        print(f"  {v * 127.0:12.3f}  {k}")

    def int8_mpjpe(sc, label):
        m = mpjpe_of(make_predict_fn(asm, int8_scales=sc, int8_exclude=quant.DEFAULT_EXCLUDE))
        print(f"{label:<44} MPJPE {m:9.2f} mm  (+{m - base:.2f})")
        probes[label] = m
        return m

    int8_mpjpe(scales, "int8 ALL")

    if args.groups:
        def subset(pred):
            return {k: v for k, v in scales.items() if pred(k)}

        print("\n# ONLY-group probes (everything else float):")
        for name, pats in GROUPS:
            sc = subset(lambda k, ps=pats: any(p in k for p in ps))
            if sc:
                int8_mpjpe(sc, f"only {name} ({len(sc)} sites)")
        print("\n# ALL-BUT-group probes:")
        for name, pats in GROUPS:
            sc = subset(lambda k, ps=pats: not any(p in k for p in ps))
            if len(sc) != len(scales):
                int8_mpjpe(sc, f"all but {name} ({len(sc)} sites)")

    if args.quantile:
        q = args.quantile
        qscales = calibrate_predict(asm, calib, quantile=q)
        shrink = [scales[k] / qscales[k] for k in qscales if qscales[k] > 0 and k in scales]
        print(f"\n# quantile {q}: median absmax shrink {float(np.median(shrink)):.2f}x, "
              f"max {float(np.max(shrink)):.2f}x")
        int8_mpjpe(qscales, f"int8 ALL @ q={q}")
    return dict(base_mm=base, scales=scales, probes=probes)


if __name__ == "__main__":
    main()
