"""Export a checkpoint as a self-contained serving artifact (PyTorch port).

Same CLI as ``tools/export.py``, with ``--device`` in place of
``--platforms``::

    python -m rtpose_tpu_torch.tools.export CONFIG --checkpoint CKPT.pth \
        --out model.pt2 [--batch_size B] [--int8 [--calib_batches N] \
        [--int8_resize] [--calib_split val] [--calib_quantile Q]] \
        [--final_dtype {bfloat16,float32}] [--device {cuda,cpu}]

The predict path (forward + sparse decode, or the dense decode of the
LiDAR config's voxel batches) is traced with ``torch.export`` for one
static batch size on one device, the weights baked in; ``--int8``
first calibrates activation scales on the first ``--calib_batches`` batches
of ``--calib_split`` and bakes the int8 program.  Evaluate the artifact
with ``python -m rtpose_tpu_torch.tools.test CONFIG --exported model.pt2``;
serve it with ``rtpose_tpu_torch.export.load_predict``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a serving artifact (PyTorch port)")
    p.add_argument("config", help="config file path")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint .pth file, or a work_dir / checkpoints dir with 'latest'")
    p.add_argument("--out", required=True, help="output artifact path (.pt2)")
    p.add_argument("--batch_size", type=int, default=1, help="static serving batch size")
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 quantization: calibrate activation scales on "
                        "real data, then bake the int8 program into the artifact (head "
                        "output convs stay float)")
    p.add_argument("--calib_batches", type=int, default=8,
                   help="number of calibration batches for --int8")
    p.add_argument("--int8_resize", action="store_true",
                   help="with --int8: also quantize the HRNet final-fuse resizes")
    p.add_argument("--calib_split", default="val", choices=("train", "val", "test"),
                   help="dataset split the calibration batches come from")
    p.add_argument("--calib_quantile", type=float, default=None,
                   help="clip activation scales at this quantile of |x| instead of absmax")
    p.add_argument("--final_dtype", default=None, choices=("bfloat16", "float32"),
                   help="compute dtype of the head OUTPUT convs in the artifact")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the device the artifact is exported for (default the card)")
    return p.parse_args(argv)


def collect_calib_batches(cfg, batch_size: int, n_batches: int, split: str, device,
                          max_poses: int = 1, input_key="rdr_tensor"):
    """Model inputs for activation calibration: the first ``n_batches``
    batches of ``split`` through the same host path the eval loader uses
    (one sample per frame with ``max_poses`` > 1, as there): cubes, or with
    ``input_key`` None the voxel dicts of the LiDAR config."""
    import numpy as np
    import torch

    from rtpose_tpu_torch.api import build_dataset_from_cfg
    from rtpose_tpu_torch.data import BatchLoader
    from rtpose_tpu_torch.engine import model_input_of

    loader = BatchLoader(build_dataset_from_cfg(cfg.data, split, max_poses=max_poses),
                         batch_size=batch_size, shuffle=False, drop_last=False)
    def to_device(a):
        # the batch's arrays may be strided views; the kernels take contiguous inputs
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    batches = []
    for batch in loader:
        x = model_input_of(batch, input_key)
        batches.append({k: to_device(v) for k, v in x.items()} if isinstance(x, dict)
                       else to_device(x))
        if len(batches) >= n_batches:
            break
    if not batches:
        raise SystemExit(f"--int8: no calibration data in split {split!r}")
    return batches


def main(argv=None) -> dict:
    """Export; returns ``{"path", "bytes", "int8_scales", "meta"}``."""
    args = parse_args(argv)
    from rtpose_tpu_torch.api import assemble, resolve_device
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.engine import load_checkpoint, resolve_checkpoint
    from rtpose_tpu_torch.export import calibrate_predict, export_predict, save_exported
    from rtpose_tpu_torch.ops import quant

    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    asm = assemble(cfg)
    asm.model.load_state_dict(load_checkpoint(resolve_checkpoint(args.checkpoint))["state_dict"])
    asm.model.to(device).eval()
    exclude = quant.INT8_RESIZE_EXCLUDE if args.int8_resize else quant.DEFAULT_EXCLUDE
    int8_scales = None
    if args.int8:
        batches = collect_calib_batches(cfg, args.batch_size, args.calib_batches,
                                        args.calib_split, device, asm.target_spec.max_poses,
                                        asm.input_key)
        int8_scales = calibrate_predict(asm, batches, exclude=exclude,
                                        final_dtype=args.final_dtype,
                                        quantile=args.calib_quantile)
        print(f"int8 calibration: {len(int8_scales)} conv scales from {len(batches)} x "
              f"batch-{args.batch_size} {args.calib_split} batches")
    ep = export_predict(asm, batch_size=args.batch_size, device=args.device,
                        int8_scales=int8_scales, int8_exclude=exclude,
                        final_dtype=args.final_dtype)
    save_exported(args.out, ep)
    size = os.path.getsize(args.out)
    n_params = sum(p.numel() for p in asm.model.parameters())
    print(f"exported {args.out}: {size / 1e6:.2f} MB, batch={args.batch_size}, "
          f"device={device.type}, params={n_params}" + (", int8" if int8_scales else ""))
    return dict(path=args.out, bytes=size, int8_scales=int8_scales, meta=ep.rtpose_meta)


if __name__ == "__main__":
    main()
