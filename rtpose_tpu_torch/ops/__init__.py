"""Hand-written CUDA kernels and their plain PyTorch versions.  Importing
this package registers the kernels as ``torch.ops.rtpose`` custom ops
(``ops/library.py``), which a loaded serving artifact needs."""

from . import conv_k3, conv_k3_int8, deform_conv, library, preprocess


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset.  Only the wrappers
    add to them, one per launch, so the replays of a captured CUDA graph,
    which pass no wrapper, are not in them."""
    return {"preprocess": preprocess.launches, "preprocess_single": preprocess.launches_single,
            "conv3d_k3": conv_k3.launches, "conv3d_k3_bwd": conv_k3.launches_bwd,
            "conv3d_k3_int8": conv_k3_int8.launches, "deform_conv2d": deform_conv.launches}


def reset_launch_counts() -> None:
    preprocess.launches = 0
    preprocess.launches_single = 0
    conv_k3.launches = 0
    conv_k3.launches_bwd = 0
    conv_k3_int8.launches = 0
    deform_conv.launches = 0
