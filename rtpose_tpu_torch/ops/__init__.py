"""Hand-written CUDA kernels and their plain PyTorch versions."""

from . import conv_k3, preprocess


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {"preprocess": preprocess.launches, "conv3d_k3": conv_k3.launches,
            "conv3d_k3_bwd": conv_k3.launches_bwd}


def reset_launch_counts() -> None:
    preprocess.launches = 0
    conv_k3.launches = 0
    conv_k3.launches_bwd = 0
