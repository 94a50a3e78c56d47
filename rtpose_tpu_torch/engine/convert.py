"""Carry JAX parameters into the port's ``state_dict``.

``state_dict_from_jax(params)`` takes the ``rtpose_tpu`` RadarPoseNet,
VoxelNet or Distillation variables (nested dicts of numpy arrays: a params
tree, or ``{"params": ..., "batch_stats": ...}``) and returns the port's
state dict.  The ``batch_stats`` collection (the RPN neck's BatchNorm)
gives ``running_mean`` / ``running_var`` from ``mean`` / ``var``.  Keys follow the reference
torch model — the names ``rtpose_tpu/engine/torch_import.py::
build_name_map`` maps the other way, so a port checkpoint also loads back
into flax.  Layouts: conv kernels (kz, ky, kx, Ci, Co) -> (Co, Ci, kz, ky,
kx), the deformable head's 2-D kernels (ky, kx, Ci, Co) -> (Co, Ci, ky,
kx), dense kernels (Ci, Co) -> (Co, Ci); the neck's transposed-conv
kernels (``*_deconv``, (s, s, Ci, Co), no kernel flip in flax) ->
``ConvTranspose2d``'s (Ci, Co, s, s), spatially flipped; GroupNorm,
LayerNorm and BatchNorm ``scale`` -> ``weight``.  The flax submodules
``neck_m``, ``student_m`` and ``teacher_m`` are the port's ``neck``,
``student`` and ``teacher``; the RPN neck, the RoI head and the deformable
head keep the flax module names below them.  A VoxelNet's ``reader_m`` holds parameters only for
``PillarFeatureNet``, whose ``Dense_i`` / ``LayerNorm_i`` become
``reader.linears.i`` / ``reader.norms.i``.  The deformable head
(``models/dcn_head.py``) keeps the flax module names, which
``rtpose_tpu/engine/torch_import.py`` does not know.

``site_paths(model)`` goes the other way for the int8 quant sites: each
site module of the port -> its flax path, the key of a scales dict.

Checkpoints are ``.pth`` files ``{"meta": {...}, "state_dict": {...}}``
(training adds ``"optimizer"``), the reference format.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Dict, List

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}

_RULES = [
    (re.compile(r"^transition(\d+)_b(\d+)_j(\d+)$"), r"transition\1.\2.\3"),
    (re.compile(r"^transition(\d+)_b(\d+)$"), r"transition\1.\2"),
    (re.compile(r"^(stage\d+)_m(\d+)$"), r"\1.\2"),
    (re.compile(r"^branch(\d+)_block(\d+)$"), r"branches.\1.\2"),
    (re.compile(r"^fuse(\d+)_(\d+)_k(\d+)$"), r"fuse_layers.\1.\2.\3"),
    (re.compile(r"^fuse(\d+)_(\d+)$"), r"fuse_layers.\1.\2"),
    (re.compile(r"^task(\d+)$"), r"tasks.\1"),
]


def _segment(name: str, parent: str, siblings: List[str]) -> str:
    """One flax path segment -> its torch module-path segment."""
    if name == "backbone_m":
        return "backbone"
    if name == "head_m":
        return "pose_head"
    if name == "reader_m":
        return "reader"
    if name in ("neck_m", "student_m", "teacher_m"):
        return name[:-2]
    m = re.match(r"^(Dense|LayerNorm)_(\d+)$", name)
    if m and parent == "reader_m":
        return f"{'linears' if m.group(1) == 'Dense' else 'norms'}.{m.group(2)}"
    if name == "shared_gn":
        return "shared_conv.0"
    if name == "shared_conv" and parent == "head_m":
        return "shared_conv.1"
    if name in ("GroupNorm8_0", "TorchConv3d_0"):
        # SingleConv (conv2/conv3 of a ResNetBlock) names its parts; the
        # GN-conv Sequentials of transitions and fuses number them
        if parent in ("conv2", "conv3"):
            return "groupnorm" if name == "GroupNorm8_0" else "conv"
        return "0" if name == "GroupNorm8_0" else "1"
    if name in ("cls_conv0", "cls_out") and "cls_norm" in siblings:
        return name       # the deformable head's heatmap convs keep their names
    m = re.match(r"^(\w+?)_(conv(\d+)|out)$", name)
    if m and parent.startswith("task"):
        head = m.group(1)
        if m.group(3) is not None:
            return f"{head}.{2 * int(m.group(3))}"
        n_conv = sum(1 for s in siblings if re.match(rf"^{head}_conv\d+$", s))
        return f"{head}.{2 * n_conv}"
    for pat, rep in _RULES:
        if pat.match(name):
            return pat.sub(rep, name)
    return name


def _to_torch(value, module: str = "") -> torch.Tensor:
    a = np.array(value, dtype=np.float32)
    if a.ndim == 4 and module.endswith("_deconv"):
        # flax ConvTranspose (s, s, Ci, Co): output pixel i * s + r reads tap
        # s - 1 - r -> ConvTranspose2d (Ci, Co, s, s), which reads tap r
        a = np.transpose(a[::-1, ::-1], (2, 3, 0, 1))
    elif a.ndim == 2:  # dense kernel (Ci, Co) -> (Co, Ci)
        a = a.T
    elif a.ndim == 5:  # conv kernel (kz, ky, kx, Ci, Co) -> (Co, Ci, kz, ky, kx)
        a = np.transpose(a, (4, 3, 0, 1, 2))
    elif a.ndim == 4:  # 2-D conv kernel (ky, kx, Ci, Co) -> (Co, Ci, ky, kx)
        a = np.transpose(a, (3, 2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(a))


_STATS = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_jax(params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """flax RadarPoseNet / VoxelNet / Distillation variables -> the port's
    state dict (parameters, and the BatchNorm running statistics of a
    ``batch_stats`` collection)."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node: Mapping, prefix: List[str], parent: str, leaves: Dict[str, str]):
        names = list(node)
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + [_segment(name, parent, names)], name, leaves)
                continue
            if name in ("final_conv_kernel", "final_conv_bias"):
                key = prefix + ["final_conv", "weight" if name.endswith("kernel") else "bias"]
            else:
                key = prefix + [leaves[name]]
            out[".".join(key)] = _to_torch(value, parent)

    walk(params.get("params", params), [], "", _LEAF)
    if "params" in params and "batch_stats" in params:
        walk(params["batch_stats"], [], "", _STATS)
    return out


def site_paths(model) -> Dict[Any, str]:
    """{module: flax path} for every int8 site of a RadarPoseNet or a
    VoxelNet (the same ``backbone_m`` / ``head_m`` paths): each
    ``TorchConv3d`` and the ``HRNet3D`` wrapper (whose final-fuse resize
    sites hang below its path).  The paths are the JAX package's
    (``"/".join(module.path)``, e.g. ``backbone_m/backbone/stage2_m0/
    branch0_block0/conv2/TorchConv3d_0``, ``backbone_m/final_conv``,
    ``head_m/task0/hm_out``): the inverse of ``_segment``, so a scales dict
    carries across verbatim."""
    from ..models.layers import GNConv, TorchConv3d

    out: Dict[Any, str] = {}

    def gnconv(m, path):
        out[m[1]] = f"{path}/TorchConv3d_0"

    def block(m, path):
        if m.conv1 is not None:
            out[m.conv1] = f"{path}/conv1"
        out[m.conv2.conv] = f"{path}/conv2/TorchConv3d_0"
        out[m.conv3.conv] = f"{path}/conv3/TorchConv3d_0"
        if m.down_conv is not None:
            out[m.down_conv] = f"{path}/down_conv"

    def trunk(net, path):
        block(net.layer1, f"{path}/layer1")
        for k, sname in enumerate(net.stage_names, start=1):
            for i, layer in enumerate(getattr(net, f"transition{k}")):
                if isinstance(layer, GNConv):
                    gnconv(layer, f"{path}/transition{k}_b{i}")
                elif layer is not None:
                    for j, g in enumerate(layer):
                        gnconv(g, f"{path}/transition{k}_b{i}_j{j}")
            for mi, hrm in enumerate(getattr(net, sname)):
                mp = f"{path}/{sname}_m{mi}"
                for bi, branch in enumerate(hrm.branches):
                    for ki, blk in enumerate(branch):
                        block(blk, f"{mp}/branch{bi}_block{ki}")
                for i, row in enumerate(hrm.fuse_layers or ()):
                    for j, layer in enumerate(row):
                        if layer is None:
                            continue
                        if j > i:
                            gnconv(layer, f"{mp}/fuse{i}_{j}")
                        else:
                            for ki, g in enumerate(layer):
                                gnconv(g, f"{mp}/fuse{i}_{j}_k{ki}")

    hr = model.backbone
    out[hr] = "backbone_m"
    trunk(hr.backbone, "backbone_m/backbone")
    if hr.final_conv is not None:
        out[hr.final_conv] = "backbone_m/final_conv"
    head = model.pose_head
    if head.shared_conv is not None:
        out[head.shared_conv[1]] = "head_m/shared_conv"
    for t, sep in enumerate(head.tasks):
        path = f"head_m/task{t}"
        if hasattr(sep, "task_head"):       # the deformable head's SepHead
            sep, path = sep.task_head, f"{path}/task_head"
        for name in sep.heads:
            convs = [m for m in getattr(sep, name) if isinstance(m, TorchConv3d)]
            for i, m in enumerate(convs[:-1]):
                out[m] = f"{path}/{name}_conv{i}"
            out[convs[-1]] = f"{path}/{name}_out"
    missing = [n for n, m in model.named_modules()
               if isinstance(m, TorchConv3d) and m not in out]
    if missing:
        raise ValueError(f"site_paths: no flax path for {missing}")
    return out


def bind_sites(model) -> Dict[Any, str]:
    """Name every int8 site of ``model`` (``module.site``) by its flax path;
    returns ``site_paths(model)``."""
    paths = site_paths(model)
    for m, path in paths.items():
        m.site = path
    return paths


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    meta: Dict[str, Any] | None = None,
                    optimizer: Dict[str, Any] | None = None) -> str:
    """Write a reference-format ``.pth``: ``{"meta", "state_dict"}``, and
    ``"optimizer"`` (an optimizer state dict) when given."""
    ckpt = {"meta": dict(meta or {}),
            "state_dict": OrderedDict((k, v.detach().cpu()) for k, v in state_dict.items())}
    if optimizer is not None:
        ckpt["optimizer"] = _to_cpu(optimizer)
    torch.save(ckpt, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a ``.pth`` checkpoint (tensors only, no pickled code)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
        raise ValueError(f"{path}: not a {{'meta', 'state_dict'}} checkpoint")
    return ckpt
