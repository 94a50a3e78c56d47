"""3-D High-Resolution Network backbone (PyTorch, channels-last).

Counterpart of ``rtpose_tpu/models/hrnet3d.py`` (reference
``det3d/models/backbones/hr_util/hr3d.py`` + ``hrnet3D_config.py`` +
``hrnet3d.py``): a full-resolution stem block, then stages 2..4 each adding
a 2x-downsampled branch via transition layers, with an all-pairs
multi-resolution fuse inside every HighResolutionModule (1x1 GN-conv +
trilinear align-corners upsample for lower-res -> higher-res, chains of
strided 3x3 GN-convs for higher-res -> lower-res, sum + ReLU).

Module names follow the reference torch model (``layer1``,
``transition{k}.{b}.{j}``, ``stage{k}.{m}.branches.{b}.{blk}``,
``stage{k}.{m}.fuse_layers.{i}.{j}[.{k}]``, ``final_conv``) — the names
``rtpose_tpu/engine/torch_import.py::build_name_map`` expects.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from ..ops import quant
from ..ops.interpolate import resize_trilinear_align_corners, resize_trilinear_int8
from ..registry import BACKBONES
from .layers import GNConv, ResNetBlock, TorchConv3d, canonical_dtype


def _stage(num_modules=1, num_branches=2, num_blocks=(1, 1), num_channels=(32, 32)):
    return dict(num_modules=num_modules, num_branches=num_branches,
                num_blocks=tuple(num_blocks), num_channels=tuple(num_channels))


# Arch dicts — parity with hrnet3D_config.py:8-187 (rtpose_tpu MODEL_CONFIGS).
MODEL_CONFIGS: Dict[str, Dict[str, Any]] = {
    "hr_tiny_feat32": dict(
        layer1=dict(inplanes=32), stage2_inplanes=32,
        stage2=_stage(1, 2, (1, 1), (32, 64)),
        stage3=_stage(1, 3, (1, 1, 1), (32, 64, 128)),
    ),
    "hr_tiny_feat16_zyx": dict(
        layer1=dict(inplanes=1), stage2_inplanes=16,
        stage2=_stage(1, 2, (1, 1), (16, 32)),
        stage3=_stage(1, 3, (1, 1, 1), (16, 32, 64)),
    ),
    "hr_tiny_feat16_zyx_l4": dict(
        layer1=dict(inplanes=1), stage2_inplanes=16,
        stage2=_stage(1, 2, (1, 1), (16, 32)),
        stage3=_stage(1, 3, (1, 1, 1), (16, 32, 64)),
        stage4=_stage(1, 4, (1, 1, 1, 1), (16, 32, 64, 64)),
    ),
    "hr_tiny_feat32_zyx_l4": dict(
        layer1=dict(inplanes=1), stage2_inplanes=32,
        stage2=_stage(1, 2, (1, 1), (32, 32)),
        stage3=_stage(1, 3, (1, 1, 1), (32, 32, 64)),
        stage4=_stage(1, 4, (1, 1, 1, 1), (32, 32, 64, 64)),
    ),
    "hr_tiny_feat32_zyx_l4_in32": dict(
        layer1=dict(inplanes=32), stage2_inplanes=32,
        stage2=_stage(1, 2, (1, 1), (32, 32)),
        stage3=_stage(1, 3, (1, 1, 1), (32, 32, 64)),
        stage4=_stage(1, 4, (1, 1, 1, 1), (32, 32, 64, 64)),
    ),
    "hr_tiny_feat64_zyx_l4_in64": dict(
        layer1=dict(inplanes=64), stage2_inplanes=64,
        stage2=_stage(1, 2, (1, 1), (64, 64)),
        stage3=_stage(1, 3, (1, 1, 1), (64, 64, 128)),
        stage4=_stage(1, 4, (1, 1, 1, 1), (64, 64, 128, 128)),
    ),
}


class HighResolutionModule(nn.Module):
    """Per-branch residual blocks followed by the all-pairs fuse
    (hr3d.py:5-229)."""

    def __init__(self, num_branches: int, num_blocks, num_channels, dtype=None):
        super().__init__()
        self.num_branches = nb = num_branches
        chans = list(num_channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[ResNetBlock(chans[i], chans[i], dtype=dtype)
                            for _ in range(num_blocks[i])])
            for i in range(nb))
        self.fuse_layers = None
        if nb == 1:
            return
        fuse = nn.ModuleList()
        for i in range(nb):
            row = nn.ModuleList()
            for j in range(nb):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(GNConv(chans[j], chans[i], kernel=1, dtype=dtype))
                else:
                    # chain of (i - j) strided GN-convs; the last maps to
                    # chans[i] without ReLU (hr3d.py:162-197)
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        chain.append(GNConv(chans[j], chans[i] if last else chans[j],
                                            kernel=3, stride=2, relu=not last,
                                            dtype=dtype))
                    row.append(nn.Sequential(*chain))
            fuse.append(row)
        self.fuse_layers = fuse

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        feats = [branch(h) for branch, h in zip(self.branches, x)]
        if self.fuse_layers is None:
            return feats
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = feats[0] if i == 0 else row[0](feats[0])
            for j in range(1, self.num_branches):
                if j == i:
                    y = y + feats[j]
                elif j > i:     # a new tensor: row 0's first y is feats[0], read again
                    y = resize_trilinear_align_corners(row[j](feats[j]), feats[i].shape[1:4],
                                                       addend=y)
                else:
                    y = y + row[j](feats[j])
            out.append(torch.relu(y))
        return out


class HighResolution3DNet(nn.Module):
    """The staged HRNet trunk (hr3d.py:234-399)."""

    def __init__(self, cfg: Dict[str, Any], dtype=None, in_channels: Optional[int] = None):
        super().__init__()
        # the arch table's width unless the detector passes its input's
        # (flax infers it: rtpose_tpu/models/hrnet3d.py:156-157)
        inplanes = cfg["layer1"]["inplanes"] if in_channels is None else in_channels
        c2 = cfg["stage2_inplanes"]
        self.layer1 = ResNetBlock(inplanes, c2, dtype=dtype)
        pre = [c2]
        self.stage_names = []
        for k, sname in enumerate(("stage2", "stage3", "stage4"), start=1):
            scfg = cfg.get(sname)
            if scfg is None:
                break
            cur = list(scfg["num_channels"])
            setattr(self, f"transition{k}", self._transition(pre, cur, dtype))
            setattr(self, sname, nn.Sequential(*[
                HighResolutionModule(scfg["num_branches"], scfg["num_blocks"],
                                     cur, dtype=dtype)
                for _ in range(scfg["num_modules"])]))
            self.stage_names.append(sname)
            pre = cur

    @staticmethod
    def _transition(pre_ch: List[int], cur_ch: List[int], dtype) -> nn.ModuleList:
        """Reference transition (hr3d.py:286-331): existing branches get a 3x3
        GN-conv only on channel mismatch; each new branch is a chain of
        strided GN-convs from the LAST previous branch."""
        layers = nn.ModuleList()
        n_pre = len(pre_ch)
        for i in range(len(cur_ch)):
            if i < n_pre:
                # fed the LAST previous branch, as in rtpose_tpu
                layers.append(GNConv(pre_ch[-1], cur_ch[i], kernel=3, relu=True,
                                     dtype=dtype)
                              if cur_ch[i] != pre_ch[i] else None)
            else:
                chain = []
                for j in range(i + 1 - n_pre):
                    outc = cur_ch[i] if j == i - n_pre else pre_ch[-1]
                    chain.append(GNConv(pre_ch[-1], outc, kernel=3, stride=2,
                                        relu=True, dtype=dtype))
                layers.append(nn.Sequential(*chain))
        return layers

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y_list = [self.layer1(x)]
        for k, sname in enumerate(self.stage_names, start=1):
            trans = getattr(self, f"transition{k}")
            n_pre = len(y_list)
            x_list = []
            for i, layer in enumerate(trans):
                if i < n_pre:
                    # channel-change transitions read the LAST previous
                    # output (rtpose_tpu hrnet3d.py:206-207)
                    x_list.append(y_list[i] if layer is None else layer(y_list[-1]))
                else:
                    x_list.append(layer(y_list[-1]))
            y_list = getattr(self, sname)(x_list)
        return y_list


def resize_calls(backbone_cfg: str, grid_zyx) -> List[tuple]:
    """The trilinear resizes of one forward of ``HRNet3D(backbone_cfg)``
    with the 'conat_conv' final fuse on a ``grid_zyx`` input, in order:
    (input grid, output grid, C, whether it adds into a fuse's sum) — each
    module's fuse rows in turn, then the final fuse's (for the resize
    kernel's tests and timings)."""
    cfg = MODEL_CONFIGS[backbone_cfg]
    grids = [tuple(g >> k for g in grid_zyx) for k in range(4)]
    calls = []
    for sname in ("stage2", "stage3", "stage4"):
        scfg = cfg.get(sname)
        if scfg is None:
            break
        nb, chans = scfg["num_branches"], scfg["num_channels"]
        calls += [(grids[j], grids[i], chans[i], True) for _ in range(scfg["num_modules"])
                  for i in range(nb) for j in range(i + 1, nb)]
    return calls + [(grids[j], grids[0], chans[j], False) for j in range(1, nb)]


def concat_resized(top: torch.Tensor, branches: List[torch.Tensor],
                   scales: Optional[List[Optional[float]]] = None) -> torch.Tensor:
    """``top`` and each of ``branches`` resized to its grid (trilinear,
    align corners; the int8 form for a branch given a scale), concatenated
    on channels: each resize writes its own slice of one buffer, where
    ``torch.cat`` would copy every resized branch once more."""
    scales = scales or [None] * len(branches)
    C = top.shape[4]
    out = top.new_empty((*top.shape[:4], C + sum(f.shape[4] for f in branches)))
    out[..., :C].copy_(top)
    for f, scale in zip(branches, scales):
        dst = out[..., C:C + f.shape[4]]
        if scale is None:
            resize_trilinear_align_corners(f, top.shape[1:4], out=dst)
        else:
            dst.copy_(resize_trilinear_int8(f, top.shape[1:4], scale))
        C += f.shape[4]
    return out


# the JAX package folds X by 4 when every branch's X (X / 8 at the
# coarsest) stays divisible by 4 (``rtpose_tpu/models/hrnet3d.py:255``)
FOLD_X = 32


@BACKBONES.register_module
class HRNet3D(nn.Module):
    """Backbone wrapper with the final multi-branch fuse (hrnet3d.py:8-56).

    final_fuse:
      'top'        — take the full-resolution branch only.
      'conat_conv' — trilinear-upsample all branches to full res, concat
                     channels, then a 1x1x1 conv to ``final_conv_out``.
    """

    def __init__(self, backbone_cfg: str = "hr_tiny_feat16_zyx_l4",
                 final_conv_in: int = 192, final_conv_out: int = 128,
                 final_fuse: str = "conat_conv", ds_factor: int = 1, dtype=None,
                 in_channels: Optional[int] = None):
        super().__init__()
        if final_fuse not in ("top", "conat_conv"):
            raise ValueError(f"unknown final_fuse {final_fuse!r}")
        self.dtype = canonical_dtype(dtype)
        self.final_fuse = final_fuse
        cfg = MODEL_CONFIGS[backbone_cfg]
        self.backbone = HighResolution3DNet(cfg, dtype=self.dtype, in_channels=in_channels)
        last = cfg.get("stage4") or cfg["stage3"]
        top_ch = last["num_channels"][0]
        cin = top_ch if final_fuse == "top" else sum(last["num_channels"])
        self.final_conv = (TorchConv3d(cin, final_conv_out, kernel=1, dtype=self.dtype)
                           if final_conv_in != final_conv_out else None)
        self.site = None     # the flax path of the module (engine.convert.bind_sites)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The fused feature map.  Under a quant context the final-fuse
        resizes (sites ``<site>/final_fuse{i}_resize``) and, for
        'conat_conv', ``final_conv`` are int8 sites only where the JAX
        package folds X, that is when X is divisible by 32
        (``rtpose_tpu/models/hrnet3d.py:255, 290-293, 317-319``); otherwise
        they run float, uncalibrated, as there."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        folded = x.shape[3] % FOLD_X == 0
        feats = self.backbone(x)
        top = feats[0]
        if self.final_fuse == "top":
            return top if self.final_conv is None else self.final_conv(top)
        quantized = folded and quant.current() is not None
        if quantized and self.site is None:
            raise RuntimeError("HRNet3D under a quant context has no site: "
                               "engine.convert.bind_sites(model) names them")
        branches, scales = [], []
        for i, f in enumerate(feats[1:]):
            f = f.to(top.dtype)
            branches.append(f)
            scales.append(quant.consult(f"{self.site}/final_fuse{i + 1}_resize", f)
                          if quantized else None)
        out = concat_resized(top, branches, scales)
        return out if self.final_conv is None else self.final_conv(out, quantize=folded)
