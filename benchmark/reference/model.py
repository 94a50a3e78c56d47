"""Plain float32 HRRadarPose: the benchmark's reference forward pass.

A frozen, independent statement of the model the RT-Pose configs
(``configs/cruw_pose/hr3d_one_hm_doppler*.py`` of ipl-uw/RT-POSE) describe:
an identity reader, the 3-D HRNet trunk (GroupNorm-8 -> conv -> ReLU
residual blocks, all-pairs fuses with trilinear align-corners upsampling
and strided 3x3x3 GN-conv chains, a concat of every branch upsampled to
full resolution and a 1x1x1 conv), then a CenterHead with one pelvis
heatmap tower and one 45-wide keypoint regression tower (two 3x3x3 convs
each).  Stock ``torch.nn.functional`` on NCDHW float32 tensors; no kernel,
cache or batching trick.  Parameter names and shapes are those of the
port's ``state_dict``, so one seeded state dict loads into both.

Departures from the program's arithmetic, on purpose: everything runs in
float32 (the configs compute in bfloat16), and the regression tower runs
densely, its value read at the voxels asked for (the program evaluates it
on 5^3 patches, which is the same function).  ``sparse=True`` computes the
regression on those 5^3 patches instead, for counting operations as the
program's algorithm needs them.

``Conv.fp8 = True`` rounds every conv's input, weight and output to float8
e4m3 with a per-tensor scale (absmax / 448), the gradient passing straight
through the rounding: the precision below the configs' bfloat16,
the correctness check's control.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# The trunks the configs name, frozen (hrnet3D_config.py of the reference).
# Per trunk: the stem block's width, then each stage's branch widths.
ARCH = {
    "hr_tiny_feat32_zyx_l4_in32": (32, [(32, 32), (32, 32, 64), (32, 32, 64, 64)]),
    "hr_tiny_feat64_zyx_l4_in64": (64, [(64, 64), (64, 64, 128), (64, 64, 128, 128)]),
}

FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in float32,
    with a straight-through gradient."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


class Conv(nn.Module):
    """3-D conv with padding k // 2 on NCDHW float32."""

    fp8 = False     # class-wide switch of the control

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        w = self.weight
        if Conv.fp8:
            x, w = round_fp8(x), round_fp8(w)
        y = F.conv3d(x, w, self.bias, stride=self.stride, padding=w.shape[-1] // 2)
        return round_fp8(y) if Conv.fp8 else y


class GN(nn.Module):
    """GroupNorm with 8 groups (1 below 8 channels), eps 1e-5."""

    def __init__(self, c: int):
        super().__init__()
        self.groups = 8 if c >= 8 else 1
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, eps=1e-5)


def gn_conv(cin, cout, k=3, stride=1, relu=False) -> nn.Sequential:
    mods = [GN(cin), Conv(cin, cout, k, stride, bias=False)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


def single_conv(cin, cout, relu=True) -> nn.Sequential:
    mods = OrderedDict(groupnorm=GN(cin), conv=Conv(cin, cout, 3, 1, bias=False))
    if relu:
        mods["ReLU"] = nn.ReLU()
    return nn.Sequential(mods)


class Block(nn.Module):
    """Residual block: optional 1x1 lift, GN-conv-ReLU, GN-conv, add, ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv(cin, cout, 1) if cin != cout else None
        self.conv2 = single_conv(cout, cout, relu=True)
        self.conv3 = single_conv(cout, cout, relu=False)

    def forward(self, x):
        r = x if self.conv1 is None else self.conv1(x)
        return F.relu(self.conv3(self.conv2(r)) + r)


def resize(x, size):
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="trilinear", align_corners=True)


class Module(nn.Module):
    """One multi-resolution module: a block per branch, then the fuse."""

    def __init__(self, chans: Sequence[int]):
        super().__init__()
        nb = len(chans)
        self.branches = nn.ModuleList(nn.Sequential(Block(c, c)) for c in chans)
        rows = nn.ModuleList()
        for i in range(nb):
            row = nn.ModuleList()
            for j in range(nb):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(gn_conv(chans[j], chans[i], k=1))
                else:
                    row.append(nn.Sequential(*[
                        gn_conv(chans[j], chans[i] if k == i - j - 1 else chans[j], k=3,
                                stride=2, relu=k != i - j - 1) for k in range(i - j)]))
            rows.append(row)
        self.fuse_layers = rows

    def forward(self, xs):
        feats = [b(x) for b, x in zip(self.branches, xs)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = feats[0] if i == 0 else row[0](feats[0])
            for j in range(1, len(feats)):
                if j == i:
                    y = y + feats[j]
                elif j > i:
                    y = y + resize(row[j](feats[j]), feats[i].shape[2:])
                else:
                    y = y + row[j](feats[j])
            out.append(F.relu(y))
        return out


class Trunk(nn.Module):
    def __init__(self, arch: str, in_channels: int):
        super().__init__()
        c2, stages = ARCH[arch]
        self.layer1 = Block(in_channels, c2)
        pre = [c2]
        self.n_stages = len(stages)
        for k, cur in enumerate(stages, start=1):
            trans = nn.ModuleList()
            for i, c in enumerate(cur):
                if i < len(pre):
                    trans.append(gn_conv(pre[-1], c, 3, relu=True) if c != pre[i] else None)
                else:
                    trans.append(nn.Sequential(*[
                        gn_conv(pre[-1], c if j == i - len(pre) else pre[-1], 3, stride=2,
                                relu=True) for j in range(i + 1 - len(pre))]))
            setattr(self, f"transition{k}", trans)
            setattr(self, f"stage{k + 1}", nn.Sequential(Module(cur)))
            pre = list(cur)

    def forward(self, x):
        ys = [self.layer1(x)]
        for k in range(1, self.n_stages + 1):
            xs = []
            for i, layer in enumerate(getattr(self, f"transition{k}")):
                if i < len(ys):
                    xs.append(ys[i] if layer is None else layer(ys[-1]))
                else:
                    xs.append(layer(ys[-1]))
            ys = getattr(self, f"stage{k + 1}")[0](xs)
        return ys


class Backbone(nn.Module):
    def __init__(self, arch: str, in_channels: int, final_conv_in: int, final_conv_out: int):
        super().__init__()
        self.backbone = Trunk(arch, in_channels)
        self.final_conv = Conv(final_conv_in, final_conv_out, 1)

    def forward(self, x):
        feats = self.backbone(x)
        top = feats[0]
        return self.final_conv(torch.cat([top] + [resize(f, top.shape[2:]) for f in feats[1:]],
                                         dim=1))


class Task(nn.Module):
    """The regression tower, then the heatmap tower (the port's order)."""

    def __init__(self, cin: int, reg_dim: int, head_conv: int = 32):
        super().__init__()
        self.reg = nn.Sequential(Conv(cin, head_conv, 3), nn.ReLU(), Conv(head_conv, reg_dim, 3))
        self.hm = nn.Sequential(Conv(cin, head_conv, 3), nn.ReLU(), Conv(head_conv, 1, 3))


class Head(nn.Module):
    def __init__(self, in_channels: int, share_conv_channel: int, reg_dim: int):
        super().__init__()
        ch = in_channels
        self.shared_conv = None
        if in_channels != share_conv_channel:
            self.shared_conv = nn.Sequential(GN(in_channels),
                                             Conv(in_channels, share_conv_channel, 3, bias=False),
                                             nn.ReLU())
            ch = share_conv_channel
        self.tasks = nn.ModuleList([Task(ch, reg_dim)])

    def shared(self, feat):
        return feat if self.shared_conv is None else self.shared_conv(feat)


def _patch_coords(center: torch.Tensor, size: int):
    pos = center[:, None] - 2 + torch.arange(5, device=center.device)
    return pos.clamp(0, size - 1), (pos >= 0) & (pos < size)


class PoseNet(nn.Module):
    """Reader (identity), backbone, head.  Inputs (B, Z, Y, X, C)."""

    def __init__(self, model_cfg: dict, in_channels: int):
        super().__init__()
        bb, ph = model_cfg["backbone"], model_cfg["pose_head"]
        if bb["final_fuse"] != "conat_conv" or bb.get("final_conv_in") == bb["final_conv_out"]:
            raise ValueError("the reference holds the 'conat_conv' fuse with its final conv")
        if len(ph["tasks"]) != 1 or ph.get("dcn_head") or model_cfg.get("neck"):
            raise ValueError("the reference holds one task, no deformable head, no neck")
        self.backbone = Backbone(bb["backbone_cfg"], in_channels, bb["final_conv_in"],
                                 bb["final_conv_out"])
        reg_dim = int(ph["common_heads"]["reg"][0])
        self.pose_head = Head(ph["in_channels"], ph["share_conv_channel"], reg_dim)
        self.init_bias = float(ph.get("init_bias", -2.19))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.pose_head.shared(self.backbone(x.permute(0, 4, 1, 2, 3)))

    def dense(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hm logits (B, 1, Z, Y, X), reg (B, D, Z, Y, X))."""
        f = self.features(x)
        t = self.pose_head.tasks[0]
        return t.hm(f), t.reg(f)

    def reg_at(self, f: torch.Tensor, flat: torch.Tensor, sparse: bool) -> torch.Tensor:
        """Regression (B, D) at flat voxel indices (B,): dense and gathered,
        or on the 5^3 patch around each voxel (zero padding outside)."""
        t = self.pose_head.tasks[0]
        B, C, Z, Y, X = f.shape
        if not sparse:
            reg = t.reg(f).reshape(B, -1, Z * Y * X)
            return reg[torch.arange(B, device=f.device), :, flat]
        z, y, x = flat // (Y * X), (flat % (Y * X)) // X, flat % X
        (pz, mz), (py, my), (px, mx) = (_patch_coords(z, Z), _patch_coords(y, Y),
                                        _patch_coords(x, X))
        fl = f.permute(0, 2, 3, 4, 1)
        bi = torch.arange(B, device=f.device)[:, None, None, None]
        p = fl[bi, pz[:, :, None, None], py[:, None, :, None], px[:, None, None, :]]
        m = (mz[:, :, None, None] & my[:, None, :, None] & mx[:, None, None, :])[:, None]
        h = t.reg[0](p.permute(0, 4, 1, 2, 3) * m)
        h = t.reg[1](h) * m
        return t.reg[2](h)[:, :, 2, 2, 2]

    def train_outputs(self, x: torch.Tensor, ind: torch.Tensor, sparse: bool = False):
        """(hm logits (B, 1, Z, Y, X), reg at ``ind`` (B, M, D))."""
        f = self.features(x)
        hm = self.pose_head.tasks[0].hm(f)
        B, M = ind.shape
        flat = ind.reshape(-1).long()
        f_rep = f.repeat_interleave(M, dim=0) if M > 1 else f
        return hm, self.reg_at(f_rep, flat, sparse).reshape(B, M, -1)

    def predict(self, x: torch.Tensor, sparse: bool = True):
        """Sparse single-peak predict: (hm, reg at the peak, peak index)."""
        f = self.features(x)
        hm = self.pose_head.tasks[0].hm(f)
        flat = hm.reshape(hm.shape[0], -1).argmax(dim=1)
        return hm, self.reg_at(f, flat, sparse), flat


def _init_bias(model_cfg: dict) -> float:
    return float(model_cfg["pose_head"].get("init_bias", -2.19))


# each parameter kind's draw (the benchmark's ``make_weights``)
INIT = {
    "conv": ("he_normal",),
    "conv_bias": ("fill", 0.0),
    "norm_w": ("fill", 1.0),
    "norm_b": ("fill", 0.0),
    "hm_bias": ("fill", _init_bias),
}


def param_specs(model: nn.Module) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in module order; kind is
    'conv' (He-normal), 'conv_bias' (zero), 'norm_w' (one), 'norm_b'
    (zero) or 'hm_bias' (the heatmap output's init bias): ``INIT``."""
    out = []
    hm_out = model.pose_head.tasks[0].hm[2]
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, Conv):
            out.append((pre + "weight", tuple(m.weight.shape), "conv"))
            if m.bias is not None:
                out.append((pre + "bias", tuple(m.bias.shape),
                            "hm_bias" if m is hm_out else "conv_bias"))
        elif isinstance(m, GN):
            out.append((pre + "weight", tuple(m.weight.shape), "norm_w"))
            out.append((pre + "bias", tuple(m.bias.shape), "norm_b"))
    return out


def build(model_cfg: dict, in_channels: int, device=None) -> PoseNet:
    """The reference on ``device`` ('meta' for counting), weights unset."""
    with torch.device(device or "cpu"):
        return PoseNet(model_cfg, in_channels)


def load(model: PoseNet, state: Dict[str, torch.Tensor]) -> PoseNet:
    """Load a state dict in the port's names (float32 copies)."""
    own = dict(model.named_parameters())
    if set(own) != set(state):
        raise KeyError(f"reference parameters differ: {sorted(set(own) ^ set(state))[:6]}")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(state[k].to(p.device, torch.float32))
    return model
