"""Plain float32 HRRadarPose with the deformable head: the reference forward
pass of ``hr3d_one_hm_doppler.py`` with the published ``CenterHead``'s
``dcn_head=True`` (ipl-uw/RT-POSE ``det3d/models/pose_heads/center_head.py:24-163``
on the deformable conv of ``det3d/ops/dcn``).

The trunk is ``model.py``'s.  The head, per branch (heatmap and
regression), is a ``FeatureAdaption``: a 1x1 conv predicts 72 offsets (4
deformable groups x 9 taps x (dy, dx)), a 3x3 deformable conv v1 (no bias)
samples the features at the moved taps and contracts them, ReLU.  The
heatmap branch then runs a 3x3 conv to 32 channels, a LayerNorm over the
channels (eps 1e-6), ReLU and a 3x3 conv to one channel; the regression
branch the dense 3-D ``SepHead`` tower (two 3x3x3 convs, 128 -> 32 -> 45).
Parameter names and shapes are those of the port's ``state_dict``.

The deformable conv follows the definition, as ``det3d/ops/dcn``'s
``deformable_im2col`` computes it: tap (i, j) of output (y, x) samples the
input of its deformable group at (y - 1 + i + dy, x - 1 + j + dx); a sample
whose position leaves the open box (-1, H) x (-1, W) is zero; inside, it is
the bilinear mix of its four corners, each corner off the map reading zero;
the (K * C) columns of every output position are then contracted with the
weights in one matrix product.

Departures from the source, on purpose:

* the upstream modules are 2-D and fail on the 5-D radar features, so Z is
  folded into the batch around them (the port's ``models/dcn_head.py``);
* ``INIT`` draws the offset convs' kernels from N(0, 0.05^2), where the
  published init is zero: zero offsets would make each deformable conv a
  plain conv, and the check would never see the sampling;
* everything runs in float32 (the configuration computes in bfloat16), with
  TF32 off for this module's own calls (restored after them: the program
  shares the process);
* the head works in blocks of ``BLOCK`` images, so that a frame's 16 fit on
  the card; images are independent, so the blocks change no value.

``predict`` runs the dense head whatever ``sparse`` says, since the program
runs this head densely: the operations counted of it (``counts.model_flops``)
hold both deformable contractions and the dense regression tower.  The nets
have no ``train_outputs``: no training cell runs this configuration yet.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import model
from benchmark.reference.model import Conv, load  # noqa: F401  (the module's interface)

GROUPS = 4          # deformable groups
KERNEL = 3
HEAD_CONV = 32
BLOCK = 16          # images of the head at a time
OFFSET_STD = 0.05


class NoTF32:
    """TF32 off for float32 matmuls and cuDNN convs inside the block; the
    settings found are restored on leaving it."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def bilinear(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """img (N, G, Cg, H, W) sampled at positions py, px (N, G, P):
    (N, G, Cg, P), by ``det3d/ops/dcn``'s rule (the module's doc)."""
    N, G, Cg, H, W = img.shape
    flat = img.reshape(N, G, Cg, H * W)
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    inside = (py > -1) & (py < H) & (px > -1) & (px < W)
    out = torch.zeros((N, G, Cg, py.shape[-1]), dtype=img.dtype, device=img.device)
    for dy, dx, w in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                      (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
        y, x = y0 + dy, x0 + dx
        on_map = inside & (y >= 0) & (y <= H - 1) & (x >= 0) & (x <= W - 1)
        at = (y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).long()
        v = torch.gather(flat, 3, at[:, :, None, :].expand(N, G, Cg, -1))
        out = out + v * (w * on_map)[:, :, None, :]
    return out


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  groups: int = GROUPS) -> torch.Tensor:
    """Deformable conv v1, stride 1, 'same' padding, no bias: x (N, C, H, W),
    offset (N, groups * K * 2, H, W) in channel order [group, tap, (dy, dx)],
    weight (Cout, C, kh, kw) -> (N, Cout, H, W)."""
    N, C, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    K = kh * kw
    img = x.reshape(N, groups, C // groups, H, W)
    off = offset.reshape(N, groups, K, 2, H * W)
    ys = torch.arange(H, device=x.device, dtype=x.dtype).repeat_interleave(W)
    xs = torch.arange(W, device=x.device, dtype=x.dtype).repeat(H)
    cols = []
    for k in range(K):
        i, j = divmod(k, kw)
        py = ys + (i - kh // 2) + off[:, :, k, 0]
        px = xs + (j - kw // 2) + off[:, :, k, 1]
        cols.append(bilinear(img, py, px).reshape(N, C, H * W))
    col = torch.stack(cols, dim=2).reshape(N, C * K, H * W)     # (c, tap) rows
    return torch.matmul(weight.reshape(Cout, C * K), col).reshape(N, Cout, H, W)


class Conv2d(nn.Module):
    """2-D conv with bias and padding k // 2 on NCHW float32."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, padding=self.weight.shape[-1] // 2)


class DeformConv(nn.Module):
    def __init__(self, c: int, k: int = KERNEL):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, c, k, k))

    def forward(self, x, offset):
        return deform_conv2d(x, offset, self.weight)


class FeatureAdaption(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv_offset = Conv2d(c, GROUPS * KERNEL * KERNEL * 2, 1)
        self.conv_adaption = DeformConv(c)

    def forward(self, x):
        return F.relu(self.conv_adaption(x, self.conv_offset(x)))


class LayerNorm(nn.Module):
    """LayerNorm over the channels of NCHW, eps 1e-6."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight, self.bias, eps=1e-6)
        return y.permute(0, 3, 1, 2)


class RegTower(nn.Module):
    """The regression ``SepHead``: ``reg`` = 3x3x3 conv, ReLU, 3x3x3 conv."""

    def __init__(self, cin: int, reg_dim: int):
        super().__init__()
        self.reg = nn.Sequential(Conv(cin, HEAD_CONV, 3), nn.ReLU(), Conv(HEAD_CONV, reg_dim, 3))


class DCNSepHead(nn.Module):
    def __init__(self, c: int, reg_dim: int):
        super().__init__()
        self.feature_adapt_cls = FeatureAdaption(c)
        self.feature_adapt_reg = FeatureAdaption(c)
        self.cls_conv0 = Conv2d(c, HEAD_CONV, 3)
        self.cls_norm = LayerNorm(HEAD_CONV)
        self.cls_out = Conv2d(HEAD_CONV, 1, 3)
        self.task_head = RegTower(c, reg_dim)

    def forward(self, f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """f (B, C, Z, Y, X) -> (hm logits (B, 1, Z, Y, X), reg (B, D, Z, Y, X));
        the 2-D part on the B * Z images of Y x X, ``BLOCK`` at a time."""
        B, C, Z, Y, X = f.shape
        images = f.permute(0, 2, 1, 3, 4).reshape(B * Z, C, Y, X)
        hms, regs = [], []
        for s in range(0, B * Z, BLOCK):
            im = images[s:s + BLOCK]
            h = F.relu(self.cls_norm(self.cls_conv0(self.feature_adapt_cls(im))))
            hms.append(self.cls_out(h))
            regs.append(self.feature_adapt_reg(im))
        hm = torch.cat(hms).reshape(B, Z, 1, Y, X).permute(0, 2, 1, 3, 4)
        reg_feat = torch.cat(regs).reshape(B, Z, C, Y, X).permute(0, 2, 1, 3, 4)
        return hm, self.task_head.reg(reg_feat)


class Head(nn.Module):
    def __init__(self, c: int, reg_dim: int):
        super().__init__()
        self.tasks = nn.ModuleList([DCNSepHead(c, reg_dim)])


class PoseNet(nn.Module):
    """Reader (identity), ``model.py``'s backbone, the deformable head.
    Inputs (B, Z, Y, X, C)."""

    def __init__(self, model_cfg: dict, in_channels: int):
        super().__init__()
        bb, ph = model_cfg["backbone"], model_cfg["pose_head"]
        if bb["final_fuse"] != "conat_conv" or bb.get("final_conv_in") == bb["final_conv_out"]:
            raise ValueError("the reference holds the 'conat_conv' fuse with its final conv")
        if (len(ph["tasks"]) != 1 or not ph.get("dcn_head") or model_cfg.get("neck")
                or ph["in_channels"] != ph["share_conv_channel"]):
            raise ValueError("the reference holds one task, the deformable head, no neck and "
                             "no shared conv")
        self.backbone = model.Backbone(bb["backbone_cfg"], in_channels, bb["final_conv_in"],
                                       bb["final_conv_out"])
        self.pose_head = Head(ph["in_channels"], int(ph["common_heads"]["reg"][0]))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        with NoTF32():
            return self.backbone(x.permute(0, 4, 1, 2, 3))

    def dense(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hm logits (B, 1, Z, Y, X), reg (B, D, Z, Y, X))."""
        with NoTF32():
            return self.pose_head.tasks[0](self.features(x))

    def predict(self, x: torch.Tensor, sparse: bool = True):
        """(hm, reg at the peak, peak index), the head dense whatever ``sparse``."""
        hm, reg = self.dense(x)
        B, D = reg.shape[:2]
        flat = hm.reshape(B, -1).argmax(dim=1)
        return hm, reg.reshape(B, D, -1)[torch.arange(B, device=x.device), :, flat], flat


# each parameter kind's draw (the benchmark's ``make_weights``)
INIT = dict(model.INIT, offset=("normal", OFFSET_STD))


def param_specs(net: nn.Module) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in module order: ``model.py``'s
    kinds, and 'offset' for the offset convs' kernels."""
    out = []
    head = net.pose_head.tasks[0]
    offsets = {head.feature_adapt_cls.conv_offset, head.feature_adapt_reg.conv_offset}
    for mname, m in net.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (Conv, Conv2d, DeformConv)):
            out.append((pre + "weight", tuple(m.weight.shape),
                        "offset" if m in offsets else "conv"))
            if getattr(m, "bias", None) is not None:
                out.append((pre + "bias", tuple(m.bias.shape),
                            "hm_bias" if m is head.cls_out else "conv_bias"))
        elif isinstance(m, (model.GN, LayerNorm)):
            out.append((pre + "weight", tuple(m.weight.shape), "norm_w"))
            out.append((pre + "bias", tuple(m.bias.shape), "norm_b"))
    return out


def build(model_cfg: dict, in_channels: int, device=None) -> PoseNet:
    """The reference on ``device`` ('meta' for counting), weights unset."""
    with torch.device(device or "cpu"):
        return PoseNet(model_cfg, in_channels)

