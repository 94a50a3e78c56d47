"""Plain int8 HRRadarPose: the reference of the flagship's int8 serving
artifact (``hr3d_one_hm_doppler.py`` served as the symmetric post-training
int8 program that ``rtpose_tpu_torch/tools/export.py --int8`` writes).

The net is ``model.py``'s; every conv of it becomes this module's ``Conv``.
The activation scales are the reference's own (``calibrate``: absmax / 127
of each site's input over seeded calibration frames, through the float net
of the compute dtype, as the program calibrates), given to the sites with
``set_scales``.  A conv that is an int8 site and has its scale computes the
int8 conv of the definition (``rtpose_tpu/ops/quant.py`` and the ``TorchConv3d`` that calls
it, read, not imported):

* the conv's input cast to the conv's dtype, the configuration's compute
  dtype (the part's ``dtype``, bfloat16), then
  ``xq = clamp(round_half_even(x * (1 / scale)), -127, 127)``;
* ``sw[co] = absmax(w[co]) / 127`` (1.0 where the absmax is 0) on the
  float32 weights, ``wq = clamp(round_half_even(w / sw), -127, 127)``;
* the accumulator: the integer conv of ``xq`` and ``wq`` with padding
  k // 2, computed in float64, where it is exact (|sum| <= 127 * 127 * 27 *
  192 < 2^53), then taken to float32 (round to nearest, as int32 to
  float32 rounds);
* the epilogue ``acc * (sw * scale)``, then ``+ bias``, in float32 and in
  that order, then the cast to the conv's dtype; that cast is part of the
  int8 op's definition.

The final fuse's int8 concat + 1x1 conv (``backbone.final_conv``) follows
the same definition on the concat.  Everything else computes in float32
(stock ``torch.nn.functional`` on NCDHW tensors, TF32 off for the net's
calls: ``NoTF32``, the settings found restored after each, since the
program shares the process), and, with scales set, each value the
configuration's bfloat16 model rounds is rounded to bfloat16 where the
model's definition rounds it: the trunk's input, each GroupNorm's output
(float32 statistics), each sum of a residual block and of a fuse, each
trilinear resize.  The head's output convs compute in float32, as the
program's (its ``final_dtype``).  Without that rounding (``set_scales(...,
rounded=False)``, float32 between the sites) the reference follows the
program no closer than it follows the bfloat16 program without int8: each
site quantizes the values it is given, so a value a bfloat16 ulp away from
the program's may land one int8 step away, and such steps multiply from site
to site (at full size on the H100 the int8 program and the bfloat16 control
read overlapping ``kpt_gap``s against such a reference, 7.0-67.7 and
27.8-91.3 over 12 seeds: ``limits/hrradarpose_doppler_int8.serve_b8.json``).

The sites (``sites``): every conv but those the serving export's default
exclusion (suffixes of the program's site names) names: ``_out``, the
output conv of each head tower (``pose_head.tasks.<t>.hm.2`` and
``.reg.2``), which stays float; ``_resize``, the final fuse's trilinear
resizes, which are no convs here and stay float.  51 on the flagship.

Departures from the program's arithmetic, on purpose:

* the sums and statistics of the float parts run in other orders (a
  GroupNorm's statistics, a resize's blend, the output convs), so a value
  may land one bfloat16 ulp from the program's, and from there one int8
  step away at the next site: the reference follows the program closely
  over the first sites and then statistically, not bit for bit;
* the regression tower runs densely and is read at the peak
  (``model.py``'s rule); its first conv quantizes the whole feature map
  with the scale calibrated on the 5^3 patches, which changes no value at
  the peak, whose receptive field lies inside its patch.

``predict``, ``features`` and ``dense`` are ``model.py``'s; without scales
the net is ``model.py``'s float32 net (``counts.model_flops`` counts it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import evaluate, model
from benchmark.reference.dcn import NoTF32
from benchmark.reference.model import INIT, load, param_specs  # noqa: F401  (the interface)

QMAX = 127.0
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The int8 values of ``x`` at ``scale``, held in float32."""
    return torch.round(x.float() * (1.0 / scale)).clamp(-QMAX, QMAX)


def quantize_weight(w: torch.Tensor):
    """(wq, sw): the int8 values of (Co, ...) weights, held in float32, and
    their per-output-channel scales."""
    w32 = w.detach().float()
    absmax = w32.abs().amax(dim=tuple(range(1, w.dim())))
    # a tensor divisor: the correctly rounded quotient on every device
    sw = torch.where(absmax > 0, absmax / absmax.new_tensor(QMAX), torch.ones_like(absmax))
    wq = torch.round(w32 / sw.view(-1, *([1] * (w.dim() - 1)))).clamp(-QMAX, QMAX)
    return wq, sw


def int8_conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
              scale: float, out_dtype) -> torch.Tensor:
    """The int8 conv of the definition on NCDHW float32 ``x``; float32 out,
    holding values of ``out_dtype``."""
    xq = quantize_act(x.to(out_dtype), scale)
    wq, sw = quantize_weight(w)
    acc = F.conv3d(xq.double(), wq.double(), stride=stride, padding=w.shape[-1] // 2)
    shape = (1, -1, 1, 1, 1)
    out = acc.float() * (sw * scale).view(shape)
    if bias is not None:
        out = out + bias.detach().float().view(shape)
    return out.to(out_dtype).float()


class Conv(model.Conv):
    """``model.Conv``; at an int8 site with a scale, ``int8_conv``; at a
    site under ``calibrate``, the conv in its compute dtype, its input's
    absmax kept (``build`` makes every conv of the net one)."""

    def _int8_init(self, out_dtype=torch.float32):
        self.site: Optional[str] = None     # its name, where it is an int8 site
        self.act_scale: Optional[float] = None
        self.absmax: Optional[float] = None  # under ``calibrate``: the largest |input|
        self.out_dtype = out_dtype

    def forward(self, x):
        if self.absmax is not None:
            return self._calib_conv(x)
        if self.act_scale is None:
            return super().forward(x)
        return int8_conv(x, self.weight, self.bias, self.stride, self.act_scale, self.out_dtype)

    def _calib_conv(self, x):
        """The float conv of the compute dtype: input, weights and bias rounded
        to it, float32 sums, the output rounded; the rounded input's absmax
        kept."""
        dt = self.out_dtype
        x = x.to(dt).float()
        self.absmax = max(self.absmax, float(x.abs().max()))
        out = F.conv3d(x, self.weight.detach().to(dt).float(), stride=self.stride,
                       padding=self.weight.shape[-1] // 2)
        if self.bias is not None:
            out = out + self.bias.detach().to(dt).float().view(1, -1, 1, 1, 1)
        return out.to(dt).float()


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (None: as it is), held in float32."""
    return x if dtype is None else x.to(dtype).float()


def _resize(x: torch.Tensor, size, dtype) -> torch.Tensor:
    return _rounded(model.resize(x, size), dtype)


class GN(model.GN):
    """``model.GN``, its output rounded to ``round_to``."""

    round_to = None

    def forward(self, x):
        return _rounded(super().forward(x), self.round_to)


class Block(model.Block):
    """``model.Block``, the residual sum rounded to ``round_to``."""

    round_to = None

    def forward(self, x):
        r = x if self.conv1 is None else self.conv1(x)
        return F.relu(_rounded(self.conv3(self.conv2(r)) + r, self.round_to))


class Module(model.Module):
    """``model.Module``, each resize and each sum of the fuse rounded to
    ``round_to``."""

    round_to = None

    def forward(self, xs):
        dt = self.round_to
        feats = [b(x) for b, x in zip(self.branches, xs)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = feats[0] if i == 0 else row[0](feats[0])
            for j in range(1, len(feats)):
                if j == i:
                    y = y + feats[j]
                elif j > i:
                    y = y + _resize(row[j](feats[j]), feats[i].shape[2:], dt)
                else:
                    y = y + row[j](feats[j])
                y = _rounded(y, dt)
            out.append(F.relu(y))
        return out


class Backbone(model.Backbone):
    """``model.Backbone``, its input and the final fuse's resizes rounded to
    ``round_to``."""

    round_to = None

    def forward(self, x):
        dt = self.round_to
        feats = self.backbone(_rounded(x, dt))
        top = feats[0]
        return self.final_conv(torch.cat([top] + [_resize(f, top.shape[2:], dt)
                                                  for f in feats[1:]], dim=1))


ROUNDED = {model.GN: GN, model.Block: Block, model.Module: Module, model.Backbone: Backbone}


def _head_outputs(net: model.PoseNet) -> set:
    """The output conv of each head tower: what ``_out`` names."""
    return {f"pose_head.tasks.{t}.{branch}.{len(getattr(task, branch)) - 1}"
            for t, task in enumerate(net.pose_head.tasks) for branch in ("reg", "hm")}


class PoseNet(model.PoseNet):
    """``model.PoseNet`` with TF32 off for each of its calls."""

    def features(self, x):
        with NoTF32():
            return super().features(x)

    def dense(self, x):
        with NoTF32():
            return super().dense(x)

    def predict(self, x, sparse: bool = True):
        with NoTF32():
            return super().predict(x, sparse)

    def train_outputs(self, x, ind, sparse: bool = False):
        with NoTF32():
            return super().train_outputs(x, ind, sparse)


def build(model_cfg: dict, in_channels: int, device=None) -> PoseNet:
    """``model.build``'s net as this module's ``PoseNet``, its convs this
    module's ``Conv``, the int8 sites named, no scale set (the float32
    net)."""
    net = model.build(model_cfg, in_channels, device)
    net.__class__ = PoseNet
    skip = _head_outputs(net)
    dtypes = {part: DTYPES[str(model_cfg[part].get("dtype") or "float32")]
              for part in ("backbone", "pose_head")}
    for name, m in net.named_modules():
        if isinstance(m, model.Conv):
            m.__class__ = Conv
            m._int8_init(dtypes[name.split(".")[0]])
            if name not in skip:
                m.site = name
        elif type(m) in ROUNDED:
            m.__class__ = ROUNDED[type(m)]
            m.compute_dtype = dtypes[name.split(".")[0]]
    return net


def sites(net: model.PoseNet) -> List[str]:
    """The int8 sites' names, in module order."""
    return [m.site for m in net.modules() if isinstance(m, Conv) and m.site is not None]


def _site_convs(net: model.PoseNet) -> Dict[str, Conv]:
    return {m.site: m for m in net.modules() if isinstance(m, Conv) and m.site is not None}


def _round_between(net: model.PoseNet, on: bool) -> None:
    """The values between the sites rounded to the compute dtype (``on``) or
    left float32."""
    for m in net.modules():
        if type(m) in ROUNDED.values():
            m.round_to = m.compute_dtype if on else None


def set_scales(net: model.PoseNet, scales: Optional[Dict[str, float]],
               rounded: bool = True) -> model.PoseNet:
    """Give each site its activation scale (``scales``: site name -> scale,
    every site and nothing else), or with None take them away (the float32
    net).  ``rounded``: the values between the sites rounded to the compute
    dtype (the module's doc); False leaves them float32 (the reading that
    shows why they are rounded).  Returns the net."""
    convs = _site_convs(net)
    if scales is not None and set(scales) != set(convs):
        raise KeyError(f"int8 scales differ from the sites: "
                       f"{sorted(set(scales) ^ set(convs))[:6]}")
    for name, m in convs.items():
        m.act_scale = None if scales is None else float(scales[name])
    _round_between(net, scales is not None and rounded)
    return net


def calibrate(net: model.PoseNet, batches) -> Tuple[Dict[str, float],
                                                   Dict[str, Tuple[float, float]]]:
    """The reference's own activation scales (site name -> scale): absmax /
    127 of each site's input rounded to its compute dtype (1.0 where the
    absmax is 0), the largest over ``batches`` ((B, Z, Y, X, C) prepared
    frames), each through the sparse predict of the float net of the
    compute dtype (the program's calibration forward): every site's conv in
    that dtype (``Conv._calib_conv``), the values between rounded as in the
    int8 forward.  And each site's absmax as the bounds (low, high) that
    the program's may take: the absmax itself, but at the regression
    tower's first conv, whose input is the 5^3 patch around the heatmap's
    peak, the least and the largest that a peak at any of a frame's
    near-ties (``evaluate.candidates``' rule) gives.  Leaves the net without
    scales."""
    convs = _site_convs(net)
    task = net.pose_head.tasks[0]
    patch_site = task.reg[0].site
    set_scales(net, None)
    _round_between(net, True)
    for m in convs.values():
        m.absmax = 0.0
    low = high = 0.0
    try:
        with torch.no_grad(), NoTF32():
            for b in batches:
                f = net.features(b)
                hm = task.hm(f)
                logits = hm.reshape(hm.shape[0], -1)
                net.reg_at(f, logits.argmax(dim=1), True)
                # each voxel's patch absmax: out of the volume the patch is zero
                patch = F.max_pool3d(f.to(task.reg[0].out_dtype).float().abs().amax(
                    dim=1, keepdim=True), 5, stride=1, padding=2).reshape(hm.shape[0], -1)
                top_v, top_i = torch.topk(logits, evaluate.TOP)
                near = top_v >= top_v[:, :1] - evaluate.MARGIN
                at = patch.gather(1, top_i)
                low = max(low, float(torch.where(near, at, torch.inf).amin(dim=1).max()))
                high = max(high, float(torch.where(near, at, 0.0).amax()))
        absmax = {name: m.absmax for name, m in convs.items()}
    finally:
        for m in convs.values():
            m.absmax = None
        _round_between(net, False)
    bounds = {name: (a, a) for name, a in absmax.items()}
    bounds[patch_site] = (low, high)
    return {name: (a / QMAX if a > 0 else 1.0) for name, a in absmax.items()}, bounds
