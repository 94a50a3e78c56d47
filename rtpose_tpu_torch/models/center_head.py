"""CenterPoint/CenterNet-style pose head (PyTorch, channels-last).

Counterpart of ``rtpose_tpu/models/center_head.py`` (reference
``det3d/models/pose_heads/center_head.py``):

* optional shared conv (GN8 + 3x3x3 conv + ReLU) when the backbone output
  width differs from ``share_conv_channel`` (``shared``), then the task heads
  (``heads``); ``forward`` is the two in turn;
* per-task ``SepHead``: each named head ('reg', 'hm', ...) is a conv tower —
  (num_conv - 1) x [3x3x3 conv(head_conv) + ReLU] then a final 3x3x3 conv
  to the target width, computed in ``final_dtype`` (float32 by default);
  the heatmap head's final bias initializes to ``init_bias`` = -2.19;
* ``predict`` = dense decode (``core.decode.decode_pose_preds``);
* ``dcn_head=True``: each task is a ``models.dcn_head.DCNSepHead``
  (``rtpose_tpu/models/center_head.py:133-140``).

* ``loss`` = per-task focal (``focal_form``: ``"logits"``, the shipped
  form, or the reference's ``"clamped"``) + ``weight`` x code-weighted L1
  (``rtpose_tpu/models/center_head.py:154-192``).

State-dict keys follow the reference:
``tasks.{t}.{head}.{0,2,..}.{weight,bias}``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..core.decode import decode_pose_preds
from ..registry import HEADS
from .layers import GroupNorm8, TorchConv3d, canonical_dtype
from .losses import clamped_sigmoid, fast_focal_loss, fast_focal_loss_logits, reg_loss


class SepHead(nn.Module):
    """Separate conv tower per named output head."""

    def __init__(self, in_channels: int, heads: Dict[str, Tuple[int, int]],
                 head_conv: int = 64, final_kernel: int = 3,
                 init_bias: float = -2.19, dtype=None,
                 final_dtype=torch.float32):
        super().__init__()
        self.heads = dict(heads)
        self.init_bias = init_bias
        self.final_dtype = canonical_dtype(final_dtype)
        for head, (classes, num_conv) in self.heads.items():
            layers = []
            ch = in_channels
            for _ in range(num_conv - 1):
                layers += [TorchConv3d(ch, head_conv, final_kernel, dtype=dtype), nn.ReLU()]
                ch = head_conv
            layers.append(TorchConv3d(ch, classes, final_kernel,
                                      dtype=self.final_dtype))
            setattr(self, head, nn.Sequential(*layers))

    def set_final_dtype(self, final_dtype) -> None:
        """Compute dtype of the output convs (serving-side knob)."""
        self.final_dtype = canonical_dtype(final_dtype)
        for head in self.heads:
            getattr(self, head)[-1].dtype = self.final_dtype

    def forward(self, x: torch.Tensor, branch: Optional[str] = None,
                inner_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """All heads, or only ``branch``.  ``inner_mask`` zeroes the
        intermediate activations outside the original volume, so a small
        patch reproduces the dense path's inter-conv zero padding."""
        out = {}
        fdt = self.final_dtype
        for head in self.heads:
            if branch is not None and head != branch:
                continue
            tower = getattr(self, head)
            h = x
            for layer in tower[:-1]:
                h = layer(h)
                if isinstance(layer, nn.ReLU) and inner_mask is not None:
                    h = h * inner_mask
            # the output conv defaults to float32: heatmap logits feed the
            # argmax and log terms, the regression an L1
            h = h.float() if fdt in (None, torch.float32) else h
            out[head] = tower[-1](h).float()
        return out


@HEADS.register_module
class CenterHead(nn.Module):
    """Multi-task center head."""

    def __init__(self, tasks: Sequence[dict], in_channels: int = 128,
                 share_conv_channel: int = 64,
                 common_heads: Optional[Dict[str, Tuple[int, int]]] = None,
                 weight: float = 0.1, code_weights: Sequence[float] = (),
                 init_bias: float = -2.19, num_hm_conv: int = 2,
                 dataset: str = "cruw_pose", dcn_head: bool = False,
                 dtype=None, final_dtype=torch.float32, focal_form: str = "logits"):
        super().__init__()
        if focal_form not in ("logits", "clamped"):
            raise ValueError(f"focal_form must be 'logits' or 'clamped', got {focal_form!r}")
        self.focal_form = focal_form
        self.tasks_cfg = [dict(t) for t in tasks]
        self.weight = weight
        self.code_weights = tuple(code_weights)
        # the loss's weights where the parameters are (no state_dict entry)
        self.register_buffer("code_w", torch.tensor(self.code_weights, dtype=torch.float32),
                             persistent=False)
        ch = in_channels
        if in_channels != share_conv_channel:
            self.shared_conv = nn.Sequential(
                GroupNorm8(in_channels),
                TorchConv3d(in_channels, share_conv_channel, 3, bias=False,
                            dtype=dtype),
                nn.ReLU())
            ch = share_conv_channel
        else:
            self.shared_conv = None
        task_heads = []
        for num_cls in self.num_classes:
            heads = {k: tuple(v) for k, v in (common_heads or {}).items()}
            if dcn_head:
                # the deformable head (models/dcn_head.py): built, as in the
                # JAX package, without the compute and final dtypes
                from .dcn_head import DCNSepHead
                task_heads.append(DCNSepHead(ch, num_cls, heads, head_conv=32,
                                             init_bias=init_bias))
                continue
            heads["hm"] = (num_cls, num_hm_conv)
            task_heads.append(SepHead(ch, heads, head_conv=32, final_kernel=3,
                                      init_bias=init_bias, dtype=dtype,
                                      final_dtype=final_dtype))
        self.tasks = nn.ModuleList(task_heads)

    @property
    def num_classes(self) -> List[int]:
        return [len(t["class_names"]) for t in self.tasks_cfg]

    def set_final_dtype(self, final_dtype) -> None:
        for t in self.tasks:
            t.set_final_dtype(final_dtype)

    def shared(self, x: torch.Tensor) -> torch.Tensor:
        """The shared conv over the whole grid; the identity without one.  Its
        3x3x3 conv and GroupNorm need the whole volume, so the sparse paths
        apply it densely before they cut patches."""
        return x if self.shared_conv is None else self.shared_conv(x)

    def heads(self, x: torch.Tensor, branch: Optional[str] = None,
              inner_mask: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
        """The task heads on an already-shared feature: every head, or a
        single ``branch``; ``inner_mask`` marks the in-volume positions of
        the sparse path's patches."""
        return [t(x, branch=branch, inner_mask=inner_mask) for t in self.tasks]

    def forward(self, x: torch.Tensor, branch: Optional[str] = None
                ) -> List[Dict[str, torch.Tensor]]:
        """Dense heads, or a single ``branch``."""
        return self.heads(self.shared(x), branch)

    def loss(self, example: Dict[str, list], preds_dicts: List[Dict[str, torch.Tensor]],
             num_pos: Optional[torch.Tensor] = None) -> Dict[str, list]:
        """Per-task losses.  ``example`` carries per-task lists: hm
        (B, Z, Y, X, C), anno_pose (B, M, D), ind / mask / cat (B, M).
        ``num_pos`` (T,): each task's positive count to normalize by in place
        of the batch's own (``models.losses``).
        Returns per-task lists ``loss``, ``hm_loss``, ``loc_loss``,
        ``loc_loss_elem`` (D,) and ``num_positive``."""
        merged: Dict[str, list] = {k: [] for k in ("loss", "hm_loss", "loc_loss",
                                                   "loc_loss_elem", "num_positive")}
        for t, preds in enumerate(preds_dicts):
            hm, ind = example["hm"][t], example["ind"][t]
            mask, cat = example["mask"][t], example["cat"][t]
            n = None if num_pos is None else num_pos[t]
            if self.focal_form == "clamped":
                hm_loss = fast_focal_loss(clamped_sigmoid(preds["hm"].float()), hm,
                                          ind, mask, cat, n)
            else:
                hm_loss = fast_focal_loss_logits(preds["hm"], hm, ind, mask, cat, n)
            rl = reg_loss(preds["reg"].float(), mask, ind, example["anno_pose"][t], n)
            loc_loss = torch.sum(rl * self.code_w)
            merged["loss"].append(hm_loss + self.weight * loc_loss)
            merged["hm_loss"].append(hm_loss)
            merged["loc_loss"].append(loc_loss)
            merged["loc_loss_elem"].append(rl)
            merged["num_positive"].append(mask.float().sum())
        return merged

    def predict(self, preds_dicts: List[Dict[str, torch.Tensor]], decode_spec):
        """Decode each task's dense output to (kpts, scores, labels)."""
        return [decode_pose_preds(p["hm"], p["reg"], decode_spec)
                for p in preds_dicts]
