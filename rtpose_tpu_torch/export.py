"""Serving export: self-contained predict artifacts via ``torch.export``.

Counterpart of ``rtpose_tpu/export.py``.  The predict path, forward and
decode (``make_eval_step``'s sparse branch, or the dense decode), is traced
once with ``torch.export`` and saved as a ``.pt2`` program with the weights
baked in: the float weights already cast and laid out for the kernels,
or, with ``int8_scales``, the int8 weights and the activation scales; and
``final_dtype``.  The batch is static.  The kernels are reached through
their ``torch.ops.rtpose`` custom ops (``ops/library.py``).

    ep = export_predict(asm, batch_size=8, device="cuda")
    save_exported("model.pt2", ep)
    predict = load_predict("model.pt2")   # predict(cube) -> [(kpts, scores, labels)]

A multi-person artifact (``multi_poses`` > 1) returns ``[(kpts, scores)]``.
A LiDAR artifact (VoxelNet) takes the voxel dict (``engine.steps.
VOXEL_KEYS``: voxels, num_points_per_voxel, coors, num_voxels) where a
radar one takes the cube; the program's inputs are its four tensors in
that order (the JAX ``export.py:64-66``).

JAX's ``platforms`` becomes the one device the artifact was exported for,
recorded in it; loading it for another device raises.

On the card a loaded radar artifact's program is replayed from a CUDA
graph, as the live eval step is (``engine.steps.EvalGraphs``, on
``predict.graphs``): its first call at a cube's shape runs eagerly, its
second is captured, every later call copies the cube in and replays.  Run
eagerly, the program dispatches its ~1,500 operations one by one from the
host, which took longer than the card's work (the flagship's int8 artifact
at B=8 on an H100: 62 host ms and 82 ms a call, against 50 ms replayed)
and left the time of a call to the host's speed.

A loaded artifact's calls run inside the span ``serve.predict`` and are
counted in ``counts()``: ``predict_calls``, ``frames`` (the artifact's
static batch a call) and ``int8_sites`` (the metadata's, of the artifact
loaded last; 0 for a float one), the Python call's; the captures, replays
and eager calls are ``predict.graphs.counts()``.  ``reset`` zeroes all but
``int8_sites``.  Inside the loaded program no Python of the package runs
but the custom ops': ``ops.launch_counts()`` counts the kernels an eager
call or a capture launches (a replay passes no wrapper), while
``ops.quant.counts()`` and the span ``int8.site`` stay silent.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import zipfile
from typing import Optional

import torch
import torch.nn as nn

from .core.decode import decode_pose_multi, decode_pose_sparse
from .engine.convert import bind_sites
from .engine.steps import VOXEL_KEYS, EvalGraphs
from .models.layers import TorchConv3d
from .ops import quant
from .utils import trace

META_FILE = "rtpose_meta.json"

_COUNTS = dict(predict_calls=0, frames=0, int8_sites=0)


def counts() -> dict:
    """A loaded artifact's calls since the last ``reset`` (the module's doc)."""
    return dict(_COUNTS)


def reset() -> None:
    """Zero the counts; ``int8_sites`` stays the loaded artifact's."""
    for k in _COUNTS:
        if k != "int8_sites":
            _COUNTS[k] = 0


class Predictor(nn.Module):
    """``model_input -> (kpts, scores, labels, ...)``, three tensors per task,
    or with ``multi_poses`` = P > 1 ``(kpts (B, P, K, 3), scores (B, P))``
    (the dense forward and ``decode_pose_multi``).

    ``model_input`` is the normalized (B, Z, Y, X, C) float32 cube, or with
    ``preprocess = (norm_start, norm_scale)`` the ROI-cropped raw (B, D, Z,
    Y, X) cube, preprocessed on the device first, or with ``voxel_input``
    the four voxel tensors (``VOXEL_KEYS`` order).  With ``int8_scales``
    the forward runs inside ``quant.int8_mode``, so the int8 program is what
    runs, or is traced."""

    def __init__(self, model, decode_spec, sparse: bool, preprocess: Optional[tuple] = None,
                 int8_scales: Optional[dict] = None,
                 int8_exclude: tuple = quant.DEFAULT_EXCLUDE, multi_poses: int = 0,
                 voxel_input: bool = False):
        super().__init__()
        self.model = model
        self.voxel_input = voxel_input
        self.decode_spec = decode_spec
        self.sparse = sparse
        self.multi_poses = int(multi_poses)
        self.preprocess = None if preprocess is None else tuple(float(v) for v in preprocess)
        self.int8_scales = None if int8_scales is None else dict(int8_scales)
        self.int8_exclude = tuple(int8_exclude)

    def forward(self, *inputs: torch.Tensor):
        if self.voxel_input:
            x = dict(zip(VOXEL_KEYS, inputs))
        else:
            (x,) = inputs
        if self.preprocess is not None:
            _, _, Z, Y, X = x.shape
            x = torch.ops.rtpose.preprocess(x, [0, Z - 1, 0, Y - 1, 0, X - 1], *self.preprocess)
        ctx = (contextlib.nullcontext() if self.int8_scales is None
               else quant.int8_mode(self.int8_scales, exclude=self.int8_exclude))
        with ctx:
            if self.multi_poses > 1:
                preds = self.model(x)
                outs = [decode_pose_multi(preds[0]["hm"], preds[0]["reg"], self.decode_spec,
                                          max_objects=self.multi_poses)]
            elif self.sparse:
                hm, reg_at_peak, peak_ind = self.model.predict_sparse(x)
                outs = [decode_pose_sparse(hm, reg_at_peak, peak_ind, self.decode_spec)]
            else:
                outs = self.model.pose_head.predict(self.model(x), self.decode_spec)
        return tuple(t for task in outs for t in task)


def _inputs(model_input) -> tuple:
    """A model input as the predictor's positional tensors."""
    if isinstance(model_input, dict):
        return tuple(model_input[k] for k in VOXEL_KEYS)
    return (model_input,)


def _grouped(flat, multi_poses: int = 0):
    """The flat outputs per task: (kpts, scores, labels), or (kpts, scores)
    of the multi-person decode."""
    n = 2 if multi_poses > 1 else 3
    return [tuple(flat[i:i + n]) for i in range(0, len(flat), n)]


def _serving_model(asm, final_dtype):
    if final_dtype is not None:
        from .api import serving_variant
        asm = serving_variant(asm, final_dtype)
    bind_sites(asm.model)
    return asm


def make_predict_fn(asm, preprocess: Optional[tuple] = None,
                    int8_scales: Optional[dict] = None,
                    int8_exclude: tuple = quant.DEFAULT_EXCLUDE, final_dtype=None):
    """The serving function ``model_input -> [(kpts, scores, labels)]`` on
    ``asm.model`` as it stands (its device, its weights), eager.

    ``int8_scales`` (from :func:`calibrate_predict`) runs every
    non-excluded site in int8; ``final_dtype`` (e.g. ``'bfloat16'``)
    overrides the head output convs' compute dtype (``api.serving_variant``,
    a copy of the model)."""
    asm = _serving_model(asm, final_dtype)
    pred = Predictor(asm.model, asm.decode_spec, asm.sparse_head, preprocess,
                     int8_scales, int8_exclude, asm.multi_poses, asm.input_key is None)

    def predict(model_input):
        with torch.inference_mode():
            return _grouped(pred(*_inputs(model_input)), asm.multi_poses)

    predict.model = asm.model
    return predict


def calibrate_predict(asm, batches, preprocess: Optional[tuple] = None,
                      exclude: tuple = quant.DEFAULT_EXCLUDE, final_dtype=None,
                      quantile: Optional[float] = None) -> dict:
    """Activation scales for the int8 predict path: one forward per batch of
    model inputs over the same function :func:`make_predict_fn` serves.
    ``quantile`` switches the statistic from absmax to a clipped quantile of
    |x| (see ``quant.calibrate``)."""
    predict = make_predict_fn(asm, preprocess=preprocess, final_dtype=final_dtype)
    return quant.calibration_scales(predict, batches, exclude=exclude, quantile=quantile)


def export_predict(asm, batch_size: int = 1, device: str = "cuda",
                   preprocess: Optional[tuple] = None, int8_scales: Optional[dict] = None,
                   int8_exclude: tuple = quant.DEFAULT_EXCLUDE,
                   final_dtype=None) -> torch.export.ExportedProgram:
    """Trace the predict path for a static ``batch_size`` on ``device``.

    A copy of ``asm.model`` is moved to the device and run once under
    ``no_grad`` on a zeros input, which prepares every conv's weights (cast
    and laid out, or quantized); ``TorchConv3d.freeze`` then keeps them as
    buffers, and ``torch.export`` traces the copy under ``no_grad`` (its
    trace is a dispatch mode, so the kernels' wrappers call their custom
    ops, ``ops.build.dispatch_mode_active``).  The
    artifact's metadata (``.rtpose_meta``) records the device, the batch,
    the input, the int8 sites and ``final_dtype``."""
    from .api import resolve_device

    dev = resolve_device(device)
    asm = _serving_model(asm, final_dtype)
    model = copy.deepcopy(asm.model).to(dev).eval()     # the sites' names come along
    pred = Predictor(model, asm.decode_spec, asm.sparse_head, preprocess, int8_scales,
                     int8_exclude, asm.multi_poses, asm.input_key is None)
    Z, Y, X, C = asm.input_shape_zyxc
    if preprocess is None:
        example = _inputs(asm.example_input(batch_size, dev))
    else:
        # raw cubes as the loader ships them under --device_preprocess
        example = (torch.zeros((batch_size, C, Z, Y, X), dtype=torch.float16, device=dev),)
    convs = [m for m in model.modules() if isinstance(m, TorchConv3d)]
    for m in convs:
        m._prepared, m._prepared_int8 = None, {}    # what the live model kept
    with torch.no_grad():
        pred(*example)
        for m in convs:
            m.freeze()
        ep = torch.export.export(pred, example, strict=False)
    # the saved artifact would carry the zeros input (168 MB at B=8 on the flagship)
    ep.example_inputs = None
    shapes = [list(t.shape) for t in example]
    dtypes = [str(t.dtype).replace("torch.", "") for t in example]
    ep.rtpose_meta = dict(
        device=dev.type, batch_size=batch_size,
        input_shape=shapes[0] if len(example) == 1 else dict(zip(VOXEL_KEYS, shapes)),
        input_dtype=dtypes[0] if len(example) == 1 else dict(zip(VOXEL_KEYS, dtypes)),
        preprocess=None if preprocess is None else [float(v) for v in preprocess],
        int8_sites=None if int8_scales is None else len(int8_scales),
        multi_poses=asm.multi_poses,
        final_dtype=None if final_dtype is None else str(final_dtype).replace("torch.", ""))
    return ep


def save_exported(path: str, ep: torch.export.ExportedProgram) -> None:
    """Write the artifact (``torch.export.save``, metadata beside it)."""
    torch.export.save(ep, path, extra_files={META_FILE: json.dumps(ep.rtpose_meta)})


def load_predict(path_or_bytes, device: Optional[str] = None):
    """Load an artifact into ``predict(model_input) -> [(kpts, scores,
    labels)]``.  Needs only ``torch`` and the port's op library, which
    ``import rtpose_tpu_torch.ops`` registers (imported here).  ``device``
    defaults to the artifact's own; another device raises, as does a CUDA
    artifact where no card is found.  ``predict.meta`` holds the metadata
    (``batch_size``, ``input_shape``, ``device``, ...)."""
    from . import ops  # noqa: F401  registers torch.ops.rtpose

    data = bytes(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) \
        else open(path_or_bytes, "rb").read()
    # the metadata first (a .pt2 is a zip archive): refuse before deserializing
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        names = [n for n in z.namelist() if n.split("/")[-2:] == ["extra", META_FILE]]
        if not names:
            raise ValueError(f"not a serving artifact of this package: no {META_FILE}")
        meta = json.loads(z.read(names[0]))
    if device is not None and torch.device(device).type != meta["device"]:
        raise ValueError(f"artifact exported for {meta['device']}, asked to load on {device}")
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("artifact exported for cuda: no CUDA device found")
    module = torch.export.load(io.BytesIO(data)).module()
    graphs = None
    if not isinstance(meta["input_shape"], dict):     # a radar cube: one tensor
        graphs = EvalGraphs(lambda batch: [module(batch["x"])], module, "x")
    _COUNTS["int8_sites"] = int(meta.get("int8_sites") or 0)

    def predict(model_input):
        with trace.span("serve.predict"), torch.no_grad():
            _COUNTS["predict_calls"] += 1
            _COUNTS["frames"] += int(meta["batch_size"])
            args = _inputs(model_input)
            outs = module(*args) if graphs is None else graphs({"x": args[0]})[0]
            return _grouped(outs, meta.get("multi_poses", 0))

    predict.meta = meta
    predict.graphs = graphs
    return predict
