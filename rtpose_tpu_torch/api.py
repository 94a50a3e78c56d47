"""High-level assembly: Config -> model + decode spec + dataset.

Counterpart of ``rtpose_tpu/api.py``: the single point that interprets the
reference config schema (model / assigner / test_cfg / data dicts), for the
radar detector (``RadarPoseNet``, a dense cube in) and the LiDAR one
(``VoxelNet``, a voxel batch in).  ``resolve_device`` is the entry points'
device rule: the card unless the caller asks for the CPU, and an error,
never a silent CPU run, when no card is found.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Tuple

import torch

from . import parallel
from .core.decode import DecodeSpec
from .core.targets import PoseTargetSpec
from .data.cruw_pose import CubeGeometry
from .models import build_detector
from .data.builder import build_dataset


def resolve_device(device: str | None = None, multihost: bool = False) -> torch.device:
    """'cuda' (the default) or 'cpu'.  Raises when the card is asked for and
    absent.  Turns TF32 off: the head's float32 output convs would otherwise
    run in TF32 in cuDNN and move the heatmap argmax.

    ``multihost`` (``--multihost``): join the torchrun job this process was
    launched in (``parallel.init_distributed``; raises outside one), on
    ``cuda:LOCAL_RANK``, made the current device before the group is made."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if multihost:
        local_rank = parallel.torchrun_env()["local_rank"]
        if dev.type == "cuda":
            if local_rank >= torch.cuda.device_count():
                raise RuntimeError(f"LOCAL_RANK {local_rank}: this host has "
                                   f"{torch.cuda.device_count()} CUDA device(s)")
            dev = torch.device("cuda", local_rank)
            torch.cuda.set_device(dev)
        parallel.init_distributed(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


@dataclasses.dataclass
class Assembly:
    model: Any                     # RadarPoseNet or VoxelNet (nn.Module)
    decode_spec: DecodeSpec
    one_hm: bool
    model_cfg: Any = None          # the cfg.model dict the detector was built from
    target_spec: PoseTargetSpec = None
    input_shape_zyxc: Tuple[int, int, int, int] = None   # one model input, unbatched
    sensor: str = "radar"          # 'radar' (dense cube) | 'lidar' (voxels)
    voxel_shape: Tuple[int, int, int] = None   # (V, P, F) of the lidar path
    # test_cfg double_flip: eval averages the forwards of the pipeline's
    # {y,x,double_}flip_* voxel sets (CenterPoint TTA); lidar only
    tta_double_flip: bool = False

    @property
    def input_key(self):
        """Batch key of the model input; None: the model takes the voxel
        sub-dict (``engine.steps.VOXEL_KEYS``)."""
        return "rdr_tensor" if self.sensor == "radar" else None

    def example_input(self, batch: int = 1, device=None):
        """A zeros model input: a (B, Z, Y, X, C) float32 cube, or the voxel
        dict (voxels (B, V, P, F) float32, num_points_per_voxel (B, V),
        coors (B, V, 3) and num_voxels (B,), int32)."""
        if self.sensor == "radar":
            return torch.zeros((batch, *self.input_shape_zyxc), dtype=torch.float32,
                               device=device)
        V, P, F = self.voxel_shape
        return dict(
            voxels=torch.zeros((batch, V, P, F), dtype=torch.float32, device=device),
            num_points_per_voxel=torch.zeros((batch, V), dtype=torch.int32, device=device),
            coors=torch.zeros((batch, V, 3), dtype=torch.int32, device=device),
            num_voxels=torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def head(self):
        """The CenterHead (its ``loss`` is the train step's)."""
        return self.model.pose_head

    @property
    def sparse_head(self) -> bool:
        """The sparse reg-tower path: single-task, single-peak one-heatmap
        configs.  Multi-person configs run the dense step and the multi-peak
        decode; the deformable head needs the full feature map, so its
        configs run dense too, and so does the LiDAR detector
        (``rtpose_tpu/api.py:40-50``)."""
        return (self.one_hm and self.sensor == "radar"
                and len(self.model_cfg["pose_head"]["tasks"]) == 1
                and self.target_spec.max_poses == 1
                and not self.model_cfg["pose_head"].get("dcn_head"))

    @property
    def multi_poses(self) -> int:
        """Top-P multi-person decode count (0 = single-person surface)."""
        if self.one_hm and self.sensor == "radar" and self.target_spec.max_poses > 1:
            return self.target_spec.max_poses
        return 0


def input_channels(dataset_cfg: Dict[str, Any]) -> int:
    """Channel count from RDR_TYPE and DOPPLER_BINS: D Doppler bins, twice
    that for complex cubes (real and imaginary parts), 1 or 2 without
    Doppler."""
    rdr_type = dataset_cfg.get("RDR_TYPE", "zyx_real")
    d_bins = int(dataset_cfg.get("DOPPLER_BINS", 32))
    if "d" in rdr_type:
        return 2 * d_bins if "complex" in rdr_type else d_bins
    return 2 if "complex" in rdr_type else 1


def grid_from_cfg(dataset_cfg: Dict[str, Any]) -> Tuple[int, int, int]:
    roi = None
    if dataset_cfg["RDR_CUBE"].get("IS_CONSIDER_ROI", False):
        roi_type = dataset_cfg["RDR_CUBE"].get("ROI_TYPE",
                                               dataset_cfg["LABEL"]["ROI_TYPE"])
        roi = {k: list(v) for k, v in dataset_cfg["ROI"][roi_type].items()}
    return CubeGeometry.from_roi(roi).grid_zyx


def assemble(cfg) -> Assembly:
    """Build the model (on the CPU, uninitialized weights) and specs from a
    loaded Config (or plain dict-of-dicts)."""
    get = cfg.get if hasattr(cfg, "get") else cfg.__getitem__
    dataset_cfg = dict(get("DATASET"))
    model_cfg = copy.deepcopy(dict(get("model")))
    assigner_cfg = dict(get("train_cfg")["assigner"])
    test_cfg = dict(get("test_cfg"))
    mode = get("assigner_mode") or "one_hm"

    grid = grid_from_cfg(dataset_cfg)
    osf = tuple(int(f) for f in assigner_cfg.get("out_size_factor", (1, 1, 1)))
    decode_spec = DecodeSpec(
        grid_zyx=tuple(g // f for g, f in zip(grid, osf)),
        pc_range_min_xyz=tuple(float(v) for v in test_cfg["pc_range"]),
        voxel_size_xyz=tuple(float(v) for v in test_cfg["voxel_size"]),
        out_size_factor_zyx=osf,
        score_threshold=float(test_cfg.get("score_threshold", 0.0)),
    )
    target_spec = PoseTargetSpec(
        grid_zyx=decode_spec.grid_zyx,
        pc_range_min_xyz=decode_spec.pc_range_min_xyz,
        voxel_size_xyz=tuple(float(v) for v in dataset_cfg["RDR_CUBE"]["GRID_SIZE"]),
        out_size_factor_zyx=osf,
        max_poses=int(assigner_cfg.get("max_poses", 1)),
        min_radius=int(assigner_cfg.get("min_radius", 2)),
        mode=mode,
        num_classes=len(model_cfg["pose_head"]["tasks"][0]["class_names"]))
    sensor = "lidar" if model_cfg.get("type") == "VoxelNet" else "radar"
    voxel_shape = None
    if sensor == "lidar":
        # the voxel batch's fixed shape: the train pipeline's Voxelization
        # stage (pose.py:52-142 schema) and the reader's feature width
        vox_cfg = next((dict(p.get("cfg", p)) for p in get("train_pipeline")
                        if p.get("type") == "Voxelization"), {})
        V = vox_cfg.get("max_voxel_num", 20000)
        if isinstance(V, (list, tuple)):
            V = V[0]
        voxel_shape = (int(V), int(vox_cfg.get("max_points_in_voxel", 35)),
                       int(model_cfg["reader"].get("num_input_features", 4)))
    return Assembly(model=build_detector(model_cfg), decode_spec=decode_spec,
                    one_hm=(mode == "one_hm"), model_cfg=model_cfg,
                    target_spec=target_spec,
                    input_shape_zyxc=(*grid, input_channels(dataset_cfg)),
                    sensor=sensor, voxel_shape=voxel_shape,
                    tta_double_flip=sensor == "lidar" and bool(test_cfg.get("double_flip")))


def serving_variant(asm: Assembly, final_dtype) -> Assembly:
    """Assembly copy whose head OUTPUT convs compute in ``final_dtype``
    (e.g. ``'bfloat16'``); the weights are kept."""
    cfg = copy.deepcopy(asm.model_cfg)
    cfg["pose_head"]["final_dtype"] = final_dtype
    model = copy.deepcopy(asm.model)
    model.pose_head.set_final_dtype(final_dtype)
    return dataclasses.replace(asm, model=model, model_cfg=cfg)


def build_dataset_from_cfg(data_cfg: Dict[str, Any], split: str,
                           device_preprocess: bool = False, max_poses: int = 1):
    """Build a dataset from cfg.data.{train,val,test} (reference schema),
    through ``data.builder.build_dataset`` (registry keys or the factory's
    short names).  ``split``, ``max_poses`` and the flags reach every child of a wrapper
    (``data/wrappers.py``)."""
    dcfg = dict(data_cfg[split])
    dcfg.pop("class_names", None)
    dcfg["split"] = "train" if split == "train" else "test"
    dcfg["max_poses"] = max_poses
    if max_poses > 1:
        # multi-person configs: one sample per frame carrying all its people
        dcfg["group_by_frame"] = True
    if device_preprocess:
        dcfg["device_preprocess"] = True
    return build_dataset(dcfg)
