"""Abstract point-cloud dataset base (det3d/datasets/custom.py:12-190 parity).

A copy of ``rtpose_tpu/data/point_cloud.py``.  The reference ships
``PointCloudDataset`` as the det3d abstract contract that all dataset
classes are meant to subclass: it pins the class attributes
(``NumPointFeatures``, ``CLASSES``), composes the transform pipeline, sets a
uniform aspect-group ``flag`` (custom.py:160-168), and declares the abstract
surface (``__getitem__`` / ``__len__`` / ``get_sensor_data`` / ``evaluation``
/ ``ground_truth_annotations``).  In the reference it is dormant (the CRUW
dataset re-implements the contract without inheriting); here it is the live
base class: ``CRUWPoseDataset`` (and through it the lidar dataset) inherits
the group-batching ``flag`` and implements the abstract surface, and
``loader.group_shard_indices`` consumes exactly what it defines.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..registry import DATASETS


@DATASETS.register_module
class PointCloudDataset:
    """Abstract base: subclasses override ``__len__``/``__getitem__`` (and
    usually ``get_sensor_data``/``evaluation``)."""

    NumPointFeatures = -1
    CLASSES = None

    def __init__(self, root_path: str, info_path: Optional[str] = None,
                 pipeline=None, test_mode: bool = False, class_names=None,
                 **kwargs):
        self._root_path = root_path
        self._info_path = info_path
        self._class_names = class_names
        self.test_mode = bool(test_mode)
        if pipeline is None:
            self.pipeline = None
        else:
            from .pipelines import Compose
            self.pipeline = (pipeline if callable(pipeline)
                             else Compose(pipeline))
        self._set_group_flag()

    # -- abstract surface (reference custom.py:44-142) ----------------------
    def __getitem__(self, index: int) -> Dict[str, Any]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def get_sensor_data(self, query) -> Dict[str, Any]:
        """Unified sensor access: int index -> {sensor_name: sensor_data}
        (points arrays for lidar, metadata dict, optional annotations)."""
        raise NotImplementedError

    def evaluation(self, detections, output_dir: Optional[str] = None):
        """Dataset-specific metric computation over a detections dict."""
        raise NotImplementedError

    @property
    def ground_truth_annotations(self):
        """KITTI-format GT annotations (reference custom.py:122-142:
        name/location/dimensions/rotation_y per frame)."""
        raise NotImplementedError

    # -- provided behavior ---------------------------------------------------
    def _set_group_flag(self):
        """Uniform aspect-group flags (reference custom.py:160-168 sets all
        ones); subclasses with heterogeneous samples overwrite ``self.flag``
        and the loaders batch within groups (group_shard_indices)."""
        try:
            n = len(self)
        except NotImplementedError:
            self.flag = None
            return
        self.flag = np.ones(n, dtype=np.uint8)

    @property
    def root_path(self) -> str:
        return self._root_path

    def exists(self, *rel: str) -> bool:
        return os.path.exists(os.path.join(self._root_path, *rel))
