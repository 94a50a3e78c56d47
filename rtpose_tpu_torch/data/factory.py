"""Dataset factory: short dataset names -> dataset classes.

Counterpart of ``rtpose_tpu/data/factory.py`` (reference
``det3d/datasets/dataset_factory.py:1-11``, which is broken as shipped: it
imports ``.nuscenes`` / ``.waymo`` modules the fork does not have).  The
factory covers the datasets that exist and resolves late, through the
registry at call time.
"""

from __future__ import annotations

from ..registry import DATASETS

# short name -> registry key
dataset_factory = {
    "CRUW_POSE": "CRUW_POSE_Dataset",
    "CRUW_POSE_LIDAR": "CRUW_POSE_Lidar_Dataset",
    "CONCAT": "ConcatDataset",
    "REPEAT": "RepeatDataset",
}


def get_dataset(dataset_name: str):
    """The dataset class of a short factory name or a registry key; a
    KeyError listing every known name otherwise."""
    key = dataset_factory.get(dataset_name, dataset_name)
    cls = DATASETS.get(key)
    if cls is None:
        known = sorted(set(list(dataset_factory) + list(DATASETS.module_dict)))
        raise KeyError(f"unknown dataset {dataset_name!r}; known: {known}")
    return cls
