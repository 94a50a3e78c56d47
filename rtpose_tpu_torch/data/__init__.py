from .builder import build_dataset
from .cruw_pose import CRUWPoseDataset, CRUWPoseLidarDataset, CubeGeometry
from .factory import dataset_factory, get_dataset
from .loader import (BatchLoader, DeviceCachedLoader, StreamingDeviceLoader,
                     shard_indices)
from .synthetic import generate_synthetic_dataset
from .wrappers import ConcatDataset, RepeatDataset

__all__ = ["build_dataset", "dataset_factory", "get_dataset", "CRUWPoseDataset",
           "CRUWPoseLidarDataset", "CubeGeometry", "BatchLoader", "DeviceCachedLoader",
           "StreamingDeviceLoader", "shard_indices", "generate_synthetic_dataset",
           "ConcatDataset", "RepeatDataset"]
