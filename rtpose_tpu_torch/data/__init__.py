from .cruw_pose import CRUWPoseDataset, CubeGeometry
from .loader import (BatchLoader, DeviceCachedLoader, StreamingDeviceLoader,
                     shard_indices)
from .synthetic import generate_synthetic_dataset
from .wrappers import ConcatDataset, RepeatDataset

__all__ = ["CRUWPoseDataset", "CubeGeometry", "BatchLoader", "DeviceCachedLoader",
           "StreamingDeviceLoader", "shard_indices", "generate_synthetic_dataset",
           "ConcatDataset", "RepeatDataset"]
