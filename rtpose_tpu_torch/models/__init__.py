"""Model zoo of the port: layers, HRNet3D, CenterHead, the readers,
RadarPoseNet and VoxelNet.  Importing registers every module with the
registries."""

from .center_head import CenterHead, SepHead
from .detectors import RadarPoseNet, build_detector, init_weights
from .hrnet3d import MODEL_CONFIGS, HRNet3D
from .layers import GNConv, GroupNorm8, ResNetBlock, SingleConv, TorchConv3d
from .readers import (PillarFeatureNet, PointPillarsScatter, RadarFeatureNet,
                      VoxelFeatureExtractorV3)
from .voxelnet import VoxelNet

__all__ = ["CenterHead", "SepHead", "RadarPoseNet", "build_detector",
           "init_weights", "MODEL_CONFIGS", "HRNet3D", "GNConv", "GroupNorm8",
           "ResNetBlock", "SingleConv", "TorchConv3d", "RadarFeatureNet",
           "VoxelFeatureExtractorV3", "PillarFeatureNet", "PointPillarsScatter", "VoxelNet"]
