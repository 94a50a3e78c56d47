"""Model zoo of the port: layers, HRNet3D, CenterHead, the readers,
RadarPoseNet and VoxelNet, the RPN neck, the polar-to-cartesian transform,
the BEV second stage, the RoI head and the LiDAR -> radar distillation.
Importing registers every module with the registries."""

from .center_head import CenterHead, SepHead
from .detectors import RadarPoseNet, build_detector, init_weights
from .hrnet3d import MODEL_CONFIGS, HRNet3D
from .layers import GNConv, GroupNorm8, ResNetBlock, SingleConv, TorchConv3d
from .readers import (PillarFeatureNet, PointPillarsScatter, RadarFeatureNet,
                      VoxelFeatureExtractorV3)
from .voxelnet import VoxelNet
from .necks import RPN, BatchNormNHWC
from .feat_transforms import PolarToCart
from .second_stage import BEVFeatureExtractor, bilinear_interpolate
from .roi_head import RoIHead, assign_roi_targets
from .losses import jde_embedding_loss
from .distillation import Distillation

__all__ = ["CenterHead", "SepHead", "RadarPoseNet", "build_detector",
           "init_weights", "MODEL_CONFIGS", "HRNet3D", "GNConv", "GroupNorm8",
           "ResNetBlock", "SingleConv", "TorchConv3d", "RadarFeatureNet",
           "VoxelFeatureExtractorV3", "PillarFeatureNet", "PointPillarsScatter", "VoxelNet",
           "RPN", "BatchNormNHWC", "PolarToCart", "BEVFeatureExtractor", "bilinear_interpolate",
           "RoIHead", "assign_roi_targets", "jde_embedding_loss", "Distillation"]
