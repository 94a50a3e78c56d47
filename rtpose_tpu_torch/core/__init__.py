from .decode import (DecodeSpec, decode_pose_preds, decode_pose_sparse,
                     flat_argmax, post_process_pose, unflip_pose_preds)
from .gaussian import dense_pose_heatmap, draw_gaussian3d, gaussian_radius
from .metrics import abs_pjpe, pjpe
from .targets import PoseTargetSpec, assign_pose_targets, assign_pose_targets_np

__all__ = ["DecodeSpec", "decode_pose_preds", "decode_pose_sparse",
           "flat_argmax", "post_process_pose", "unflip_pose_preds", "abs_pjpe", "pjpe",
           "dense_pose_heatmap", "draw_gaussian3d", "gaussian_radius", "PoseTargetSpec",
           "assign_pose_targets", "assign_pose_targets_np"]
