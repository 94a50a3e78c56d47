from .decode import (DecodeSpec, decode_pose_preds, decode_pose_sparse,
                     flat_argmax, post_process_pose)
from .metrics import abs_pjpe, pjpe

__all__ = ["DecodeSpec", "decode_pose_preds", "decode_pose_sparse",
           "flat_argmax", "post_process_pose", "abs_pjpe", "pjpe"]
