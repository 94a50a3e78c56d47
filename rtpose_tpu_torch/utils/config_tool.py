"""Config helpers (det3d/utils/config_tool.py parity).

``get_downsample_factor`` computes the model's output-grid downsampling from
the neck config (used by reference configs to derive out_size_factor).

A copy of ``rtpose_tpu/utils/config_tool.py``.
"""

from __future__ import annotations

import numpy as np


def get_downsample_factor(model_config: dict) -> int:
    try:
        neck_cfg = model_config["neck"]
    except KeyError:
        model_config = model_config["first_stage_cfg"]
        neck_cfg = model_config["neck"]
    if neck_cfg is None:
        # no neck: the backbone's ds_factor (1 for the HRNet radar path)
        return int(model_config.get("backbone", {}).get("ds_factor", 1))
    downsample_factor = np.prod(neck_cfg.get("ds_layer_strides", [1]))
    if len(neck_cfg.get("us_layer_strides", [])) > 0:
        downsample_factor /= neck_cfg["us_layer_strides"][-1]
    backbone_cfg = model_config.get("backbone", {})
    if backbone_cfg:
        downsample_factor *= backbone_cfg.get("ds_factor", 1)
    downsample_factor = int(downsample_factor)
    assert downsample_factor > 0
    return downsample_factor
