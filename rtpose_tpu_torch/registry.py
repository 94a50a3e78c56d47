"""Registry: name -> class maps + ``build_from_cfg`` instantiation.

Counterpart of ``rtpose_tpu/registry.py`` (reference
``det3d/utils/registry.py:6-78``): configs select implementations with a
``type:`` key; the remaining keys become constructor kwargs.
"""

from __future__ import annotations

import inspect
from typing import Any


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: dict[str, type] = {}

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str):
        return self._module_dict.get(key)

    def register_module(self, cls=None, *, name: str | None = None, force: bool = False):
        """Usable both as ``@REG.register_module`` and
        ``@REG.register_module(name=..)``."""
        if cls is None:
            return lambda c: self.register_module(c, name=name, force=force)
        key = name or cls.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"{key} is already registered in {self._name}")
        self._module_dict[key] = cls
        return cls

    def __contains__(self, key):
        return key in self._module_dict

    def __repr__(self):
        return f"Registry(name={self._name}, items={list(self._module_dict)})"


def build_from_cfg(cfg: dict, registry: Registry, default_args: dict | None = None) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg-without-type, **default_args)``."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)


# Model-side registries (det3d/models/registry.py parity)
READERS = Registry("reader")
BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
LOSSES = Registry("loss")
DETECTORS = Registry("detector")
SECOND_STAGE = Registry("second_stage")
ROI_HEAD = Registry("roi_head")
FEAT_TRANSFORMS = Registry("feat_transform")

# Data-side registries (det3d/datasets/registry.py parity)
DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")
