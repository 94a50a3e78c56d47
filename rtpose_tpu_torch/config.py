"""Config system: Python-module (or yaml/json) files harvested into an
attribute-accessible dict (a copy of ``rtpose_tpu/config.py``, which the
port may not import).

Public contract parity with the reference (``det3d/torchie/utils/config.py``):

* ``Config.fromfile(path)`` imports a ``.py`` config module and collects its
  non-dunder module-level globals (yaml/json also supported);
* attribute access (``cfg.model.type``), item access, ``in``, ``.get``;
* ``cfg.text`` holds the original file contents for work-dir backup;
* missing keys raise AttributeError (we deliberately do NOT mimic addict's
  silent-empty-dict-on-missing-key behavior — it hides typos).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Any


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = _wrap(v)

    def __setitem__(self, k, v):
        super().__setitem__(k, _wrap(v))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"ConfigDict has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        import copy
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(v):
    if isinstance(v, ConfigDict):
        return v
    if isinstance(v, dict):
        return ConfigDict(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


class Config:
    """A loaded configuration file."""

    def __init__(self, cfg_dict: dict | None = None, filename: str | None = None,
                 text: str = ""):
        self._cfg_dict = ConfigDict(cfg_dict or {})
        self._filename = filename
        self._text = text

    @staticmethod
    def fromfile(filename: str) -> "Config":
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        ext = os.path.splitext(filename)[1]
        with open(filename) as f:
            text = f.read()
        if ext == ".py":
            module_name = "_rtpose_cfg_" + os.path.basename(filename)[:-3]
            spec = importlib.util.spec_from_file_location(module_name, filename)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[module_name] = mod
            try:
                spec.loader.exec_module(mod)
                cfg_dict = {k: v for k, v in mod.__dict__.items()
                            if not k.startswith("__")}
            finally:
                sys.modules.pop(module_name, None)
        elif ext in (".yml", ".yaml"):
            import yaml
            cfg_dict = yaml.safe_load(text)
        elif ext == ".json":
            cfg_dict = json.loads(text)
        else:
            raise IOError(f"unsupported config type: {ext}")
        return Config(cfg_dict, filename=filename, text=text)

    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            super().__setattr__(name, value)
        else:
            self._cfg_dict[name] = value

    def __getitem__(self, k):
        return self._cfg_dict[k]

    def __setitem__(self, k, v):
        self._cfg_dict[k] = v

    def __contains__(self, k):
        return k in self._cfg_dict

    def get(self, k, default=None):
        return self._cfg_dict.get(k, default)

    def keys(self):
        return self._cfg_dict.keys()

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v
        return unwrap(self._cfg_dict)
