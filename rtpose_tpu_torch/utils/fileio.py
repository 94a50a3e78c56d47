"""File IO handler registry (torchie/fileio/io.py:15-106 parity):
format-dispatched load/dump for json / yaml / pickle.

A copy of ``rtpose_tpu/utils/fileio.py``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any


class _JsonHandler:
    def load(self, f): return json.load(f)
    def dump(self, obj, f, **kw): json.dump(obj, f, **kw)
    mode = ""


class _YamlHandler:
    def load(self, f):
        import yaml
        return yaml.safe_load(f)
    def dump(self, obj, f, **kw):
        import yaml
        yaml.safe_dump(obj, f, **kw)
    mode = ""


class _PickleHandler:
    def load(self, f): return pickle.load(f)
    def dump(self, obj, f, **kw): pickle.dump(obj, f, **kw)
    mode = "b"


file_handlers = {
    "json": _JsonHandler(),
    "yaml": _YamlHandler(),
    "yml": _YamlHandler(),
    "pickle": _PickleHandler(),
    "pkl": _PickleHandler(),
}


def _fmt(path: str, file_format: str | None) -> str:
    fmt = file_format or os.path.splitext(path)[1][1:]
    if fmt not in file_handlers:
        raise TypeError(f"unsupported file format: {fmt}")
    return fmt


def load(path: str, file_format: str | None = None) -> Any:
    fmt = _fmt(path, file_format)
    h = file_handlers[fmt]
    with open(path, "r" + h.mode) as f:
        return h.load(f)


def dump(obj: Any, path: str, file_format: str | None = None, **kwargs) -> None:
    fmt = _fmt(path, file_format)
    h = file_handlers[fmt]
    with open(path, "w" + h.mode) as f:
        h.dump(obj, f, **kwargs)
