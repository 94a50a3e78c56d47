"""Resolve a cell of ``BENCHMARK.json`` by name into everything it runs on.

A cell names a configuration and a traffic mix; each lives in a file of
its own that is found by name: ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` (whose ``kind`` names the loop,
``benchmark/harness/<kind>.py``, with its ``run(cell, seed, seconds,
trace, device, ranks, extra=())``), the correctness limits in
``benchmark/limits/<cell>.json``, each per-layer metric's reader in
``benchmark/metrics/<metric>.py``, and the configuration's plain reference
model in ``benchmark/reference/<module>.py``, named by the configuration's
top-level ``"reference": "<module>"``.  Adding a model, a configuration, a
mix, a cell or a metric adds files and ``BENCHMARK.json`` entries; no file
changes.

A reference module (``reference/model.py`` is one) gives, in plain
PyTorch, importing nothing of the program (other references' parts as
``benchmark.reference.<module>``):

* ``build(model_cfg, in_channels, device)``: the net, weights unset
  (``device="meta"`` for counting);
* ``load(net, state)``: a state dict in the port's names loaded as
  float32 copies, every name matched; returns the net;
* ``param_specs(net)``: ``(name, shape, kind)`` of every parameter, in
  module order;
* ``INIT``: each kind's draw (``harness/data.py::make_weights``):
  ``("he_normal",)`` (std ``sqrt(2 / fan_in)``, every such kind from one
  ``randn`` in spec order), ``("normal", std)`` (after it, from the same
  generator) or ``("fill", value)``, ``value`` a number or a function of
  the configuration's ``model`` dict;
* ``Conv``: the conv module class, whose forward pre-hooks
  ``harness/counts.py::k3_shapes`` reads and whose class-wide ``fp8``
  switch rounds every conv to float8 (the training check's control);
* nets with ``features(x)``, ``dense(x)`` -> (hm logits, reg),
  ``predict(x, sparse)`` and ``train_outputs(x, ind, sparse)``, inputs
  (B, Z, Y, X, C).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"[A-Za-z0-9_]+")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def reference_path(cfg: dict, bench_dir: str = BENCH_DIR, config: str = "") -> str:
    """The file of the reference module the configuration names; a
    configuration that names none, or one with no file, is refused."""
    name = cfg.get("reference")
    what = f"configuration {config!r}" if config else "the configuration"
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise LookupError(f'{what} names no reference module (a top-level "reference": '
                          f'"<module>" of benchmark/reference/<module>.py); it has {name!r}')
    path = os.path.join(bench_dir, "reference", f"{name}.py")
    if not os.path.isfile(path):
        raise LookupError(f"{what} names the reference {name!r}, and {path} does not exist")
    return os.path.abspath(path)


@functools.lru_cache(maxsize=None)
def _reference(path: str) -> ModuleType:
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"benchmark_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cfg: dict, bench_dir: str = BENCH_DIR, config: str = "") -> ModuleType:
    """The configuration's reference module, loaded from its file once."""
    return _reference(reference_path(cfg, bench_dir, config))


def loop_path(kind, bench_dir: str = BENCH_DIR) -> str:
    """The file of a traffic kind's loop, ``harness/<kind>.py``."""
    path = os.path.join(bench_dir, "harness", f"{kind}.py")
    if not isinstance(kind, str) or not NAME.fullmatch(kind) or not os.path.isfile(path):
        raise LookupError(f"traffic kind {kind!r} has no loop (benchmark/harness/<kind>.py "
                          f"with a run(cell, seed, seconds, trace, device, ranks))")
    return path


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: str                     # the configuration's name
    cfg: dict                       # the configuration file
    traffic: dict                   # the traffic mix file
    limits: Dict[str, float]        # number compared -> its limit
    end_to_end: List[dict]          # BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    bench_dir: str = BENCH_DIR

    def reader(self, metric: str) -> Callable:
        """``read(trace)`` of a per-layer metric, from its own file."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    @property
    def reference(self) -> ModuleType:
        """The configuration's reference module (see the module's doc)."""
        return reference(self.cfg, self.bench_dir, self.config)

    @property
    def loop(self) -> ModuleType:
        """The traffic kind's loop, ``benchmark.harness.<kind>``, whose
        ``run`` drives the cell."""
        loop_path(self.traffic["kind"], self.bench_dir)
        return importlib.import_module(f"benchmark.harness.{self.traffic['kind']}")


def resolve(name: str, root: str = ROOT) -> Cell:
    bench = benchmark_json(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in moved]
    return from_files(name, configs[w["config"]]["file"], w["traffic"], int(w["chips"]),
                      root, e2e, layer, config=w["config"])


def from_files(name: str, config_file: str, traffic: str, chips: int = 1, root: str = ROOT,
               end_to_end=(), per_layer=(), config: str = "") -> Cell:
    """A cell from its files alone (``config_file`` relative to ``root``;
    ``config`` its name, by default the file's); its limits are empty where
    it has no limits file yet.  The configuration's reference has to exist."""
    bench_dir = os.path.join(root, "benchmark")
    limits_file = os.path.join(bench_dir, "limits", f"{name}.json")
    limits = load_json(limits_file)["limits"] if os.path.exists(limits_file) else {}
    config = config or os.path.splitext(os.path.basename(config_file))[0]
    cfg = load_json(os.path.join(root, config_file))
    reference_path(cfg, bench_dir, config)
    mix = load_json(os.path.join(bench_dir, "traffic", f"{traffic}.json"))
    loop_path(mix.get("kind"), bench_dir)
    return Cell(name=name, chips=chips, config=config, cfg=cfg, traffic=mix, limits=limits,
                end_to_end=list(end_to_end), per_layer=list(per_layer), bench_dir=bench_dir)
