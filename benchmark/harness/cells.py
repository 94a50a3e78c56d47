"""Resolve a cell of ``BENCHMARK.json`` by name into everything it runs on.

A cell names a configuration and a traffic mix; each lives in a file of
its own that is found by name: ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json``, the correctness limits in
``benchmark/limits/<cell>.json`` and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``.  Adding a configuration, a mix, a cell
or a metric adds files and ``BENCHMARK.json`` entries; no file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
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
                      root, e2e, layer)


def from_files(name: str, config_file: str, traffic: str, chips: int = 1, root: str = ROOT,
               end_to_end=(), per_layer=()) -> Cell:
    """A cell from its files alone (``config_file`` relative to ``root``);
    its limits are empty where it has no limits file yet."""
    bench_dir = os.path.join(root, "benchmark")
    limits_file = os.path.join(bench_dir, "limits", f"{name}.json")
    limits = load_json(limits_file)["limits"] if os.path.exists(limits_file) else {}
    return Cell(name=name, chips=chips, cfg=load_json(os.path.join(root, config_file)),
                traffic=load_json(os.path.join(bench_dir, "traffic", f"{traffic}.json")),
                limits=limits, end_to_end=list(end_to_end), per_layer=list(per_layer),
                bench_dir=bench_dir)
