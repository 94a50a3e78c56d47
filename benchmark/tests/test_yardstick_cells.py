"""BENCHMARK.json against its contract, and resolution of every cell by
name (configuration, traffic mix, limits, each per-layer metric's reader),
also of a cell added as files in a copy."""

import json
import os
import pathlib
import re
import shutil

import pytest

from benchmark.harness.cells import benchmark_json, resolve

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = benchmark_json(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, ks in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == ks, e["name"]
            assert NAME.match(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    fours = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4)


def test_configs_are_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_and_reports(name):
    cell = resolve(name, ROOT)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cell.reader(m["name"]))
    assert cell.limits and all(isinstance(v, float) for v in cell.limits.values())


def test_a_cell_added_as_files_runs_without_editing_any(tmp_path):
    """The training cell kept as files (its configuration, mix and readers
    are here) added the way a later change adds a cell: a limits file and
    BENCHMARK.json entries, no file edited; it then resolves and runs (at
    a tiny grid on the CPU)."""
    import torch
    from benchmark.harness import train_loop
    from benchmark.harness.dist import Ranks
    from benchmark.tests.tiny import shrink
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {str(p): p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    name = "hrradarpose_doppler.train_b8"
    (root / "benchmark/limits" / f"{name}.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.5}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": name, "config": "hrradarpose_doppler",
                               "traffic": "train_b8", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "train_samples_per_s", "unit": "samples/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": [name]})
    bench["per_layer"].append({"name": "mfu.train", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "train step",
                               "moves": "train_samples_per_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = resolve(name, str(root))
    assert cell.traffic["kind"] == "train_loop" and cell.limits == {"loss_gap": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["mfu.train"]
    assert callable(cell.reader("mfu.train"))
    res = train_loop.run(shrink(cell), 3, 0.3, False, torch.device("cpu"), Ranks())
    assert res["units"] >= 1 and set(res["numbers"]) >= {"loss_gap"}
    assert all(p.read_bytes() == b for p, b in ((pathlib.Path(k), v) for k, v in before.items()))
