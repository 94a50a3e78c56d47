"""BENCHMARK.json against its contract, and resolution of every cell by
name (configuration, the reference model it names, traffic mix and its
loop, limits, each per-layer metric's reader), also of a cell, and of a
configuration with a reference model of its own, added as files in a
copy."""

import json
import math
import os
import pathlib
import re
import shutil

import pytest

from benchmark.harness.cells import benchmark_json, from_files, resolve

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


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    return root, before


# a reference of its own: model.py's net, with the regression output's bias
# a draw of its own (a normal of stated std, after the He-normal kernels)
OWN_REFERENCE = '''"""model.py's net; the regression output's bias drawn from N(0, 0.5^2)."""

from benchmark.reference import model
from benchmark.reference.model import Conv, build, load  # noqa: F401

INIT = dict(model.INIT, reg_bias=("normal", 0.5))
REG_BIAS = "pose_head.tasks.0.reg.2.bias"


def param_specs(net):
    return [(n, s, "reg_bias" if n == REG_BIAS else k) for n, s, k in model.param_specs(net)]
'''


def test_a_configuration_with_its_own_reference_runs_as_files(tmp_path):
    """A new configuration naming a new reference module (which reuses
    model.py's parts and states a draw of its own), its limits file and
    BENCHMARK.json entries, no file edited: the cell resolves to that
    module, its weights follow the module's draws, and a run of it (at a
    tiny grid on the CPU) checks out within its limits."""
    import torch
    from benchmark.harness import check, data, eval_stream
    from benchmark.tests.test_yardstick_isolation import imports, reference_import_ok
    from benchmark.tests.tiny import shrink
    root, before = _copy(tmp_path)
    ref_file = root / "benchmark/reference/own_reg_bias.py"
    ref_file.write_text(OWN_REFERENCE)
    assert all(reference_import_ok(n) for n in imports(str(ref_file)))
    cfg = json.loads((root / "benchmark/configs/hrradarpose_doppler.json").read_text())
    cfg["reference"] = "own_reg_bias"
    (root / "benchmark/configs/hrradarpose_own.json").write_text(json.dumps(cfg))
    name = "hrradarpose_own.eval_b1"
    (root / "benchmark/limits" / f"{name}.json").write_text(
        json.dumps({"limits": {"kpt_gap": 5.5}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "hrradarpose_own", "source": "a test",
                             "file": "benchmark/configs/hrradarpose_own.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": name, "config": "hrradarpose_own",
                               "traffic": "eval_b1", "chips": 1, "why": "a test"})
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "hrradarpose_doppler.eval_b1" in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = resolve(name, str(root))
    assert cell.config == "hrradarpose_own" and cell.limits == {"kpt_gap": 5.5}
    assert os.path.samefile(cell.reference.__file__, ref_file)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "frame_ms_p50"}
    cell = shrink(cell)
    seed = 2 ** 33 + 5
    own = data.make_weights(cell.cfg, seed, "cpu", cell.bench_dir)
    plain = data.make_weights(dict(cell.cfg, reference="model"), seed, "cpu")
    ref = cell.reference
    he = [(n, s) for n, s, k in ref.param_specs(ref.build(cell.cfg["model"], 32, "meta"))
          if ref.INIT[k][0] == "he_normal"]
    g = data.generator(seed, 0, "cpu")
    torch.randn(sum(torch.Size(s).numel() for _, s in he), generator=g)
    assert torch.equal(own[ref.REG_BIAS], torch.randn(45, generator=g) * 0.5)
    assert not torch.equal(plain[ref.REG_BIAS], own[ref.REG_BIAS])
    assert all(torch.equal(own[n], plain[n]) for n in plain if n != ref.REG_BIAS)

    res = eval_stream.run(cell, seed, 0.3, False, torch.device("cpu"))
    assert res["units"] >= 1 and res["failed"] == 0
    assert all(math.isfinite(v) for v in res["numbers"].values())
    assert check.verdict(res["numbers"], cell.limits)
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("reference", [None, "no_such_reference"])
def test_a_configuration_without_a_reference_does_not_resolve(tmp_path, reference):
    root, _ = _copy(tmp_path)
    cfg = json.loads((root / "benchmark/configs/hrradarpose_doppler.json").read_text())
    del cfg["reference"]
    if reference is not None:
        cfg["reference"] = reference
    (root / "benchmark/configs/hrradarpose_bare.json").write_text(json.dumps(cfg))
    with pytest.raises(LookupError, match="'hrradarpose_bare'"):
        from_files("hrradarpose_bare.eval_b1", "benchmark/configs/hrradarpose_bare.json",
                   "eval_b1", root=str(root))


def test_a_traffic_kind_without_a_loop_does_not_resolve(tmp_path):
    root, _ = _copy(tmp_path)
    mix = json.loads((root / "benchmark/traffic/eval_b1.json").read_text())
    mix["kind"] = "open_loop"
    (root / "benchmark/traffic/open_b1.json").write_text(json.dumps(mix))
    with pytest.raises(LookupError, match="'open_loop'"):
        from_files("hrradarpose_doppler.open_b1", "benchmark/configs/hrradarpose_doppler.json",
                   "open_b1", root=str(root))
