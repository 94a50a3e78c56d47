"""What the benchmark runs imports neither JAX nor the JAX package, and
its reference imports nothing of the program: by the sources' imports, and
by the modules a run (at a tiny grid on the CPU) leaves loaded."""

import ast
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "rtpose_tpu"}


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in dirpath.split(os.sep) or "__pycache__" in dirpath:
            continue
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax():
    for path in sources():
        for name in imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        for name in imports(path):
            assert name.split(".")[0] in {"torch", "math", "collections", "typing",
                                          "__future__"}, (path, name)


def test_a_run_leaves_no_jax_module_loaded():
    code = (
        "import sys, types, json, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import benchmark.run as run\n"
        "from benchmark.tests.tiny import tiny\n"
        "from benchmark.harness.dist import Ranks\n"
        "torch.cuda.get_device_name = lambda d=None: 'cpu'\n"
        "for name in ('hrradarpose_doppler.train_b8', 'hrradarpose_doppler.eval_b1'):\n"
        "    a = types.SimpleNamespace(seed=3, seconds=0.3, trace=0, t_start=None)\n"
        "    assert run.finish(run.drive(tiny(name), a, torch.device('cpu'), Ranks())) == 0\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    loaded = set(json.loads(lines[-1]))
    assert "rtpose_tpu_torch" in loaded and not loaded & FORBIDDEN
    result = json.loads(lines[-2])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["metrics"]["setup_s"]["unit"] == "s"
