"""The multi-card path (one rank a card under torch.distributed.run, the
harness's own gloo group deciding the window's edges, rank 0 checking the
global batch against the reference) with two gloo ranks on the CPU; a
rank that loaded a JAX module fails the run."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def ranks(tmp_path, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "2", os.path.join(HERE, "ranks_worker.py"),
                           *extra], capture_output=True, text=True, timeout=600, env=env,
                          cwd=tmp_path)


def test_two_ranks_run_and_agree_with_the_reference(tmp_path):
    out = ranks(tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["count"] == 2
    assert line["attempted"] >= 1


def test_a_rank_that_loaded_jax_fails_the_run(tmp_path):
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    out = ranks(tmp_path, str(stub))
    assert out.returncode != 0
    assert not any(ln.startswith("{") for ln in out.stdout.splitlines())
    assert "['jax']" in out.stderr
