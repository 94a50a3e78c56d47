"""The port stands alone: importing ``rtpose_tpu_torch`` (and its CLIs and
``chip_smoke.py``) loads no JAX, flax, optax, orbax or ``rtpose_tpu``
module, and no source file of the package imports them; its native cube
loader is its own copy of the C++ source."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rtpose_tpu")

_IMPORT = re.compile(r"^\s*(?:from\s+(\.*[\w.]*)\s+import|import\s+([\w.]+))", re.M)


def _top_level(name: str) -> str:
    return name.lstrip(".").split(".")[0]


def test_fresh_interpreter_loads_no_jax():
    code = (
        "import sys, rtpose_tpu_torch, rtpose_tpu_torch.tools.test, chip_smoke\n"
        "import rtpose_tpu_torch.tools.train, rtpose_tpu_torch.solver\n"
        "import rtpose_tpu_torch.tools.trajectory_gate, rtpose_tpu_torch.solver.schedules\n"
        "import rtpose_tpu_torch.data.loader, rtpose_tpu_torch.engine.hooks\n"
        "import rtpose_tpu_torch.engine.steps, rtpose_tpu_torch.core.targets\n"
        "from rtpose_tpu_torch.data import DeviceCachedLoader, StreamingDeviceLoader\n"
        "from rtpose_tpu_torch.engine import HTTPLoggerHook, ProfilerHook, make_epoch_step\n"
        "import rtpose_tpu_torch.ops.quant, rtpose_tpu_torch.export\n"
        "import rtpose_tpu_torch.tools.export, rtpose_tpu_torch.tools.int8_diag\n"
        "import rtpose_tpu_torch.tools.gen_skel_data, rtpose_tpu_torch.data.wrappers\n"
        "import rtpose_tpu_torch.ops.deform_conv, rtpose_tpu_torch.models.dcn_head\n"
        "import rtpose_tpu_torch.ops.voxelize, rtpose_tpu_torch.models.voxelnet\n"
        "import rtpose_tpu_torch.models.readers, rtpose_tpu_torch.data.pipelines\n"
        "import rtpose_tpu_torch.data.point_cloud, rtpose_tpu_torch.data.augment\n"
        "import rtpose_tpu_torch.data.gt_sampler\n"
        "import rtpose_tpu_torch.parallel, rtpose_tpu_torch.parallel.mesh\n"
        "import rtpose_tpu_torch.utils, rtpose_tpu_torch.utils.oss, rtpose_tpu_torch.native\n"
        "import rtpose_tpu_torch.utils.fileio, rtpose_tpu_torch.utils.timer\n"
        "import rtpose_tpu_torch.utils.progressbar, rtpose_tpu_torch.utils.config_tool\n"
        "import rtpose_tpu_torch.utils.flops, rtpose_tpu_torch.utils.freeze\n"
        "import rtpose_tpu_torch.data.builder, rtpose_tpu_torch.data.factory\n"
        "import rtpose_tpu_torch.core.boxes, rtpose_tpu_torch.core.kitti_eval\n"
        "import rtpose_tpu_torch.ops.nms, rtpose_tpu_torch.ops.grid_sample\n"
        "import rtpose_tpu_torch.models.necks, rtpose_tpu_torch.models.feat_transforms\n"
        "import rtpose_tpu_torch.models.second_stage, rtpose_tpu_torch.models.roi_head\n"
        "import rtpose_tpu_torch.models.distillation, rtpose_tpu_torch.tools.perf_breakdown\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(','.join(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"


def test_no_source_file_imports_jax():
    roots = [os.path.join(REPO, "rtpose_tpu_torch")]
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root in roots:
        for dp, _, fs in os.walk(root):
            files += [os.path.join(dp, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        src = open(path).read()
        for m in _IMPORT.finditer(src):
            name = m.group(1) or m.group(2)
            if name.startswith("."):
                continue          # relative: inside the package
            assert _top_level(name) not in FORBIDDEN, f"{path}: imports {name}"


def test_native_loader_is_the_ports_own_source():
    from rtpose_tpu_torch import native
    assert os.path.dirname(native.SRC) == os.path.join(REPO, "rtpose_tpu_torch", "native")
    assert os.path.isfile(native.SRC)
    assert native.BUILD_DIR == os.path.join(REPO, "rtpose_tpu_torch", "build")
