"""The per-segment breakdown tool (``rtpose_tpu_torch.tools.perf_breakdown``)
and the port's FLOP count (``rtpose_tpu_torch.utils.flops``), against
rtpose_tpu on the CPU.

* Segment parity: the tool's segment callables on the flagship at the tiny
  grid (8, 16, 32), float32, weights carried across from flax
  (``state_dict_from_jax``), against the JAX model's same methods on the
  same numpy-seeded input.  Tolerances as the existing slice tests state
  them: the frameworks sum the convs in different orders, so float32
  outputs agree to 1e-3 of their largest value (``tests/test_torch_slice.py``,
  the reg values), the peak indices exactly; the loss to rtol 1e-4, each
  gradient leaf to 1e-3 of its largest value, and the parameters after one
  Adam step within 2.05 lr, fewer than 1e-3 of the elements more than 1e-5
  apart (``tests/test_torch_train_step.py``: Adam's first step moves every
  element by about lr whatever the gradient's size).
* The FLOP count: exactly the analytic 2 x MACs over every conv the call
  runs, whichever route each conv takes, int8 included.
* The count's definitional gap to JAX's, pinned.
* Smoke: every group of the tool on the CPU at the tiny grid.
"""

import contextlib
import dataclasses
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from torch.utils.flop_counter import FlopCounterMode

from rtpose_tpu.engine.steps import targets_from_batch as jax_targets_from_batch
from rtpose_tpu.models.losses import fast_focal_loss_logits as jax_focal
from rtpose_tpu.ops.fold_conv import unfold_x
from rtpose_tpu.solver import adam_one_cycle as jax_adam
from rtpose_tpu.solver import make_one_cycle_fns as jax_one_cycle
from rtpose_tpu.utils.flops import estimate_flops as jax_estimate_flops

from rtpose_tpu_torch.engine import bind_sites, state_dict_from_jax
from rtpose_tpu_torch.models import TorchConv3d
from rtpose_tpu_torch.ops import conv_k3, conv_k3_int8, quant
from rtpose_tpu_torch.tools import perf_breakdown as pb
from rtpose_tpu_torch.utils.flops import estimate_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as graft  # noqa: E402

B = 1
OUT_FRAC = 1e-3                  # outputs and gradients: of the largest value
LOSS_RTOL = 1e-4
ADAM_LR_BOUND, ADAM_ELEM_TOL, ADAM_FRAC = 2.05, 1e-5, 1e-3
LR_MAX = 2e-3                    # make_one_cycle_fns(1000, 2e-3): lr at step 0 is a tenth
# port count / JAX count at (1, 8, 16, 32, 32), measured with both packages on
# the CPU (JAX in float32; in bf16 XLA also counts the casts)
RATIO = {"extract_feat": 0.483, "predict_sparse": 0.507}
RATIO_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs six workers at once: two torch threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env():
    """The JAX flagship in float32 at the tool's tiny grid with flax
    weights, the port's with the same weights, and one numpy-seeded input."""
    jasm = graft._flagship(dtype_override="float32")
    grid = pb.TINY_GRID
    jasm = dataclasses.replace(
        jasm, input_shape_zyxc=(*grid, jasm.input_shape_zyxc[-1]),
        target_spec=dataclasses.replace(jasm.target_spec, grid_zyx=grid),
        decode_spec=dataclasses.replace(jasm.decode_spec, grid_zyx=grid))
    x = np.random.default_rng(0).random((B, *jasm.input_shape_zyxc), np.float32)
    params = jax.tree.map(np.array, jasm.model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    asm = pb.flagship(tiny=True, dtype="float32")
    asm.model.load_state_dict(state_dict_from_jax(params))
    return dict(jasm=jasm, params=params, asm=asm, x=x)


def _close(got, want, frac=OUT_FRAC, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=frac * np.abs(want).max() + 1e-12, err_msg=err_msg)


def _jax_apply(env, method, *args):
    return env["jasm"].model.apply(env["params"], *args, method=method)


def test_infer_segments_match_jax(env):
    model, x = env["asm"].model, torch.from_numpy(env["x"])
    with torch.inference_mode():
        calls = pb.infer_calls(model, x)
        out = {k: calls[k]() for k in pb.INFER_KEYS}
    jx = jnp.asarray(env["x"])
    feat = _jax_apply(env, "extract_feat", jx)
    # the JAX model runs X folded by 4 into the channels (X % 32 == 0 here)
    _close(out["backbone"], unfold_x(feat), err_msg="extract_feat")
    hm = _jax_apply(env, lambda m, f: m.head_m(f, branch="hm"), feat)[0]["hm"]
    _close(out["hm"], hm, err_msg="hm tower")
    Z, Y, X, C = hm.shape[1:]
    flat = jnp.argmax(hm.reshape(B, -1, C)[..., 0], axis=1)
    np.testing.assert_array_equal(out["argmax"].numpy(), np.asarray(flat))
    zc, yc, xc = flat // (Y * X), (flat % (Y * X)) // X, flat % X
    reg = _jax_apply(env, lambda m, f, a, b, c: m._reg_patches(f, a, b, c, (Z, Y, X)),
                     feat, zc, yc, xc)
    _close(out["reg"], reg, err_msg="reg patches")
    jhm, jreg, jind = _jax_apply(env, "predict_sparse", jx)
    phm, preg, pind = out["full"]
    _close(phm, jhm, err_msg="predict_sparse hm")
    _close(preg, jreg, err_msg="predict_sparse reg")
    np.testing.assert_array_equal(pind.numpy(), np.asarray(jind))


def _jax_loss(jasm, batch):
    """The JAX tool's sparse loss (``tools/perf_breakdown.py:421-432``)."""
    model, head = jasm.model, jasm.head
    example = jax_targets_from_batch(batch, jasm.target_spec)

    def loss_fn(params, x):
        ind = example["ind"][0]
        hm_logits, reg_at_ind = model.apply(params, x, ind, method="forward_sparse_train")
        hm_loss = jax_focal(hm_logits, example["hm"][0], ind, example["mask"][0],
                            example["cat"][0])
        maskf = example["mask"][0].astype(jnp.float32)[:, :, None]
        l1 = jnp.abs(reg_at_ind.astype(jnp.float32) * maskf - example["anno_pose"][0] * maskf)
        rl = jnp.sum(l1 / (jnp.sum(maskf) + 1e-4), axis=(0, 1))
        return hm_loss + head.weight * jnp.sum(rl * jnp.asarray(head.code_weights, jnp.float32))
    return loss_fn


def test_train_segments_match_jax():
    """The sparse loss's value and gradients, and one optimizer update, at
    ``graft._flagship(tiny=True)``'s (4, 8, 16) grid (as
    ``tests/test_torch_parallel.py``), two frames, one person each inside
    the grid."""
    jasm = graft._flagship(tiny=True, dtype_override="float32")
    spec = jasm.target_spec
    rng = np.random.default_rng(4)
    z, y, x = spec.grid_zyx
    extent = np.array([x, y, z]) * np.array(spec.voxel_size_xyz)
    poses = np.array(spec.pc_range_min_xyz) + rng.uniform(0.15, 0.85, (2, 1, 15, 3)) * extent
    batch = {"rdr_tensor": rng.normal(size=(2, *jasm.input_shape_zyxc)).astype(np.float32),
             "poses": poses.astype(np.float32), "num_poses": np.ones((2,), np.int32)}
    params = jax.tree.map(np.array, jasm.model.init(jax.random.PRNGKey(0),
                                                     jnp.asarray(batch["rdr_tensor"])))
    asm = pb.flagship(dtype="float32")
    asm = dataclasses.replace(asm, input_shape_zyxc=jasm.input_shape_zyxc,
                              target_spec=dataclasses.replace(asm.target_spec,
                                                              grid_zyx=spec.grid_zyx))
    model = asm.model
    model.load_state_dict(state_dict_from_jax(params))
    calls = pb.train_calls(asm, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss = float(calls["loss_fwd"]())
    assert float(calls["fwd_bwd"]().detach()) == pytest.approx(loss, rel=1e-6)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    calls["optimizer"]()

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss(jasm, jbatch)))(
        jparams, jbatch["rdr_tensor"])
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    want = state_dict_from_jax(jax.device_get(jgrads))
    assert sorted(want) == sorted(grads)
    for k, g in grads.items():
        _close(g.numpy(), want[k].numpy(), err_msg=k)

    lr_fn, mom_fn = jax_one_cycle(1000, LR_MAX)
    jopt = jax_adam(lr_fn, mom_fn)
    upd, _ = jopt.update(jgrads, jopt.init(jparams), jparams)
    want = state_dict_from_jax(jax.device_get(optax.apply_updates(jparams, upd)))
    lr = LR_MAX / 10
    total = mismatched = 0
    for k, p in model.state_dict().items():
        d = np.abs(p.numpy() - want[k].numpy())
        assert d.max() <= ADAM_LR_BOUND * lr, (k, d.max())
        total += d.size
        mismatched += int((d > ADAM_ELEM_TOL).sum())
    assert mismatched / total < ADAM_FRAC
    assert int(calls["opt"].step_count) == 1


# -- the FLOP count -----------------------------------------------------------

def _conv_flops(model, fn):
    """2 x MACs over the full window of every ``TorchConv3d`` call of
    ``fn()``, from each call's input and output shapes."""
    seen = []

    def hook(mod, inputs, out):
        k = mod.weight.shape[-1]
        seen.append(2 * out.numel() * inputs[0].shape[-1] * k ** 3)
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, TorchConv3d)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return sum(seen)


@pytest.fixture(scope="module")
def bf16_model():
    """The flagship as configured (bf16 compute) at the tiny grid, seeded,
    with its int8 sites bound and scales from one calibration batch."""
    asm = pb.flagship(tiny=True)
    model = pb.init_weights(asm.model, torch.Generator().manual_seed(0))
    bind_sites(model)
    x = torch.from_numpy(np.random.default_rng(1).random((B, *asm.input_shape_zyxc),
                                                         np.float32))
    scales = quant.calibration_scales(model.predict_sparse, [x])
    return model, x, scales


@pytest.mark.parametrize("forward", ["predict_sparse", "dense"])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_predict_sparse_counts_every_conv_exactly(bf16_model, forward, precision):
    """``estimate_flops`` of ``predict_sparse`` and of the dense forward is
    the analytic count of their convs, the K3 ones counted through the
    ``torch.ops.rtpose`` custom ops the kernels' launches go through under
    a counter; int8 counts the same conv work as bf16."""
    model, x, scales = bf16_model
    fn = model.predict_sparse if forward == "predict_sparse" else model
    ctx = quant.int8_mode(scales) if precision == "int8" else contextlib.nullcontext()
    with torch.inference_mode(), ctx:
        want = _conv_flops(model, lambda: fn(x))
        got = estimate_flops(fn, x)
    with torch.inference_mode():
        bf16 = _conv_flops(model, lambda: fn(x))
    assert got == want == bf16


K3_SHAPE = (1, 4, 5, 6, 32)


def _k3_want():
    return 2 * np.prod(K3_SHAPE[:4]) * 32 * 32 * 27


def test_custom_ops_and_int_mm_count_two_per_mac():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=K3_SHAPE).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(32, 32, 3, 3, 3)).astype(np.float32))
    wr, b = conv_k3.prepare(w, torch.zeros(32))
    xq = torch.from_numpy(rng.integers(-127, 128, K3_SHAPE).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (32, 32, 3, 3, 3)).astype(np.int8))
    want = _k3_want()
    assert estimate_flops(torch.ops.rtpose.conv3d_k3, x, wr, b) == want
    assert estimate_flops(torch.ops.rtpose.conv3d_k3_grad_input, x,
                          conv_k3.prepare_flipped(w)) == want
    assert estimate_flops(torch.ops.rtpose.conv3d_k3_int8, xq, conv_k3_int8.prepare(wq),
                          torch.ones(32), None, torch.bfloat16) == want
    # the preprocess has no multiply-add
    raw = torch.ones((1, 2, 3, 4, 5), dtype=torch.float16)
    with FlopCounterMode(display=False) as counter:
        torch.ops.rtpose.preprocess(raw, [0, 2, 0, 3, 0, 4], 0.0, 1.0)
    assert counter.get_total_flops() == 0
    a = torch.from_numpy(rng.integers(-127, 128, (40, 64)).astype(np.int8))
    m = torch.from_numpy(rng.integers(-127, 128, (64, 24)).astype(np.int8))
    assert estimate_flops(torch._int_mm, a, m) == 2 * 40 * 64 * 24


def test_kernel_launches_go_through_the_counted_ops():
    """Under a ``FlopCounterMode`` the kernels' launch wrappers call their
    custom op, which the counter sees (on the card its CUDA implementation
    runs the kernel); here the op's CPU implementation, the plain version,
    answers.  Without a mode a CPU tensor takes the plain version directly."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=K3_SHAPE).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(32, 32, 3, 3, 3)).astype(np.float32))
    wr, _ = conv_k3.prepare(w)
    xq = torch.from_numpy(rng.integers(-127, 128, K3_SHAPE).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (32, 32, 3, 3, 3)).astype(np.int8))
    wk, scale = conv_k3_int8.prepare(wq), torch.full((32,), 1e-3)
    cases = [(lambda: conv_k3.launch(x, wr), conv_k3.conv3d_k3_reference(x, w)),
             (lambda: conv_k3.launch_grad_input(x, conv_k3.prepare_flipped(w)),
              conv_k3.grad_input(x, w)),
             (lambda: conv_k3_int8.launch(xq, wk, scale),
              conv_k3_int8.conv3d_k3_int8_reference(xq, wq, scale))]
    for launch, want in cases:
        with FlopCounterMode(display=False) as counter:
            got = launch()
        assert counter.get_total_flops() == _k3_want()
        assert torch.equal(got, want)
        assert torch.equal(launch(), want)


def test_count_against_jax_is_the_definitional_gap(env):
    """The port counts 2 x MACs over each conv's full window; XLA counts a
    conv's in-bounds taps only (fewer at the borders) but also the structural
    zeros of the X-folded layout the JAX model runs by default (4 columns
    folded into the channels, so most of its convs issue several times the
    canonical work).  The ratio is that of the two definitions at this input,
    not a fault of either count."""
    asm, x = env["asm"], torch.from_numpy(env["x"])
    jx, params, jmodel = jnp.asarray(env["x"]), env["params"], env["jasm"].model
    for method, want in RATIO.items():
        with torch.inference_mode():
            port = estimate_flops(getattr(asm.model, method), x)
        ref = jax_estimate_flops(lambda p, xx, m=method: jmodel.apply(p, xx, method=m),
                                 params, jx)
        assert abs(port / ref - want) <= RATIO_TOL, (method, port, ref)


# -- the tool's groups --------------------------------------------------------

def test_every_group_runs_on_the_cpu_and_returns_the_jax_tools_segments(capsys):
    """``main`` with every group flag at the tiny grid: the segments the JAX
    tool prints (``tools/perf_breakdown.py``), host times, operation counts
    and launches; no device time on the CPU."""
    out = pb.main(["--tiny", "--device", "cpu", "-B", "1", "--iters", "1",
                   "--train", "--infer", "--int8", "--backbone", "--head"])
    printed = capsys.readouterr().out
    assert "# device cpu" in printed
    want = {"infer": {"backbone", "hm", "argmax", "reg", "full", "sum"},
            "int8": {"backbone", "hm", "argmax", "reg", "full", "sum", "sites", "speedup"},
            "int8+resize": {"backbone", "hm", "argmax", "reg", "full", "sum", "sites",
                            "speedup"},
            "train": {"targets", "loss_fwd", "fwd_bwd", "backward", "optimizer", "full",
                      "sum", "steps_per_s"},
            "backbone": {"layer1", "stage2", "stage3", "stage4", "transition2",
                         "transition3", "final_fuse", "sum"},
            "head": {"conv0", "out_f32", "out_bf16", "out8_bf16"}}
    assert {k: set(v) for k, v in out.items()} == want
    assert out["int8"]["sites"] == 51 and out["int8+resize"]["sites"] > 51
    for group, segs in out.items():
        for name, rec in segs.items():
            if not isinstance(rec, dict) or name == "speedup":
                continue
            assert rec["ms"] is None and rec["util"] is None, (group, name)
            assert name == "backward" or rec["host_ms"] > 0, (group, name)
    # operations where the JAX tool counts them, the same for int8 as bf16
    for k in ("backbone", "hm", "reg", "full"):
        assert out["infer"][k]["gflop"] > 0
        assert out["int8"][k]["gflop"] == out["infer"][k]["gflop"]
    # the sparse loss runs the same convs as predict_sparse (the reg patch at
    # the target instead of the peak)
    assert out["train"]["loss_fwd"]["gflop"] == out["infer"]["full"]["gflop"]
    assert out["train"]["fwd_bwd"]["gflop"] > 2 * out["train"]["loss_fwd"]["gflop"]
    # the wrappers' counts: the CPU launches no kernel
    assert all(v == 0 for v in out["infer"]["full"]["launches"].values())


def test_the_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.main(["--tiny", "--infer"])
