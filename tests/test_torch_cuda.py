"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  Imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: the int8 conv kernel, none (bit-equal to its plain version);
preprocess, 1e-6 relative (the same float32 ops in the same
order); conv and its grad-input, one bf16 ulp (2^-7 relative) plus 2e-3 of
the output range (float32 sums in two orders, each rounded once to bf16);
grad-weight, the library's bf16 weight-gradient against the float32 one on
the same bf16 operands, one bf16 ulp plus 2e-3 of the largest value; box
IoUs card against CPU, 1e-5 absolute (float32), NMS keep lists and RoI
labels equal.
"""

import os
import time

import pytest
import torch

from rtpose_tpu_torch import ops
from rtpose_tpu_torch.ops import build, conv_k3, preprocess

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,roi", [
    ((2, 32, 16, 64, 160), (0, 15, 0, 63, 0, 159)),
    ((1, 3, 9, 11, 45), (1, 7, 2, 8, 3, 40)),          # odd ROI, D < 32, ragged X
    ((2, 40, 4, 5, 70), (0, 3, 1, 3, 5, 69)),          # D > 32: two channel tiles
])
def test_preprocess_kernel_matches_plain(dev, dtype, shape, roi):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand(shape, generator=g, device=dev) * 12 - 1).to(dtype)
    ops.reset_launch_counts()
    got = preprocess.fused_preprocess_batch(x, roi, 2.0, 8.0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["preprocess"] == 1
    want = preprocess.preprocess_reference(x, roi, 2.0, 8.0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    single = preprocess.fused_preprocess(x[0], roi, 2.0, 8.0)
    torch.testing.assert_close(single, want[0], rtol=1e-6, atol=0)
    counts = ops.launch_counts()    # each launch counts with the wrapper it came through
    assert counts["preprocess"] == 1 and counts["preprocess_single"] == 1


@pytest.mark.parametrize("shape,with_bias", [
    ((1, 16, 64, 160), False), ((2, 8, 32, 80), True), ((1, 3, 7, 21), True),
    ((3, 1, 1, 1), False),
    # ragged and degenerate: X, Y not multiples of the tile, Z = 1, one row,
    # wider than one x tile, tall enough for many y tiles
    ((2, 5, 13, 37), True), ((1, 1, 64, 160), False), ((2, 3, 1, 200), True),
    ((1, 2, 300, 7), False), ((8, 8, 32, 80), False), ((1, 4, 9, 81), True),
    # B * Z above the 65535 a grid dimension holds
    ((1, 70000, 2, 3), False)])
def test_conv_kernel_matches_plain(dev, shape, with_bias):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((*shape, 32), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((32, 32, 3, 3, 3), generator=g, device=dev) * 0.05
    b = torch.randn((32,), generator=g, device=dev) if with_bias else None
    ops.reset_launch_counts()
    got = conv_k3.conv3d_k3(x, w, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["conv3d_k3"] == 1
    want = conv_k3.conv3d_k3_reference(x, w, b)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2e-3 * want.float().abs().max().item())


def test_conv_kernel_is_deterministic(dev):
    """Two launches on the same inputs give bit-identical outputs (no split-K,
    no atomics), forward and grad-input."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 16, 64, 160, 32), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((32, 32, 3, 3, 3), generator=g, device=dev) * 0.05
    b = torch.randn((32,), generator=g, device=dev)
    assert torch.equal(conv_k3.conv3d_k3(x, w, b), conv_k3.conv3d_k3(x, w, b))
    assert torch.equal(conv_k3.grad_input(x, w), conv_k3.grad_input(x, w))


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((1, 2, 3, 4, 32), device=dev)
    w = torch.zeros((32, 32, 3, 3, 3), device=dev)
    with pytest.raises(ValueError):
        conv_k3.conv3d_k3(x, w)                       # float32 input
    with pytest.raises(ValueError):
        conv_k3.conv3d_k3(x.to(torch.bfloat16).transpose(2, 3), w)   # not contiguous
    raw = torch.zeros((1, 2, 3, 4, 5), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        preprocess.fused_preprocess_batch(raw, (0, 3, 0, 3, 0, 4), 0.0, 1.0)
    with pytest.raises(TypeError):
        preprocess.fused_preprocess_batch(raw.double(), (0, 2, 0, 3, 0, 4), 0.0, 1.0)


def test_module_launches_kernel_with_kept_weights(dev):
    """``TorchConv3d`` under inference_mode launches the kernel with its kept
    (9, 4, 3, 32, 8) weights, and refreshes them when the parameter changes."""
    from rtpose_tpu_torch.models.layers import TorchConv3d
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((1, 4, 8, 20, 32), generator=g, device=dev).to(torch.bfloat16)
    m = TorchConv3d(32, 32, bias=False, dtype="bfloat16").to(dev)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g, device=dev) * 0.05)
    ops.reset_launch_counts()
    with torch.inference_mode():
        a, b = m(x), m(x)
        assert ops.launch_counts()["conv3d_k3"] == 2
        assert m._prepared[2][0].shape == (9, 4, 3, 32, 8)
    with torch.no_grad():
        m.weight.mul_(-1.0)
    with torch.inference_mode():
        c = m(x)
    torch.cuda.synchronize()
    want = conv_k3.conv3d_k3_reference(x, m.weight)
    tol = dict(rtol=2.0 ** -7, atol=2e-3 * want.float().abs().max().item())
    torch.testing.assert_close(c.float(), want.float(), **tol)
    torch.testing.assert_close(a.float(), -want.float(), **tol)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape,with_bias", [((2, 16, 64, 160), False), ((2, 8, 32, 80), False),
                                             ((1, 3, 7, 21), True)])
def test_conv_backward_matches_plain(dev, shape, with_bias):
    """``Conv3dK3``'s backward on the card: grad-input through the kernel on
    flipped, transposed weights (one ``conv3d_k3_bwd`` launch), grad-weight
    and grad-bias in float32, against autograd of the plain version."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((*shape, 32), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((32, 32, 3, 3, 3), generator=g, device=dev) * 0.05
    b = torch.randn((32,), generator=g, device=dev) if with_bias else None
    go = torch.randn((*shape, 32), generator=g, device=dev).to(torch.bfloat16)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    bk = b.clone().requires_grad_() if with_bias else None
    ops.reset_launch_counts()
    out = conv_k3.Conv3dK3.apply(xk, wk, bk)
    out.backward(go)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"preprocess": 0, "preprocess_single": 0, "conv3d_k3": 1,
                                   "conv3d_k3_bwd": 1, "conv3d_k3_int8": 0,
                                   "deform_conv2d": 0, "group_norm": 0,
                                   "resize_trilinear": 0}
    want_gx = conv_k3.conv3d_k3_reference(go, conv_k3.flip_transpose(w))
    torch.testing.assert_close(xk.grad.float(), want_gx.float(), rtol=2.0 ** -7,
                               atol=2e-3 * want_gx.float().abs().max().item())
    xr, wr = x.float().requires_grad_(), w.clone().requires_grad_()
    torch.nn.functional.conv3d(xr.permute(0, 4, 1, 2, 3), wr.to(torch.bfloat16).float(),
                               padding=1).permute(0, 2, 3, 4, 1).backward(go.float())
    assert wk.grad.dtype == torch.float32
    torch.testing.assert_close(wk.grad, wr.grad, rtol=2.0 ** -7,
                               atol=2e-3 * wr.grad.abs().max().item())
    if with_bias:
        torch.testing.assert_close(bk.grad, go.float().sum((0, 1, 2, 3)), rtol=1e-5, atol=1e-4)


def test_module_grad_mode_has_grad_fn_and_right_gradients(dev):
    """``TorchConv3d`` under grad mode on the card returns a tensor with a
    ``grad_fn``; its gradients match autograd of the plain version."""
    from rtpose_tpu_torch.models.layers import TorchConv3d
    g = torch.Generator(device=dev).manual_seed(4)
    m = TorchConv3d(32, 32, bias=False, dtype="bfloat16").to(dev)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g, device=dev) * 0.05)
    x = torch.randn((2, 4, 8, 20, 32), generator=g, device=dev).requires_grad_()
    go = torch.randn((2, 4, 8, 20, 32), generator=g, device=dev).to(torch.bfloat16)
    ops.reset_launch_counts()
    out = m(x)
    assert out.grad_fn is not None
    out.backward(go)
    torch.cuda.synchronize()
    assert ops.launch_counts()["conv3d_k3_bwd"] == 1
    xr, wr = x.detach().clone().requires_grad_(), m.weight.detach().clone().requires_grad_()
    conv_k3.conv3d_k3_reference(xr, wr).backward(go)
    torch.testing.assert_close(x.grad, xr.grad, rtol=2.0 ** -7,
                               atol=2e-3 * xr.grad.abs().max().item())
    torch.testing.assert_close(m.weight.grad, wr.grad, rtol=2.0 ** -7,
                               atol=2e-3 * wr.grad.abs().max().item())


def test_float8_cache_rows_gather_on_the_card(dev):
    """float8_e4m3fn cache rows are gathered as bytes on the card and come
    back as on the CPU, bit for bit (the cast to float8 is made on the host,
    the cast back on the card)."""
    from rtpose_tpu_torch.data.loader import cache_cast, gather_batch

    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, 4 * 6 * 8), generator=g) * 300          # some beyond +-464: NaN
    rows = cache_cast(x, torch.float8_e4m3fn)
    sel = torch.tensor([63, 0, 17, 17, 5, 40, 1, 2])
    shapes, orig = {"x": (4, 6, 8)}, {"x": torch.float16}
    want = gather_batch({"x": rows}, sel, 8, shapes, orig)["x"]
    got = gather_batch({"x": rows.to(dev)}, sel.to(dev), 8, shapes, orig)["x"]
    assert got.device.type == "cuda" and got.dtype == torch.float16 and got.shape == (8, 4, 6, 8)
    assert torch.isnan(want).any()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0, equal_nan=True)


# a small bf16 model whose backbone runs the K3 kernel (32-channel stride-1
# 3x3x3 convs), on raw f16 cubes of 32 Doppler channels over SMALL_GRID
SMALL_GRID = (8, 16, 32)
SMALL_MODEL = dict(
    type="RadarPoseNet", reader=dict(type="RadarFeatureNet"),
    backbone=dict(type="HRNet3D", backbone_cfg="hr_tiny_feat32_zyx_l4_in32",
                  final_conv_in=192, final_conv_out=128, final_fuse="conat_conv",
                  ds_factor=1, dtype="bfloat16"),
    pose_head=dict(type="CenterHead", tasks=[dict(num_class=1, class_names=["Pelvis"])],
                   in_channels=128, share_conv_channel=64, common_heads={"reg": (45, 2)},
                   weight=0.5, code_weights=[1.0] * 45, dtype="bfloat16"),
    neck=None)


def _small_cache(dev, n):
    """``n`` seeded cache rows for the small model (raw f16 cubes, one pose
    each) and their shapes."""
    g = torch.Generator().manual_seed(0)
    Z, Y, X = SMALL_GRID
    raw = (torch.rand((n, 32, Z, Y, X), generator=g) * 12).half()
    poses = (torch.rand((n, 1, 15, 3), generator=g) * 0.6 + 0.2) \
        * torch.tensor([X * 0.25, Y * 0.5, Z * 0.25]) + torch.tensor([0.0, -4.0, -1.0])
    data = {"rdr_raw": raw.reshape(n, -1).to(dev), "poses": poses.reshape(n, -1).to(dev),
            "num_poses": torch.ones((n, 1), dtype=torch.int32, device=dev)}
    shapes = {"rdr_raw": (32, Z, Y, X), "poses": (1, 15, 3), "num_poses": ()}
    return data, shapes


def _small_train_step(model, lr):
    """The small model's sparse train step at a constant ``lr`` and its state."""
    from rtpose_tpu_torch.core.targets import PoseTargetSpec
    from rtpose_tpu_torch.engine import create_train_state, make_train_step
    from rtpose_tpu_torch.solver import AdamOneCycle

    dev = next(model.parameters()).device
    spec = PoseTargetSpec(grid_zyx=SMALL_GRID, pc_range_min_xyz=(0.0, -4.0, -1.0),
                          voxel_size_xyz=(0.25, 0.5, 0.25), max_poses=1, min_radius=2,
                          mode="one_hm", num_classes=1)
    opt = AdamOneCycle(list(model.parameters()), lambda s: torch.full((), lr, device=dev),
                       None, weight_decay=0.0)
    step = make_train_step(model, model.pose_head, spec, opt, sparse_reg=True,
                           preprocess=(0.0, 10.0))
    return step, create_train_state(model, opt)


def test_captured_step_replayed_twice_equals_two_eager_steps(dev):
    """``make_epoch_step`` on the card: one step captured in a CUDA graph and
    replayed for both steps of an epoch, against two eager train steps on the
    same cached rows, from the same weights.  A small bf16 model whose
    backbone runs the K3 kernel forward and backward (32-channel stride-1
    3x3x3 convs), raw f16 cubes through the preprocess kernel.

    Tolerance: the trilinear upsample's backward adds bf16 values with
    atomics, in an order that changes from run to run, so two eager runs
    differ too, and Adam turns a last-bit difference of a small gradient into
    a different step; with seeded random weights (losses of ~1e4) the second
    step already sits on the first one's noise.  So the test measures the
    noise: two eager runs against each other, as the distance between their
    parameters over the distance moved from the seeded weights.  Held: the
    graph run is as near to an eager run as three times that (at least 0.02),
    every element within 2.05 lr per step, the first step's loss (same
    weights, same batch) to 1e-3 relative and the second's to 5 %.  The launch
    counts are the wrappers' own: a fused epoch passes them in its warm-up step
    and in the capture and in no replay, so they read two steps' worth after
    the first epoch and the same after the second."""
    from rtpose_tpu_torch.engine import make_epoch_step
    from rtpose_tpu_torch.models import build_detector, init_weights

    lr, bs, n = 1e-3, 2, 4
    data, shapes = _small_cache(dev, n)
    idx = torch.tensor([2, 0, 3, 1]).numpy()

    def fresh():
        model = init_weights(build_detector(SMALL_MODEL),
                             torch.Generator().manual_seed(1)).to(dev)
        return (model, *_small_train_step(model, lr))

    def flat(model):
        return torch.cat([p.detach().reshape(-1) for p in model.parameters()])

    def eager():
        model, step, state = fresh()
        losses = []
        for b in range(n // bs):
            sel = torch.from_numpy(idx[b * bs:(b + 1) * bs]).to(dev)
            batch = {k: v.index_select(0, sel).reshape(bs, *shapes[k])
                     for k, v in data.items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        return flat(model), losses

    p0 = flat(fresh()[0])
    ops.reset_launch_counts()
    params_e, losses_e = eager()
    eager_counts = ops.launch_counts()
    params_e2, _ = eager()
    noise = float((params_e2 - params_e).norm() / (params_e - p0).norm())
    assert eager_counts["preprocess"] == 2 and eager_counts["conv3d_k3"] > 0 \
        and eager_counts["conv3d_k3_bwd"] > 0

    model_g, step_g, state_g = fresh()
    epoch_fn = make_epoch_step(step_g, bs, shapes, {})
    ops.reset_launch_counts()
    state_g, ms = epoch_fn(state_g, data, idx)
    torch.cuda.synchronize()
    assert epoch_fn.graph is not None and epoch_fn.replays == 2
    per_step = {k: v // 2 for k, v in eager_counts.items()}
    assert epoch_fn.launches_per_step == per_step
    warm_and_capture = {k: 2 * v for k, v in per_step.items()}
    assert ops.launch_counts() == warm_and_capture
    assert int(state_g.step) == int(state_g.optimizer.step_count) == 2
    assert ms["loss"].shape == (2,) and float(ms["skipped"].sum()) == 0.0
    assert float(ms["loss"][0]) == pytest.approx(losses_e[0], rel=1e-3)
    assert float(ms["loss"][1]) == pytest.approx(losses_e[1], rel=0.05)
    assert torch.isfinite(ms["loss"]).all() and torch.isfinite(ms["grad_norm"]).all()
    params_g = flat(model_g)
    assert float((params_g - params_e).abs().max()) <= 2 * 2.05 * lr
    dist = float((params_g - params_e).norm() / (params_e - p0).norm())
    assert dist <= max(3 * noise, 0.02), (dist, noise)
    # a second epoch replays the same graph
    state_g, ms = epoch_fn(state_g, data, idx)
    assert epoch_fn.replays == 4 and int(state_g.step) == 4 and torch.isfinite(ms["loss"]).all()
    assert ops.launch_counts() == warm_and_capture


# ------------------------------------------------------- eval CUDA graphs

SMALL_DECODE = dict(grid_zyx=SMALL_GRID, pc_range_min_xyz=(0.0, -4.0, -1.0),
                    voxel_size_xyz=(0.25, 0.5, 0.25))
NORM = (0.0, 10.0)


def _small_eval(dev, sparse=True, multi_poses=0):
    """The small model on the card with seeded weights, its eval step on raw
    cubes, and a maker of seeded (B, 32, Z, Y, X) f16 raw batches."""
    from rtpose_tpu_torch.core.decode import DecodeSpec
    from rtpose_tpu_torch.engine import make_eval_step
    from rtpose_tpu_torch.models import build_detector, init_weights

    model = init_weights(build_detector(SMALL_MODEL), torch.Generator().manual_seed(1))
    model = model.to(dev).eval()
    step = make_eval_step(model, DecodeSpec(**SMALL_DECODE), sparse=sparse, preprocess=NORM,
                          multi_poses=multi_poses)

    def raw(B, seed):
        g = torch.Generator().manual_seed(seed)
        return (torch.rand((B, 32, *SMALL_GRID), generator=g) * 12).half().to(dev)

    return model, step, raw


def _equal(got, want):
    assert len(got) == len(want)
    for g_task, w_task in zip(got, want):
        assert len(g_task) == len(w_task)
        for g, w in zip(g_task, w_task):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w)


@pytest.mark.parametrize("B,path", [(1, "sparse"), (2, "sparse"), (2, "dense"), (2, "multi")])
def test_eval_graph_replay_equals_the_eager_step(dev, B, path):
    """The eval step replayed from its CUDA graph gives, bit for bit, the
    eager step's answer on the same batch (the same kernels on the same
    inputs): the first call eager, the second captured and replayed, later
    calls replays on new batches.  The sparse path at B=1 and B=2, the
    dense and the multi-person decode at B=2."""
    _, step, raw = _small_eval(dev, sparse=path == "sparse",
                               multi_poses=2 if path == "multi" else 0)
    batches = [{"rdr_raw": raw(B, seed)} for seed in range(4)]
    want = [step.step(b) for b in batches]
    got = [step(b) for b in batches]
    torch.cuda.synchronize()
    assert (step.eager, step.captures, step.replays) == (1, 1, 2)
    for g, w in zip(got, want):
        _equal(g, w)


def test_eval_graph_answers_stay_the_callers(dev):
    """A later call (replay) leaves the tensors an earlier call returned as
    they were: the answers are clones, not the graph's buffers."""
    _, step, raw = _small_eval(dev)
    step({"rdr_raw": raw(1, 0)})
    first = step({"rdr_raw": raw(1, 1)})                  # the capture
    kept = [[t.clone() for t in task] for task in first]
    second = step({"rdr_raw": raw(1, 2)})                 # a replay
    torch.cuda.synchronize()
    assert step.replays == 1
    _equal(first, kept)
    assert not torch.equal(first[0][0], second[0][0])


def test_eval_graph_captures_again_after_the_weights_change(dev):
    """Weights loaded in place (``load_state_dict``: the parameters' version
    counters move) drop the graph: the next call runs eagerly on the new
    weights, the one after captures again, and both give the eager step's
    answer."""
    from rtpose_tpu_torch.models import build_detector, init_weights

    model, step, raw = _small_eval(dev)
    b = {"rdr_raw": raw(1, 0)}
    step(b)
    before = step(b)
    other = init_weights(build_detector(SMALL_MODEL), torch.Generator().manual_seed(2))
    model.load_state_dict(other.state_dict())
    after = step(b)
    assert (step.eager, step.captures, step.replays) == (2, 1, 0)
    _equal(after, step.step(b))
    assert not torch.equal(after[0][0], before[0][0])
    again = step(b)
    assert (step.eager, step.captures, step.replays) == (2, 2, 0)
    _equal(again, after)
    step(b)
    assert step.replays == 1


def test_eval_graph_after_a_fused_epoch_reads_the_trained_weights(dev):
    """A fused training epoch (``make_epoch_step``'s graph replays) changes
    the weights in place and moves their version counters, so the eval
    step captured before it neither replays nor reuses the convs' weights
    prepared before it: its next answer is, bit for bit, that of a fresh
    model loaded with the trained weights, and the call after captures
    again."""
    from rtpose_tpu_torch.core.decode import DecodeSpec
    from rtpose_tpu_torch.engine import make_epoch_step, make_eval_step
    from rtpose_tpu_torch.models import build_detector

    model, step, raw = _small_eval(dev)
    b = {"rdr_raw": raw(1, 0)}
    step(b)
    before = step(b)                                       # captured
    data, shapes = _small_cache(dev, 4)
    train_step, state = _small_train_step(model, 1e-3)
    epoch_fn = make_epoch_step(train_step, 2, shapes, {})
    epoch_fn(state, data, torch.tensor([2, 0, 3, 1]).numpy())
    assert epoch_fn.replays == 2
    model.eval()
    fresh = build_detector(SMALL_MODEL).to(dev).eval()
    fresh.load_state_dict(model.state_dict())
    want = make_eval_step(fresh, DecodeSpec(**SMALL_DECODE), sparse=True,
                          preprocess=NORM).step(b)
    after = step(b)
    assert (step.eager, step.captures, step.replays) == (2, 1, 0)
    _equal(after, want)
    assert not torch.equal(after[0][0], before[0][0])
    _equal(step(b), want)
    assert (step.eager, step.captures, step.replays) == (2, 2, 0)


def test_eval_graph_captures_again_after_a_submodule_is_replaced(dev):
    """A submodule swapped for another (new parameters, the old module kept
    alive by the graph) drops the graph as a parameter changed in place
    does: the next call runs eagerly on the new module."""
    import copy

    model, step, raw = _small_eval(dev)
    b = {"rdr_raw": raw(1, 0)}
    step(b)
    before = step(b)
    name, conv = next((n, m) for n, m in model.pose_head.named_modules()
                      if type(m).__name__ == "TorchConv3d")
    parent = model.pose_head.get_submodule(name.rpartition(".")[0])
    swapped = copy.deepcopy(conv)
    with torch.no_grad():
        swapped.weight.mul_(0.5)
    setattr(parent, name.rpartition(".")[2], swapped)
    after = step(b)
    assert (step.eager, step.captures, step.replays) == (2, 1, 0)
    _equal(after, step.step(b))
    assert not torch.equal(after[0][0], before[0][0])


def test_eval_graph_stays_eager_under_a_quant_context(dev):
    """Under ``quant.calibrate`` (``calibration_scales``) and under
    ``quant.int8_mode`` the step runs eagerly: ``eager`` advances,
    ``replays`` does not, and the int8 kernel's wrapper counts its
    launches.  Out of the context the kept graph replays again.  B=4: the
    int8 route's ``torch._int_mm`` needs more than 16 rows, and the coarsest
    HRNet branch holds 8 voxels a frame here."""
    from rtpose_tpu_torch.engine import bind_sites
    from rtpose_tpu_torch.ops import quant

    model, step, raw = _small_eval(dev)
    bind_sites(model)
    b = {"rdr_raw": raw(4, 0)}
    step(b)
    step(b)
    assert (step.eager, step.captures, step.replays) == (1, 1, 0)
    scales = quant.calibration_scales(step, [b, {"rdr_raw": raw(4, 1)}])
    assert (step.eager, step.replays) == (3, 0) and scales
    ops.reset_launch_counts()
    with quant.int8_mode(scales, exclude=quant.DEFAULT_EXCLUDE):
        q = step(b)
    torch.cuda.synchronize()
    assert (step.eager, step.captures, step.replays) == (4, 1, 0)
    assert ops.launch_counts()["conv3d_k3_int8"] > 0
    assert torch.isfinite(q[0][0]).all()
    step(b)
    assert (step.eager, step.captures, step.replays) == (4, 1, 1)


def test_run_eval_captures_while_the_prefetch_worker_copies(dev):
    """``run_eval`` over eight B=1 frames: the capture (second batch) runs
    while ``device_prefetch``'s worker pins and copies the next batches on
    its stream, and the detections equal an eager run's."""
    import numpy as np

    from rtpose_tpu_torch.core.decode import DecodeSpec
    from rtpose_tpu_torch.engine import run_eval

    _, step, _ = _small_eval(dev)
    g = torch.Generator().manual_seed(3)
    frames = (torch.rand((8, 1, 32, *SMALL_GRID), generator=g) * 12).half().numpy()

    class Loader:
        def __len__(self):
            return len(frames)

        def __iter__(self):
            for i, f in enumerate(frames):
                yield {"rdr_raw": f, "meta": [dict(seq="0", frame=str(i), rdr_frame=str(i))],
                       "valid": np.int32(1)}

    spec = DecodeSpec(**SMALL_DECODE)
    got, _ = run_eval(step, Loader(), spec, device=dev)
    want, _ = run_eval(step.step, Loader(), spec, device=dev)
    assert (step.eager, step.captures, step.replays) == (1, 1, len(frames) - 2)
    assert sorted(got) == sorted(want) and len(got) == len(frames)
    for k in want:
        assert got[k] == want[k]


def test_eval_graph_of_the_deformable_head_replays_without_counting(dev):
    """The dense step of the deformable head (offset convs drawn non-zero):
    eager, captured, then replayed, each replay the eager step's answer bit
    for bit; the deformable conv's counters and its kernel's launches move on
    the eager call, the capture's warm-up and the capture (each deformable
    conv through the kernel), and not on a replay."""
    import copy

    from rtpose_tpu_torch.core.decode import DecodeSpec
    from rtpose_tpu_torch.engine import make_eval_step
    from rtpose_tpu_torch.models import build_detector, init_weights
    from rtpose_tpu_torch.models.dcn_head import FeatureAdaption
    from rtpose_tpu_torch.ops import deform_conv

    cfg = copy.deepcopy(SMALL_MODEL)
    cfg["pose_head"].update(share_conv_channel=128, dcn_head=True)
    g = torch.Generator().manual_seed(1)
    model = init_weights(build_detector(cfg), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FeatureAdaption):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=g) * 0.05)
    model = model.to(dev).eval()
    step = make_eval_step(model, DecodeSpec(**SMALL_DECODE), sparse=False, preprocess=NORM)
    raw = torch.Generator().manual_seed(5)
    batches = [{"rdr_raw": (torch.rand((2, 32, *SMALL_GRID), generator=raw) * 12).half().to(dev)}
               for _ in range(4)]
    want = [step.step(b) for b in batches]
    deform_conv.reset()
    ops.reset_launch_counts()
    got = [step(b) for b in batches[:2]]
    counted, launched = deform_conv.counts(), ops.launch_counts()["deform_conv2d"]
    got += [step(b) for b in batches[2:]]
    torch.cuda.synchronize()
    assert (step.eager, step.captures, step.replays) == (1, 1, 2)
    Z, Y, X = SMALL_GRID
    assert counted["calls"] == 2 * 3 and counted["samples"] == 3 * 2 * 2 * Z * Y * X * 9 * 4
    # the eager call, the capture's warm-up and the capture took the kernel
    assert counted["calls"] == launched
    assert counted["chunks"] == 0
    assert deform_conv.counts() == counted
    assert ops.launch_counts()["deform_conv2d"] == launched
    for a, b in zip(got, want):
        _equal(a, b)


def test_phase_eval_graph_replays_leave_the_counts(dev):
    """The complex-cube model (``_phase``) at its published widths and grid,
    B=1, through ``run_eval`` on host float32 ``rdr_tensor`` frames: the
    first frame eager, the second captured, the rest replayed, each frame's
    answer the eager step's.  The shared conv and the patches are counted
    on the eager call, the capture's warm-up and the capture, not on a
    replay; the graph launches no K1, no K3, 49 GroupNorms a forward (the
    trunk's 48 and the shared conv's one: it runs once, densely) and 13
    resizes; the
    prefetch counts every frame's bytes."""
    import numpy as np

    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.engine import evaluator, make_eval_step, run_eval
    from rtpose_tpu_torch.models import detectors, init_weights

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "cruw_pose", "hr3d_one_hm_doppler_phase.py")
    asm = assemble(Config.fromfile(path))
    model = init_weights(asm.model, torch.Generator().manual_seed(3)).to(dev).eval()
    step = make_eval_step(model, asm.decode_spec, sparse=asm.sparse_head)
    g = torch.Generator().manual_seed(4)
    frames = torch.randn((6, 1, *asm.input_shape_zyxc), generator=g).numpy()

    class Loader:
        def __len__(self):
            return len(frames)

        def __iter__(self):
            for i, f in enumerate(frames):
                yield {"rdr_tensor": f, "meta": [dict(seq="0", frame=str(i), rdr_frame=str(i))],
                       "valid": np.int32(1)}

    detectors.reset()
    evaluator.reset()
    ops.reset_launch_counts()
    got, _ = run_eval(step, Loader(), asm.decode_spec, device=dev)
    torch.cuda.synchronize()
    assert (step.eager, step.captures, step.replays) == (1, 1, len(frames) - 2)
    Z, Y, X, _ = asm.input_shape_zyxc
    # the eager call, the capture's warm-up and the capture
    assert detectors.counts() == dict(shared_calls=3, shared_voxels=3 * Z * Y * X,
                                      reg_patches=3)
    assert ops.launch_counts()["group_norm"] == 3 * 49
    assert ops.launch_counts()["resize_trilinear"] == 3 * 13
    per = step.counts()["launches_per_replay"]
    assert per["group_norm"] == 49 and per["resize_trilinear"] == 13
    assert per["preprocess"] == per["preprocess_single"] == per["conv3d_k3"] == 0
    assert evaluator.counts()["h2d_bytes"] == frames.nbytes
    want, _ = run_eval(step.step, Loader(), asm.decode_spec, device=dev)
    assert sorted(got) == sorted(want) and len(got) == len(frames)
    for k in want:
        assert got[k] == want[k]


def test_voxel_to_world_on_the_card_equals_the_tensor_formula(dev):
    """On the card too, the Python-float scale and offset give the float32
    values of the float32 tensor formula, bit for bit."""
    from rtpose_tpu_torch.core.decode import DecodeSpec, _voxel_to_world

    s = DecodeSpec(grid_zyx=(16, 64, 160), pc_range_min_xyz=(0.7703125, -1.25625, -1.0875),
                   voxel_size_xyz=(0.009375, 0.0392578125, 0.18125),
                   out_size_factor_zyx=(2, 1, 3))
    (fz, fy, fx), (sx, sy, sz) = s.out_size_factor_zyx, s.voxel_size_xyz
    scale = torch.tensor([sx * fx, sy * fy, sz * fz], dtype=torch.float32, device=dev)
    offset = torch.tensor(s.pc_range_min_xyz, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    vox = torch.rand((64, 15, 3), generator=g, device=dev) * 220 - 20
    assert torch.equal(_voxel_to_world(vox, s), vox * scale + offset)


# ---------------------------------------------------------------- GroupNorm

# the flagship trunk's GroupNorm inputs: (Z, Y, X), C; and the head's
# shared_conv width at the full grid
GN_SHAPES = [((16, 64, 160), 32), ((8, 32, 80), 32), ((4, 16, 40), 64), ((4, 16, 40), 32),
             ((2, 8, 20), 64), ((16, 64, 160), 128)]


def _gn_case(dev, shape, seed=0):
    from rtpose_tpu_torch.models import GroupNorm8

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
    m = GroupNorm8(shape[-1]).to(dev)
    with torch.no_grad():
        m.weight.copy_(torch.randn(shape[-1], generator=g, device=dev))
        m.bias.copy_(torch.randn(shape[-1], generator=g, device=dev))
    return x, m


def _bf16_ulps(got, want):
    """The largest |got - want| in bf16 ulps of ``want`` (the spacing at
    |want|, at least at 2^-8 of the largest |want|)."""
    w = want.float().abs()
    w = w.clamp_min(w.max().item() * 2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("zyx,C", GN_SHAPES)
def test_group_norm_kernel_matches_plain(dev, B, zyx, C):
    """The kernel against the plain bf16 route: one bf16 ulp (the two round
    float32 values a few float32 ulps apart) plus 2^-16 of the output range
    for the cancellation in x * scale + shift near zero; two launches
    bit-equal; one launch counted a call."""
    from rtpose_tpu_torch.ops import group_norm as gn

    x, m = _gn_case(dev, (B, *zyx, C))
    ops.reset_launch_counts()
    with torch.no_grad():
        assert gn.kernel_route(x, m.weight, m.bias, m.groups)
        got, again = m(x), m(x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["group_norm"] == 2
    assert torch.equal(got, again)
    want = gn.group_norm_reference(x, m.weight, m.bias, m.groups, m.eps)
    print(f"group_norm {(B, *zyx, C)}: {_bf16_ulps(got, want)} bf16 ulps")
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2.0 ** -16 * want.float().abs().max().item())


def test_group_norm_kernel_graph_replay_equals_eager(dev):
    from rtpose_tpu_torch.ops import group_norm as gn

    x, m = _gn_case(dev, (8, 8, 32, 80, 32), seed=1)
    with torch.no_grad():
        want = m(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            m(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        ops.reset_launch_counts()
        with torch.cuda.graph(graph):
            out = m(x)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want)
    assert ops.launch_counts()["group_norm"] == 1    # the capture; replays pass no wrapper
    assert gn.kernel_route(x, m.weight, m.bias, m.groups) is False   # grad mode back on


@pytest.mark.parametrize("shape", [(0, 4, 5, 6, 32), (2, 0, 5, 6, 32)])
def test_group_norm_kernel_zero_size(dev, shape):
    x, m = _gn_case(dev, (1, 1, 1, 1, 32))
    x = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = m(x)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert ops.launch_counts()["group_norm"] == 0


@pytest.mark.parametrize("layout", ["strided", "misaligned"])
def test_group_norm_kernel_copies_what_it_cannot_read(dev, layout):
    """A non-contiguous or not 16-byte aligned input is copied first: the
    answer is the contiguous input's, bit for bit."""
    x, m = _gn_case(dev, (2, 4, 16, 40, 64), seed=2)
    if layout == "strided":
        wide = torch.zeros((*x.shape[:-1], 2 * x.shape[-1]), dtype=x.dtype, device=dev)
        wide[..., ::2] = x
        xv = wide[..., ::2]
    else:
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        xv = flat[1:].view(x.shape)
        xv.copy_(x)
        assert xv.data_ptr() % 16
    with torch.no_grad():
        assert torch.equal(m(xv), m(x))


def test_group_norm_kernel_counts_48_a_trunk_forward_and_none_in_training(dev):
    """The trunk (the flagship backbone, 48 GroupNorms) under ``no_grad``
    launches the kernel once a GroupNorm; in training, and on float32
    calls, the plain version runs and nothing is counted."""
    from rtpose_tpu_torch.models import build_detector, init_weights

    model = init_weights(build_detector(SMALL_MODEL), torch.Generator().manual_seed(1)).to(dev)
    x = torch.rand((2, *SMALL_GRID, 32), device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        feat = model.eval().extract_feat(x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["group_norm"] == 48
    ops.reset_launch_counts()
    model.train().extract_feat(x).float().sum().backward()
    with torch.no_grad():
        model.pose_head.shared_conv[0](feat.float())
    torch.cuda.synchronize()
    assert ops.launch_counts()["group_norm"] == 0


# ------------------------------------------------------------ trilinear resize

def _rs_calls():
    from rtpose_tpu_torch.models.hrnet3d import resize_calls
    return [pytest.param(*c, id=f"{m}-{k}") for m, cfg in (
        ("flagship", "hr_tiny_feat32_zyx_l4_in32"), ("phase", "hr_tiny_feat64_zyx_l4_in64"))
        for k, c in enumerate(resize_calls(cfg, (16, 64, 160)))]


def _rs_case(dev, shape, size, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(torch.bfloat16)
    a = (torch.randn((shape[0], *size, shape[4]), generator=g, device=dev) * 3).to(torch.bfloat16)
    return x, a


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("zin,zout,C,add", _rs_calls())
def test_resize_kernel_matches_f_interpolate(dev, B, zin, zout, C, add):
    """At every resize of the flagship's and the feat64 trunk's forward: the
    kernel within one bf16 ulp of ``F.interpolate`` (the share of bit-equal
    elements printed), bit-equal to its arithmetic in stock float32 ops
    (``kernel_reference`` on the card), the addend's epilogue bit-equal to
    the separate add and the slice to the resize, two launches bit-equal,
    one launch counted a call."""
    import torch.nn.functional as F

    from rtpose_tpu_torch.ops import interpolate as rs

    x, a = _rs_case(dev, (B, *zin, C), zout)
    buf = torch.zeros((B, *zout, 3 * C), dtype=torch.bfloat16, device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        assert rs.kernel_route(x, zout, a) and rs.kernel_route(x, zout, out=buf[..., C:2 * C])
        got, again = rs.resize_trilinear_align_corners(x, zout), \
            rs.resize_trilinear_align_corners(x, zout)
        fused = rs.resize_trilinear_align_corners(x, zout, addend=a)
        rs.resize_trilinear_align_corners(x, zout, out=buf[..., C:2 * C])
        model = rs.kernel_reference(x, zout)
    torch.cuda.synchronize()
    assert ops.launch_counts()["resize_trilinear"] == 4
    assert torch.equal(got, again) and torch.equal(got, model)
    assert torch.equal(fused, a + got) and torch.equal(buf[..., C:2 * C], got)
    assert not buf[..., :C].any() and not buf[..., 2 * C:].any()
    lib = F.interpolate(x.permute(0, 4, 1, 2, 3), size=zout, mode="trilinear",
                        align_corners=True).permute(0, 2, 3, 4, 1)
    ulps = _bf16_ulps(got, lib)
    print(f"resize {(B, *zin, C)} -> {zout}: {ulps} bf16 ulps, "
          f"{100 * (got == lib).float().mean().item():.4f} % bit-equal to F.interpolate")
    assert ulps <= 1.0


def test_resize_kernel_graph_replay_equals_eager_and_leaves_the_addend(dev):
    """Two replays of a captured launch give the eager call's bits; the
    addend, which the fuse reads again (row 0's running sum starts as
    ``feats[0]``), is left as it was."""
    from rtpose_tpu_torch.ops import interpolate as rs

    x, a = _rs_case(dev, (8, 8, 32, 80, 32), (16, 64, 160), seed=1)
    a0 = a.clone()
    with torch.no_grad():
        want = rs.resize_trilinear_align_corners(x, (16, 64, 160), addend=a)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            rs.resize_trilinear_align_corners(x, (16, 64, 160), addend=a)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        ops.reset_launch_counts()
        with torch.cuda.graph(graph):
            out = rs.resize_trilinear_align_corners(x, (16, 64, 160), addend=a)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want)
    assert ops.launch_counts()["resize_trilinear"] == 1    # the capture; replays pass no wrapper
    assert torch.equal(a, a0) and out.data_ptr() != a.data_ptr()


def test_resize_kernel_zero_size_and_misaligned(dev):
    from rtpose_tpu_torch.ops import interpolate as rs

    ops.reset_launch_counts()
    with torch.no_grad():
        out = rs.resize_trilinear_align_corners(
            torch.empty((0, 2, 4, 5, 16), dtype=torch.bfloat16, device=dev), (4, 8, 10))
        assert out.shape == (0, 4, 8, 10, 16)
        flat = torch.zeros(2 * 4 * 5 * 16 + 4, dtype=torch.bfloat16, device=dev)
        x = flat[4:].view(1, 2, 4, 5, 16)      # 8 bytes into its storage
        assert not rs.kernel_route(x, (4, 8, 10))
        assert torch.equal(rs.resize_trilinear_align_corners(x, (4, 8, 10)),
                           rs.resize_reference(x, (4, 8, 10)))
    assert ops.launch_counts()["resize_trilinear"] == 0


def test_resize_kernel_counts_13_a_forward_of_the_eval_step(dev):
    """The eval step (the small model, the flagship trunk) launches the
    resize kernel 13 times a forward: the eager call, the capture's warm-up
    and the capture each 13, and the graph holds 13 a replay; a training
    forward and a float32 resize launch none."""
    from rtpose_tpu_torch.ops import interpolate as rs

    model, step, raw = _small_eval(dev)
    b = {"rdr_raw": raw(2, 0)}
    ops.reset_launch_counts()
    rs.reset()
    step(b)
    step(b)
    step(b)
    torch.cuda.synchronize()
    assert step.launches_per_replay["resize_trilinear"] == 13
    assert ops.launch_counts()["resize_trilinear"] == 3 * 13
    assert rs.counts() == dict(kernel=3 * 13, plain=0)
    ops.reset_launch_counts()
    rs.reset()
    x = torch.rand((2, *SMALL_GRID, 32), device=dev)
    model.train().extract_feat(x).float().sum().backward()
    with torch.no_grad():
        rs.resize_trilinear_align_corners(x, (16, 32, 64))
    torch.cuda.synchronize()
    assert ops.launch_counts()["resize_trilinear"] == 0
    assert rs.counts() == dict(kernel=0, plain=13 + 1)


# ------------------------------------------------------------------ int8 K3

def _int8_case(dev, shape, with_bias, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    xq = torch.randint(-127, 128, (*shape, 32), generator=g, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (32, 32, 3, 3, 3), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand((32,), generator=g, device=dev) * 1e-3
    b = torch.randn((32,), generator=g, device=dev) if with_bias else None
    return xq, wq, scale, b


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,with_bias", [
    ((1, 16, 64, 160), False), ((2, 5, 13, 37), True), ((1, 1, 1, 1), True),
    ((3, 3, 17, 15), False), ((2, 3, 2, 5), True), ((1, 4, 1, 200), False),   # small Y / X
    ((1, 70000, 2, 3), True)])     # B * Z above the 65535 a grid dimension holds
def test_int8_kernel_bit_equal_to_plain(dev, shape, with_bias, out_dtype):
    """The int8 K3 kernel and its plain version: the same exact integer sums
    and the same float32 epilogue rounded once, so equal bit for bit."""
    from rtpose_tpu_torch.ops import conv_k3_int8
    xq, wq, scale, b = _int8_case(dev, shape, with_bias)
    ops.reset_launch_counts()
    got = conv_k3_int8.conv3d_k3_int8(xq, wq, scale, b, out_dtype)
    torch.cuda.synchronize()
    assert ops.launch_counts()["conv3d_k3_int8"] == 1
    assert got.dtype == out_dtype
    assert torch.equal(got, conv_k3_int8.conv3d_k3_int8_reference(xq, wq, scale, b, out_dtype))


@pytest.mark.parametrize("shape", [(1, 16, 64, 160), (2, 5, 13, 37)])
def test_int8_kernel_every_plan_candidate(dev, shape):
    """Every tile the launch plan may choose (``candidates``, the chosen one
    among them) gives the plain version's result bit for bit, bf16 and
    float32 out."""
    from rtpose_tpu_torch.ops import conv_k3_int8
    xq, wq, scale, b = _int8_case(dev, shape, True, seed=9)
    wk = conv_k3_int8.prepare(wq)
    sms = build.sm_count(dev)
    found = conv_k3_int8.candidates(*shape, sms)
    assert conv_k3_int8.plan(*shape, sms) in [p for _, p in found]
    for out_dtype in (torch.bfloat16, torch.float32):
        want = conv_k3_int8.conv3d_k3_int8_reference(xq, wq, scale, b, out_dtype)
        for _, p in found:
            got = conv_k3_int8._run(xq, wk, scale, b, out_dtype, p)
            torch.cuda.synchronize()
            assert torch.equal(got, want), p


def test_int8_kernel_deterministic_and_equal_to_stock_route(dev):
    from rtpose_tpu_torch.ops import conv_k3_int8, quant
    xq, wq, scale, b = _int8_case(dev, (2, 16, 64, 160), True, seed=7)
    a = conv_k3_int8.conv3d_k3_int8(xq, wq, scale, b)
    assert torch.equal(a, conv_k3_int8.conv3d_k3_int8(xq, wq, scale, b))
    stock = quant.epilogue(quant.int8_conv_acc(xq, wq, 1), scale, b, torch.bfloat16)
    assert torch.equal(a, stock)
    with pytest.raises(ValueError):
        conv_k3_int8.conv3d_k3_int8(xq.float(), wq, scale, b)        # not int8
    with pytest.raises(ValueError):
        conv_k3_int8.conv3d_k3_int8(xq, wq, scale.double(), b)       # scale not float32


def test_int8_conv_layer_dispatch(dev):
    """``TorchConv3d`` under ``int8_mode`` on the card: the K3 shape launches
    the int8 kernel, a stride-2 conv takes ``torch._int_mm``; both equal the
    CPU plain route."""
    from rtpose_tpu_torch.models.layers import TorchConv3d
    from rtpose_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(8)
    for cin, stride, launched in ((32, 1, 1), (32, 2, 0)):
        m = TorchConv3d(cin, 32, stride=stride, bias=True, dtype="bfloat16")
        with torch.no_grad():
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.05)
            m.bias.copy_(torch.randn((32,), generator=g))
        m.site = "c"
        x = torch.randn((2, 4, 16, 24, cin), generator=g)
        with torch.inference_mode(), quant.int8_mode({"c": 0.02}):
            want = m(x)
        m.to(dev)
        ops.reset_launch_counts()
        with torch.inference_mode(), quant.int8_mode({"c": 0.02}):
            got = m(x.to(dev))
        torch.cuda.synchronize()
        assert ops.launch_counts()["conv3d_k3_int8"] == launched
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kernel", [1, 3])
def test_int8_stock_route_narrow_inputs(dev, kernel):
    """An int8 conv whose im2col width is no multiple of 8 (the LiDAR
    reader's 4 features into layer1: 4 and 108 columns) takes
    ``torch._int_mm`` on zero-padded columns: equal to the CPU plain route."""
    from rtpose_tpu_torch.models.layers import TorchConv3d
    from rtpose_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(9)
    m = TorchConv3d(4, 16, kernel=kernel, bias=True, dtype="bfloat16")
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.1)
        m.bias.copy_(torch.randn((16,), generator=g))
    m.site = "c"
    x = torch.randn((2, 4, 16, 24, 4), generator=g)
    with torch.inference_mode(), quant.int8_mode({"c": 0.02}):
        want = m(x)
    m.to(dev)
    with torch.inference_mode(), quant.int8_mode({"c": 0.02}):
        got = m(x.to(dev))
    assert torch.equal(got.cpu(), want)


def test_custom_ops_export_on_the_card(dev):
    """The serving export's ops on the card: a bf16 and an int8 block traced
    with ``torch.export`` call ``rtpose::conv3d_k3`` / ``conv3d_k3_int8``
    (their CUDA implementations launch the kernels and count), and the
    traced program equals the eager module; ``rtpose::preprocess`` equals
    its plain version."""
    import copy
    from rtpose_tpu_torch.models.layers import ResNetBlock, TorchConv3d
    from rtpose_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(9)
    block = ResNetBlock(32, 32, dtype="bfloat16")
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05 + (1.0 if p.dim() == 1 else 0.0))
    block.conv2.conv.site, block.conv3.conv.site = "c2", "c3"
    block = block.to(dev).eval()
    x = torch.randn((2, 8, 32, 80, 32), generator=g).to(dev)
    for scales, op, counter in ((None, "rtpose.conv3d_k3.default", "conv3d_k3"),
                                ({"c2": 0.03, "c3": 0.05}, "rtpose.conv3d_k3_int8.default",
                                 "conv3d_k3_int8")):
        m = copy.deepcopy(block)
        convs = [c for c in m.modules() if isinstance(c, TorchConv3d)]
        ctx = quant.int8_mode(scales) if scales else torch.no_grad()
        with torch.no_grad(), ctx:
            eager = copy.deepcopy(m)(x)
            m(x)
            for c in convs:
                c.freeze()
            ep = torch.export.export(m, (x,), strict=False)
        targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        assert targets.count(op) == 2
        ops.reset_launch_counts()
        with torch.no_grad():
            traced = ep.module()(x)
        torch.cuda.synchronize()
        assert ops.launch_counts()[counter] == 2
        assert torch.equal(traced, eager)
    raw = torch.rand((2, 32, 16, 64, 160), generator=g).half().to(dev)
    roi = [0, 15, 0, 63, 0, 159]
    assert torch.equal(torch.ops.rtpose.preprocess(raw, roi, 0.0, 10.0),
                       preprocess.preprocess_reference(raw, roi, 0.0, 10.0))


def test_int8_artifact_at_full_size_on_the_card(dev, tmp_path):
    """The flagship's B=8 int8 serving artifact (51 sites), exported, saved
    and loaded back on the card: its first call runs eagerly and launches
    the int8 K3 kernel 14 times, the GroupNorm kernel 48 and the resize
    kernel 13; its second is captured in a CUDA graph and replayed, its
    third replayed; every answer equals the in-process int8 forward's
    (``make_predict_fn`` under ``int8_mode``) within one bf16 ulp of the
    epilogue (scores and the peaks' keypoints); ``export.counts()`` counts
    each call and its frames, ``predict.graphs`` the eager call, the capture
    and the replay, and the Python site counters stay silent inside the
    loaded program."""
    from rtpose_tpu_torch import export
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.models import init_weights
    from rtpose_tpu_torch.ops import quant

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "cruw_pose", "hr3d_one_hm_doppler.py")
    asm = assemble(Config.fromfile(path))
    init_weights(asm.model, torch.Generator().manual_seed(5))
    asm.model.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(6)
    xs = [torch.randn((8, *asm.input_shape_zyxc), generator=g, device=dev).abs()
          for _ in range(3)]
    scales = export.calibrate_predict(asm, xs[:2])
    assert len(scales) == 51
    ep = export.export_predict(asm, batch_size=8, device="cuda", int8_scales=scales,
                               int8_exclude=quant.DEFAULT_EXCLUDE)
    out = str(tmp_path / "int8_b8.pt2")
    export.save_exported(out, ep)
    predict = export.load_predict(out)
    live = export.make_predict_fn(asm, int8_scales=scales)
    export.reset()
    for i, x in enumerate(xs):
        quant.reset()
        ops.reset_launch_counts()
        (kpts, scores, labels), = predict(x)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        assert set(quant.counts().values()) == {0}
        if i == 0:
            assert launches["conv3d_k3_int8"] == 14
            assert launches["group_norm"] == 48 and launches["resize_trilinear"] == 13
        elif i == 2:
            assert set(launches.values()) == {0}       # a replay passes no wrapper
        (want_k, want_s, want_l), = live(x)
        assert torch.equal(labels, want_l)
        torch.testing.assert_close(scores, want_s, rtol=2.0 ** -8, atol=0)
        torch.testing.assert_close(kpts, want_k, rtol=2.0 ** -8,
                                   atol=2.0 ** -8 * float(want_k.abs().max()))
    assert export.counts() == dict(predict_calls=3, frames=24, int8_sites=51)
    graphs = predict.graphs.counts()
    assert (graphs["eager"], graphs["captures"], graphs["replays"]) == (1, 1, 1)


@pytest.mark.parametrize("mask", [False, True])
def test_deform_conv_card_matches_cpu(dev, mask):
    """The deformable conv in float32 on the card against the CPU, forward
    and gradients: the same gathers and weights; the card's contraction and
    its scatter-add backward sum in other orders (atomics), so 1e-5 of the
    largest magnitude.  Two card runs of the backward are compared with the
    same tolerance, not bit for bit."""
    from rtpose_tpu_torch.ops.deform_conv import deform_conv2d

    g = torch.Generator().manual_seed(0)
    B, H, W, C, dg = 3, 12, 20, 16, 4
    x = torch.randn(B, H, W, C, generator=g)
    off = torch.rand(B, H, W, dg * 18, generator=g) * 6 - 3
    w = torch.randn(3, 3, C, 8, generator=g) / 12
    m = torch.rand(B, H, W, dg * 9, generator=g) if mask else None
    cot = torch.randn(B, H, W, 8, generator=g)

    def run(device):
        ts = [t.detach().to(device).requires_grad_() for t in (x, off, w)]
        tm = None if m is None else m.detach().to(device).requires_grad_()
        out = deform_conv2d(*ts, mask=tm, deformable_groups=dg)
        (out * cot.to(device)).sum().backward()
        grads = [t.grad for t in ts] + ([] if tm is None else [tm.grad])
        return [t.detach().cpu() for t in (out, *grads)]

    want = run(torch.device("cpu"))
    card = run(dev)
    for a, b in zip(card, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())
    for a, b in zip(run(dev), card):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())


def _deform_inputs(dev, B, H, W, C, Cout, dg, offsets, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g, device=dev).to(torch.bfloat16)
    if offsets == "conv":     # as the deformable head's 1x1 offset conv gives them
        off = x.float() @ (torch.randn(C, dg * 18, generator=g, device=dev) * 0.05)
    elif offsets == "edge":   # samples exactly on -1, H, W and half a pixel off them
        shape = (B, H, W, dg * 18)
        off = (torch.randint(-8, 9, shape, generator=g, device=dev)
               + 0.5 * torch.randint(0, 2, shape, generator=g, device=dev)).float()
    else:                     # uniform in +-offsets pixels (40: far outside the map)
        off = (torch.rand(B, H, W, dg * 18, generator=g, device=dev) * 2 - 1) * offsets
    w = (torch.randn(3, 3, C, Cout, generator=g, device=dev) / (9 * C) ** 0.5).to(torch.bfloat16)
    return x, off, w


def _plain_bf16(x, off, w, **kw):
    """The plain route on bf16 inputs (grad on: the kernel's predicate refuses it)."""
    from rtpose_tpu_torch.ops.deform_conv import deform_conv2d
    with torch.enable_grad():
        return deform_conv2d(x.detach().requires_grad_(), off, w, **kw).detach()


@pytest.mark.parametrize("offsets", ["conv", 6.0, "edge", 40.0])
@pytest.mark.parametrize("shape", [(4, 64, 160, 128, 128, 4), (3, 7, 11, 64, 128, 8),
                                   (1, 5, 6, 256, 256, 8)])
def test_deform_kernel_is_no_coarser_than_the_plain_route(dev, shape, offsets):
    """The deformable-conv kernel at a slice of the cell's shape, at a small
    odd one and at one with two steps a tap and two output-channel blocks,
    against the same function in float32 (the plain route on
    the bf16 inputs upcast, TF32 off): its max and mean absolute errors are
    no larger than the plain bf16 route's; it matches its own arithmetic in
    stock ops (``kernel_reference``) to one bf16 ulp plus 2e-3 of the output
    range (float32 sums in other orders, each rounded once); two launches
    are bit-equal."""
    from rtpose_tpu_torch.ops import deform_conv as dc

    B, H, W, C, Cout, dg = shape
    x, off, w = _deform_inputs(dev, B, H, W, C, Cout, dg, offsets)
    assert not torch.backends.cuda.matmul.allow_tf32
    dc.reset()
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = dc.deform_conv2d(x, off, w, deformable_groups=dg)
        again = dc.deform_conv2d(x, off, w, deformable_groups=dg)
        want = dc.deform_conv2d(x.float(), off, w.float(), deformable_groups=dg)
        mirror = dc.kernel_reference(x, off, w, 1, dg)
    plain = _plain_bf16(x, off, w, deformable_groups=dg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["deform_conv2d"] == 2
    assert dc.counts()["calls"] == 4
    assert torch.equal(got, again)
    eg, ep = (got.float() - want).abs(), (plain.float() - want).abs()
    assert eg.max() <= ep.max() and eg.mean() <= ep.mean()
    torch.testing.assert_close(got.float(), mirror.float(), rtol=2.0 ** -7,
                               atol=2e-3 * mirror.float().abs().max().item())


@pytest.mark.parametrize("case", ["kernel", "grad", "float32", "mask", "bias"])
def test_deform_conv_route_follows_the_inputs(dev, case):
    """One predicate on the inputs picks the route: a no-grad bf16 call
    without mask or bias takes the kernel; grad enabled (with an input that
    requires it), float32, a mask or a bias take the plain route.  The
    kernel's launches show which ran."""
    from rtpose_tpu_torch.ops import deform_conv as dc

    x, off, w = _deform_inputs(dev, 2, 5, 9, 64, 128, 2, 3.0)
    kw = dict(deformable_groups=2)
    if case == "float32":
        x, w = x.float(), w.float()
    elif case == "mask":
        kw["mask"] = torch.rand(2, 5, 9, 18, device=dev)
    elif case == "bias":
        kw["bias"] = torch.zeros(128, device=dev)
    elif case == "grad":
        x = x.requires_grad_()
    dc.reset()
    ops.reset_launch_counts()
    with torch.set_grad_enabled(case == "grad"):
        out = dc.deform_conv2d(x, off, w, **kw)
    torch.cuda.synchronize()
    fused = case == "kernel"
    assert ops.launch_counts()["deform_conv2d"] == int(fused)
    assert dc.counts()["chunks"] == int(not fused) and dc.counts()["calls"] == 1
    assert out.requires_grad == (case == "grad") and out.shape == (2, 5, 9, 128)


def test_multi_decode_card_matches_cpu(dev):
    """``decode_pose_multi`` on the card against the CPU: the same peaks in
    the same order (a plateau tie and zeros from underflowed sigmoids
    included), keypoints to 1e-5 m, scores to 1e-6 relative (the two
    devices' sigmoids may round one ulp apart)."""
    from rtpose_tpu_torch.core.decode import DecodeSpec, decode_pose_multi

    g = torch.Generator().manual_seed(1)
    hm = torch.randn(3, 16, 64, 160, 1, generator=g)
    hm[0, 3:5, 6:8, 10:12] = 9.0
    hm[1, 0, 0, 0] = 8.0
    hm[2] = -200.0
    hm[2, 4, 4, 4] = 3.0
    reg = torch.randn(3, 16, 64, 160, 45, generator=g)
    spec = DecodeSpec(grid_zyx=(16, 64, 160), pc_range_min_xyz=(0.77, -5.03, -1.09),
                      voxel_size_xyz=(0.0453125, 0.15703125, 0.3625))
    for P in (2, 6):
        kc, sc = decode_pose_multi(hm, reg, spec, P)
        kg, sg = decode_pose_multi(hm.to(dev), reg.to(dev), spec, P)
        torch.testing.assert_close(sg.cpu(), sc, rtol=1e-6, atol=0)
        torch.testing.assert_close(kg.cpu(), kc, rtol=0, atol=1e-5)


def _lidar_points(seed, n=2048, n_valid=1700):
    """A padded cloud in the shipped LiDAR config's range: people-like
    clusters, clutter, points out of range, padding rows past ``n_valid``."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([0.7703125, -5.025, -1.0875])
    hi = torch.tensor([8.0203125, 5.025, 4.7125])
    xyz = lo + torch.rand(n, 3, generator=g) * (hi - lo)
    xyz[:600] = torch.tensor([3.0, 0.5, 0.8]) + 0.3 * torch.randn(600, 3, generator=g)
    xyz[600:700] = xyz[600:700] * 1.6                   # some beyond the range
    pts = torch.cat([xyz, torch.rand(n, 1, generator=g)], 1)
    pts[n_valid:] = 0.0
    return pts, n_valid


@pytest.mark.parametrize("seed", [0, 1])
def test_voxelize_card_matches_cpu(dev, seed):
    """``ops.voxelize`` at the shipped LiDAR config's spec on the card and on
    the CPU: every output equal, ``voxels`` bit for bit."""
    from rtpose_tpu_torch.ops.voxelize import VoxelizerSpec, voxelize

    spec = VoxelizerSpec((0.7703125, -5.025, -1.0875, 8.0203125, 5.025, 4.7125),
                         (0.0453125, 0.15703125, 0.3625), max_points=8, max_voxels=1024)
    pts, n = _lidar_points(seed)
    want = voxelize(pts, n, spec)
    got = voxelize(pts.to(dev), n, spec)
    assert int(want["num_voxels"]) > 0
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def _lidar_models(dev):
    import copy

    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data.pipelines import Voxelization
    from rtpose_tpu_torch.models import build_detector, init_weights

    cfg = Config.fromfile(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "lidar", "voxelnet_pose.py"))
    asm = assemble(cfg)
    init_weights(asm.model, torch.Generator().manual_seed(0))
    model_cfg = copy.deepcopy(dict(cfg.model))
    model_cfg["backbone"]["dtype"] = "float32"
    model_cfg["pose_head"]["dtype"] = "float32"
    cpu = build_detector(model_cfg)
    cpu.load_state_dict(asm.model.state_dict())
    stage = Voxelization(cfg=cfg.voxelization["cfg"])
    pts, n = _lidar_points(2)
    item = stage({"points": pts[:n].numpy(), "mode": "test"})
    batch = {"voxels": item["voxels"], "num_points_per_voxel": item["num_points_per_voxel"],
             "coors": item["coordinates"], "num_voxels": item["num_voxels"]}
    batch = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
    return asm.model.to(dev).eval(), cpu.eval(), batch


def test_voxelnet_frame_card_matches_cpu_and_launches_k3(dev):
    """One frame through the shipped LiDAR config's VoxelNet on the card
    (bf16, the kernels) against the CPU in float32, seeded weights: logits
    within 5 % of their range and the regression within 5 % of its largest
    magnitude over the whole volume (``chip_smoke.py``'s ``E2E_FRAC``); the
    forward launches the conv kernel at its six 32 -> 32 convs (stages 2-4,
    the half-resolution branch), the GroupNorm kernel at its 48 GroupNorms,
    the resize kernel at its 13 resizes, and no other kernel."""
    gpu, cpu, batch = _lidar_models(dev)
    with torch.inference_mode():
        want = cpu(batch)[0]
        ops.reset_launch_counts()
        got = gpu({k: v.to(dev) for k, v in batch.items()})[0]
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts == {"preprocess": 0, "preprocess_single": 0, "conv3d_k3": 6,
                      "conv3d_k3_bwd": 0, "conv3d_k3_int8": 0, "deform_conv2d": 0,
                      "group_norm": 48, "resize_trilinear": 13}
    span = (want["hm"].max() - want["hm"].min()).item()
    torch.testing.assert_close(got["hm"].float().cpu(), want["hm"], rtol=0, atol=0.05 * span)
    reg_max = want["reg"].abs().max().item()
    torch.testing.assert_close(got["reg"].float().cpu(), want["reg"], rtol=0,
                               atol=0.05 * reg_max)


@pytest.mark.parametrize("seed", [0, 1])
def test_box_geometry_card_matches_cpu(dev, seed):
    """``boxes_iou3d`` / ``boxes_iou_bev`` within 1e-5 of the CPU's, and
    ``rotate_nms`` / ``circle_nms`` keep lists equal, on seeded boxes with
    ties in the scores; ``assign_roi_targets`` labels equal."""
    import numpy as np
    from rtpose_tpu_torch.models import assign_roi_targets
    from rtpose_tpu_torch.ops import nms

    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(-4, 4, (200, 3)), rng.uniform(0.4, 2.0, (200, 3)),
                            rng.uniform(-np.pi, np.pi, (200, 1))], 1).astype(np.float32)
    scores = rng.random(200).astype(np.float32)
    scores[10:20] = scores[0]
    b_c, s_c = torch.from_numpy(boxes), torch.from_numpy(scores)
    b_g, s_g = b_c.to(dev), s_c.to(dev)
    for fn in (nms.boxes_iou3d, nms.boxes_iou_bev):
        torch.testing.assert_close(fn(b_g, b_g[:50]).cpu(), fn(b_c, b_c[:50]), rtol=0, atol=1e-5)
    for kw in (dict(thresh=0.1), dict(thresh=0.3, pre_max_size=120)):
        got = nms.rotate_nms(b_g, s_g, post_max_size=64, **kw)
        want = nms.rotate_nms(b_c, s_c, post_max_size=64, **kw)
        assert got[0].cpu().tolist() == want[0].tolist() and int(got[1]) == int(want[1])
    dets = torch.cat([b_c[:, :2], s_c[:, None]], 1)
    got, want = nms.circle_nms(dets.to(dev), 0.8), nms.circle_nms(dets, 0.8)
    assert got[0].cpu().tolist() == want[0].tolist()
    t_g = assign_roi_targets(b_g[:64], s_g[:64], b_g[100:110], 8)
    t_c = assign_roi_targets(b_c[:64], s_c[:64], b_c[100:110], 8)
    assert torch.equal(t_g["labels"].cpu(), t_c["labels"])


@pytest.mark.parametrize("shape", [(1, 16, 64, 160), (2, 5, 13, 37)])
def test_flop_count_sees_each_kernel_launch(dev, shape):
    """``utils.flops.estimate_flops`` of one K3 forward, one K3 grad-input
    and one int8 kernel launch is 2 B Z Y X 32 32 27, and each kernel still
    launches once (through its custom op, under the counter)."""
    from rtpose_tpu_torch.ops import conv_k3_int8
    from rtpose_tpu_torch.utils.flops import estimate_flops

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((*shape, 32), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((32, 32, 3, 3, 3), generator=g, device=dev) * 0.05
    xq = torch.randint(-127, 128, (*shape, 32), generator=g, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (32, 32, 3, 3, 3), generator=g, device=dev,
                       dtype=torch.int8)
    scale = torch.full((32,), 1e-3, device=dev)
    want = 2 * shape[0] * shape[1] * shape[2] * shape[3] * 32 * 32 * 27
    cases = [("conv3d_k3", lambda: conv_k3.conv3d_k3(x, w)),
             ("conv3d_k3_bwd", lambda: conv_k3.grad_input(x, w)),
             ("conv3d_k3_int8", lambda: conv_k3_int8.conv3d_k3_int8(xq, wq, scale))]
    for name, fn in cases:
        ops.reset_launch_counts()
        assert estimate_flops(fn) == want, name
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts[name] == 1 and sum(counts.values()) == 1, (name, counts)


def test_span_encloses_its_kernel_on_the_profilers_clock(dev):
    """A host span around a spin kernel and the wait for it encloses the
    kernel's device interval in a CUDA-only ``torch.profiler`` trace, to
    within 50 us: the spans and the device trace share one clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rtpose_tpu_torch.utils import trace

    torch.cuda._sleep(1000)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace.enable()
        try:
            for _ in range(3):
                with trace.span("spin"):
                    torch.cuda._sleep(2_000_000)       # about a millisecond
                    torch.cuda.synchronize(dev)
        finally:
            trace.disable()
            spans = trace.take()
    kernels = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA and "spin_kernel" in e.name())
    assert len(spans) == len(kernels) == 3
    for (_, _, t0, t1), (k0, k1) in zip(sorted(spans, key=lambda s: s[2]), kernels):
        print(f"span starts {(k0 - t0) / 1e3:.1f} us before its kernel, "
              f"ends {(t1 - k1) / 1e3:.1f} us after it")
        assert t0 <= k0 + 50_000 and k1 <= t1 + 50_000


def test_profiler_sees_each_replays_kernels(dev):
    """``torch.profiler`` over three replays records ``3 x
    launches_per_replay`` launches of the K3 and the preprocess kernel, by
    name (what the benchmark's roofline readers count), and the wrappers
    count none of them.  A trace taken after an earlier one in the process
    can lose its first device operations (``benchmark/harness/trace.py``),
    so spin kernels go first and the test needs more than half of them
    kept; it runs last in this file, after the span test's trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, step, raw = _small_eval(dev)
    b = {"rdr_raw": raw(1, 0)}
    ops.reset_launch_counts()
    step(b)
    step(b)
    per = step.launches_per_replay
    assert per["conv3d_k3"] > 0 and per["preprocess"] == 1
    assert ops.launch_counts() == {k: 3 * v for k, v in per.items()}   # eager, warm-up, capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(64):
            torch.cuda._sleep(1000)
        for _ in range(3):
            step(b)
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("spin_kernel" in n for n in names) > 32
    assert step.replays == 3
    assert sum("conv3d_k3_kernel" in n and "int8" not in n for n in names) \
        == 3 * per["conv3d_k3"]
    assert sum("preprocess_kernel" in n for n in names) == 3 * per["preprocess"]
    assert ops.launch_counts() == {k: 3 * v for k, v in per.items()}
