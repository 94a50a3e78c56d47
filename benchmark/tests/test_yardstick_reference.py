"""The plain reference against the port at a tiny grid on the CPU, with
the configuration computing in float32 (so both sides should agree to
rounding): the eval forward and decode, and one train step."""

import copy

import pytest
import torch

from benchmark.harness import counts, data
from benchmark.reference import evaluate as ref_eval
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.tests.tiny import tiny

pytest.importorskip("rtpose_tpu_torch")
CELL = "hrradarpose_doppler.train_b8"


def f32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["model"]["backbone"]["dtype"] = "float32"
    cfg["model"]["pose_head"]["dtype"] = "float32"
    return cfg


def both(cfg, seed):
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    w = data.make_weights(cfg, seed, "cpu")
    asm = assemble(Config(cfg))
    asm.model.load_state_dict(w)
    ref = ref_model.load(ref_model.build(cfg["model"], counts.in_channels(cfg)), w)
    return asm, ref


def test_state_dict_names_match_the_port():
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    for name in (CELL,):
        cfg = tiny(name).cfg
        port = {k: tuple(v.shape) for k, v in assemble(Config(cfg)).model.state_dict().items()}
        w = data.make_weights(cfg, 0, "cpu")
        assert port == {k: tuple(v.shape) for k, v in w.items()}


def test_eval_agrees():
    from rtpose_tpu_torch.engine import make_eval_step
    cell = tiny("hrradarpose_doppler.eval_b1")
    cfg = f32(cell.cfg)
    asm, ref = both(cfg, 5)
    frames = data.make_frames(cfg, cell.traffic, 5, "cpu")
    step = make_eval_step(asm.model, asm.decode_spec, sparse=True, preprocess=(0.0, 10.0))
    spec = ref_train.Spec(cfg)
    for i in range(3):
        kpts, scores, _ = step({"rdr_raw": frames["raw"][i:i + 1]})[0]
        cand = ref_eval.candidates(ref, ref_eval.preprocess(frames["raw"][i], 0.0, 10.0), spec)
        j = ref_eval.judge(cand, kpts[0], float(scores[0, 0]), spec.vsize)
        assert j["peak_gap"] == 0.0
        assert j["kpt_gap"] < 1e-3 and j["score_gap"] < 1e-5


def test_one_train_step_agrees():
    from rtpose_tpu_torch.engine import create_train_state, make_train_step
    from rtpose_tpu_torch.solver import build_optimizer_from_cfg, make_one_cycle_fns
    from rtpose_tpu_torch.config import Config
    cell = tiny(CELL)
    cfg = f32(cell.cfg)
    asm, ref = both(cfg, 9)
    frames = data.make_frames(cfg, cell.traffic, 9, "cpu")
    total = 400
    lr = cfg["lr_config"]
    lr_fn, _ = make_one_cycle_fns(total, lr["lr_max"], tuple(lr["moms"]), lr["div_factor"],
                                  lr["pct_start"])
    model = asm.model
    opt = build_optimizer_from_cfg(Config(cfg), list(model.parameters()), total)
    step = make_train_step(model, asm.head, asm.target_spec, opt, lr_fn=lr_fn, sparse_reg=True,
                           preprocess=(0.0, 10.0))
    state = create_train_state(model, opt)
    rows = [0, 3]
    batch = {"rdr_raw": frames["raw"][rows], "poses": frames["poses"][rows][:, None],
             "num_poses": torch.ones(2, dtype=torch.int32)}
    _, m = step(state, batch)
    spec = ref_train.Spec(cfg)
    losses, grad, after = ref_train.train_steps(
        ref, [{"cube": frames["raw"][rows], "poses": frames["poses"][rows]}], spec, total,
        preprocess=lambda r: ref_eval.preprocess(r, 0.0, 10.0))
    assert float(m["loss"]) == pytest.approx(losses[0], rel=1e-4)
    b1 = ref_train.one_cycle(0, total, spec)[1]
    names = [n for n, _ in model.named_parameters()]
    prog_grad = dict(zip(names, torch.split(opt.mu / (1 - b1), opt.sizes)))
    ref_names = [n for n, _ in ref.named_parameters()]
    for n, g in zip(ref_names, grad):
        diff = torch.linalg.vector_norm(prog_grad[n].view_as(g) - g)
        assert diff <= 1e-3 * torch.linalg.vector_norm(g) + 1e-7, n
    # Adam moves an element by about lr whatever its gradient's size, so an
    # element whose gradient is at the rounding level can move either way:
    # the updates agree by norm, leaf by leaf
    prog_after = dict(model.named_parameters())
    init = data.make_weights(cfg, 9, "cpu")
    worst = 0.0
    for n, a in zip(ref_names, after):
        ref_d, prog_d = a - init[n], prog_after[n].detach() - init[n]
        worst = max(worst, float(torch.linalg.vector_norm(prog_d - ref_d)
                                 / torch.linalg.vector_norm(ref_d)))
    assert worst < 0.05
