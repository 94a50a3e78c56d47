"""The loop of a training cell: the program's ``tools.train --device_cache
--device_preprocess`` path in a closed loop of steps.

Set-up builds, as ``rtpose_tpu_torch.tools.train`` does, one
``DeviceCachedLoader`` over the seeded frames, the clipped one-cycle Adam,
``make_train_step``'s step and one ``Trainer`` with the hooks that CLI
registers, with two left out: checkpoints (their interval is never
reached) and the TensorBoard writer (``torch.utils.tensorboard`` loads
TensorFlow, which can load JAX, and both only write logs to disk).  One call of
``Trainer.run`` then drives everything: the first ``warm_steps`` steps are
set-up (the first builds and warms every kernel; the first ``check_steps``
are the ones the reference follows), and the window opens at the next
step boundary and closes at the first step boundary after ``--seconds``
(the loader raises ``WindowClosed``), both edges behind a
``torch.cuda.synchronize()``.

After the window the program is freed and the plain float32 reference
(``benchmark/reference``) follows the same three batches from the same
weights on the card, one sample at a time.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import check, counts, data
from benchmark.harness.dist import Ranks
from benchmark.harness.trace import Schedule
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train


class WindowClosed(Exception):
    pass


class WindowLoader:
    """The device cache's loader, opening and closing the window at step
    boundaries and keeping the metas of the checked steps' batches.  While
    ``hold()`` is true (a traced stretch not finished yet) the window stays
    open past ``seconds``."""

    device_resident = True

    def __init__(self, inner, warm: int, check_steps: int, seconds: float, device,
                 ranks: Ranks, hold=lambda: False):
        self.inner, self.warm, self.check_steps = inner, warm, check_steps
        self.hold = hold
        self.seconds, self.device, self.ranks = seconds, device, ranks
        self.served = 0
        self.metas: List[list] = []
        self.t0 = self.t1 = None
        self.steps = 0

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def __len__(self):
        return len(self.inner)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __iter__(self):
        for batch in self.inner:
            k = self.served
            if k == self.warm:
                self._sync()
                self.ranks.barrier()
                self.t0 = time.perf_counter()
            elif k > self.warm and self.ranks.any(
                    time.perf_counter() - self.t0 >= self.seconds and not self.hold()):
                self._sync()
                self.t1 = time.perf_counter()
                self.steps = k - self.warm
                raise WindowClosed()
            if k < self.check_steps:
                self.metas.append([int(m["frame"]) for m in batch["meta"]])
            self.served += 1
            yield batch


class Stepper:
    """The train step as the trainer calls it, keeping what the check
    reads (device tensors, read after the window) and starting and
    stopping the trace at stated steps."""

    def __init__(self, step, optimizer, params, check_steps: int,
                 schedule: Optional[Schedule]):
        self.step, self.optimizer, self.params = step, optimizer, params
        self.check_steps, self.schedule = check_steps, schedule
        self.calls = 0
        self.losses: List[torch.Tensor] = []
        self.skipped: List[torch.Tensor] = []
        self.mu0 = None
        self.after = None

    def __call__(self, state, batch):
        k = self.calls
        if self.schedule is not None:
            self.schedule.before_call(k)
        state, m = self.step(state, batch)
        self.calls += 1
        self.skipped.append(m["skipped"])
        if k < self.check_steps:
            self.losses.append(m["loss"].detach().clone())
        if k == 0:
            self.mu0 = self.optimizer.mu.detach().clone()
        if k == self.check_steps - 1:
            self.after = [p.detach().clone() for p in self.params]
        return state, m


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device, ranks: Ranks,
        extra: tuple = ()) -> Dict:
    from rtpose_tpu_torch.api import assemble
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import DeviceCachedLoader
    from rtpose_tpu_torch.engine import (Trainer, create_train_state, get_root_logger,
                                         make_train_step)
    from rtpose_tpu_torch.solver import build_optimizer_from_cfg, make_one_cycle_fns
    from rtpose_tpu_torch.tools.train import device_cache_cap

    cfg, tr = cell.cfg, cell.traffic
    B = int(tr["batch_per_rank"])
    warm, n_check = int(tr["warm_steps"]), int(tr["check_steps"])
    weights = data.make_weights(cfg, seed, device)
    frames_dev = data.make_frames(cfg, tr, seed, device)
    host = data.to_host(frames_dev)
    del frames_dev
    dataset = data.HostFrames(host)

    pcfg = Config(cell.cfg)
    asm = assemble(pcfg)
    model = asm.model.to(device)
    model.load_state_dict(weights)
    del weights
    raw = dataset.key == "raw"
    ds_cfg = cfg["DATASET"]["DZYX" if raw else "RDR_CUBE"]["NORMALIZING_VALUE"]
    preprocess = (float(ds_cfg[0]), float(ds_cfg[1]) - float(ds_cfg[0])) if raw else None
    loader = DeviceCachedLoader(dataset, batch_size=B, device=device, shuffle=True, seed=seed,
                                max_bytes=device_cache_cap(device), num_shards=ranks.world,
                                shard_id=ranks.rank)
    total_epochs = int(cfg["total_epochs"])
    total_steps = len(loader) * total_epochs
    lr = cfg["lr_config"]
    lr_fn, _ = make_one_cycle_fns(total_steps, float(lr["lr_max"]), tuple(lr["moms"]),
                                  float(lr["div_factor"]), float(lr["pct_start"]))
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    optimizer = build_optimizer_from_cfg(pcfg, params, total_steps)
    state = create_train_state(model, optimizer)
    from rtpose_tpu_torch import parallel
    parallel.broadcast_state(model, optimizer)
    step = make_train_step(model, asm.head, asm.target_spec, optimizer, lr_fn=lr_fn,
                           input_key=asm.input_key, sparse_reg=asm.sparse_head,
                           preprocess=preprocess)
    sched = Schedule(device, tr["trace"], offset=warm) if trace else None
    stepper = Stepper(step, optimizer, params, n_check, sched)
    wl = WindowLoader(loader, warm, n_check, seconds, device, ranks,
                      hold=lambda: trace and not sched.done)
    work = tempfile.mkdtemp(prefix="bench_train_")
    log_cfg = cfg["log_config"]
    logger = get_root_logger(cfg.get("log_level", "INFO"),
                             work_dir=work if ranks.rank == 0 else None)
    trainer = Trainer(stepper, state, work_dir=work, total_epochs=total_epochs, device=device,
                      lr_fn=lr_fn, enable_tensorboard=False,
                      log_interval=int(log_cfg.get("interval", 20)),
                      checkpoint_interval=10 ** 9, meta=dict(config="benchmark"),
                      logger=logger)
    try:
        trainer.run(wl, None, workflow=[("train", 1)])
        raise RuntimeError("the training loop ended before the window closed")
    except WindowClosed:
        pass
    finally:
        if sched is not None:
            sched.close()
        for h in list(logger.handlers):
            if h.__class__.__name__ == "FileHandler":
                logger.removeHandler(h)
                h.close()
        shutil.rmtree(work, ignore_errors=True)
    window_s = wl.t1 - wl.t0
    out: Dict = {"units": wl.steps, "window_s": window_s,
                 "rate": wl.steps * B * ranks.world / window_s,
                 "setup_end": wl.t0}
    if device.type == "cuda":
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    skipped = stepper.skipped[warm:warm + wl.steps]
    out["failed"] = int(torch.stack(skipped).sum()) if skipped else 0
    if trace:
        if sched.trace is None:
            raise RuntimeError("the window closed before the traced steps ended")
        out["trace"] = sched.trace
    if wl.steps < 1:
        raise RuntimeError("no step completed in the window")

    # what the check reads, to the host, then the program is freed
    prog_losses = [float(x) for x in torch.stack(stepper.losses).cpu()]
    sizes = optimizer.sizes
    b1 = ref_train.one_cycle(0, total_steps, ref_train.Spec(cfg))[1]
    prog_grad = {n: g.view_as(p).cpu() / (1.0 - b1)
                 for n, g, p in zip(names, torch.split(stepper.mu0, sizes), params)}
    prog_after = {n: t.cpu() for n, t in zip(names, stepper.after)}
    metas = [m for per_rank in ranks.gather(wl.metas) for m in per_rank]   # rank-major
    del trainer, stepper, state, optimizer, step, loader, model, asm, params, wl
    _free(device)
    if ranks.rank != 0:
        return out
    rows = [[r for rank_rows in metas[s::n_check] for r in rank_rows] for s in range(n_check)]
    ref_total = (len(dataset) // ranks.world // B) * total_epochs
    out["numbers"], out["extra"] = reference_check(cell, seed, device, host, rows, ref_total,
                                                   preprocess, prog_losses, prog_grad,
                                                   prog_after, extra)
    return out


def worst_leaves(names, prog, ref, top=6):
    """The leaves with the widest gaps: (name, gap, program norm,
    reference norm, elements)."""
    gaps = check.leaf_gaps(prog, ref)
    pn, rn = check._norms(prog), check._norms(ref)
    idx = sorted(range(len(names)), key=lambda i: -gaps[i])[:top]
    return [(names[i], gaps[i], pn[i], rn[i], int(ref[i].numel())) for i in idx]


def reference_check(cell, seed, device, host, rows, total_steps, preprocess, prog_losses,
                    prog_grad, prog_after, extra=()):
    """The reference over the checked batches; the program's numbers, and
    those of each ``extra`` stand-in ('control': the reference in float8;
    'half_batch': the reference leaving half of each batch out)."""
    cfg = cell.cfg
    spec = ref_train.Spec(cfg)
    key = "raw" if "raw" in host else "tensor"
    batches = [{"cube": host[key][r].to(device), "poses": host["poses"][r].to(device)}
               for r in rows]
    pre = None
    if preprocess is not None:
        from benchmark.reference.evaluate import preprocess as ref_pre
        n0, n1 = preprocess

        def pre(raw):
            return ref_pre(raw, n0, n1)

    def follow(fp8=False, drop_half=False):
        net = ref_model.load(ref_model.build(cfg["model"], counts.in_channels(cfg), device),
                             data.make_weights(cfg, seed, device))
        init = {n: p.detach().clone() for n, p in net.named_parameters()}
        ref_model.Conv.fp8 = fp8
        try:
            losses, grad, after = ref_train.train_steps(net, batches, spec, total_steps, pre,
                                                        drop_half=drop_half)
        finally:
            ref_model.Conv.fp8 = False
        names = [n for n, _ in net.named_parameters()]
        return (losses, dict(zip(names, [g.cpu() for g in grad])),
                {n: (a - init[n]).cpu() for n, a in zip(names, after)}, init)

    ref_losses, ref_grad, ref_change, init = follow()
    order = sorted(ref_grad)
    init = {n: t.cpu() for n, t in init.items()}

    def numbers(losses, grad, change):
        return check.train_numbers(losses, ref_losses, [grad[n] for n in order],
                                   [ref_grad[n] for n in order], [change[n] for n in order],
                                   [ref_change[n] for n in order])

    prog_change = {n: prog_after[n] - init[n] for n in order}
    main = numbers(prog_losses, prog_grad, prog_change)
    readings = {}
    if "detail" in extra:
        readings["detail"] = {
            "losses": [prog_losses, ref_losses],
            "grad": worst_leaves(order, [prog_grad[n] for n in order],
                                 [ref_grad[n] for n in order]),
            "change": worst_leaves(order, [prog_change[n] for n in order],
                                   [ref_change[n] for n in order])}
    for name in extra:
        if name in ("control", "half_batch"):
            losses, grad, change, _ = follow(fp8=name == "control",
                                             drop_half=name == "half_batch")
            readings[name] = numbers(losses, grad, change)
    _free(device)
    return main, readings
