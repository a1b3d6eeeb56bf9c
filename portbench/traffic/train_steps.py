"""Training: the port's GAN step (deepsee_torch/train/steps.py::
make_train_step, one G update and one D update, with train/state.py's TTUR
Adam) on resident batches, as a trainer with its data on the card runs it.

Parameters (the traffic mix's file): `batch`, `pool` (distinct seeded
batches resident on the card, cycled; a guided model's carry guiding
images), `check_steps` (the first steps, run in set-up, which the
reference follows).

Set-up builds the training state once (create_train_state over the
seeded weights; the coin and noise generators seeded from the run's seed),
runs the first `check_steps` steps on distinct batches through the same
step function, and hands that same state to the window.  It reads, after
the first step, the first gradient of every leaf as each optimizer holds
it (Adam's first moment over 1 - beta1) and, after the last, every leaf's
change from the initial weights.  The window runs steps for `seconds` and
ends in torch.cuda.synchronize().  End-to-end: `train_img_per_s`, the
samples of every step over the window's length.

Output check, against `reference.train.TrainReference` (float32, TF32
off) from the same weights, batches and seeds: `loss_gap`, the worst of
the first steps' relative gaps of the G and D totals; `grad_gap`, the worst
leaf's gap between the program's and the reference's first-gradient norms
over the larger of that leaf's and the median leaf's reference norm;
`change_gap`, the same of the change after the first steps, over the
leaves whose reference gradient exceeds a thousandth of the median leaf's;
`fake_mse`, the worst image's mean squared error of the fakes the first
steps' G updates made (kept from SRSystem.train_generate's first call of
each step).  The norms and the losses sum over many values, so rounding
noise of any precision barely moves them while a step that drops rows or
leaves its state unchanged does; the fakes are what a lower precision
moves.
"""

from __future__ import annotations

import time
import warnings
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from portbench import harness, work
from portbench.reference import nets
from portbench.reference import train as ref_train

TRAIN = True



def leaf_keys(system) -> Dict[int, tuple]:
    nets_ = {"g": system.generator, "e": system.encoder, "d": system.discriminator}
    return {id(p): (net, name) for net, m in nets_.items() if m is not None
            for name, p in m.named_parameters()}


def first_grad_norms(state, keys: Dict[int, tuple]) -> Dict[tuple, float]:
    """Each leaf's first gradient as its Adam holds it after one step (0
    where the optimizer holds none)."""
    out = {}
    for opt in (state.opt_g, state.opt_d):
        beta1 = opt.param_groups[0]["betas"][0]
        for group in opt.param_groups:
            for p in group["params"]:
                m = opt.state.get(p, {}).get("exp_avg")
                out[keys[id(p)]] = 0.0 if m is None else float(m.norm()) / (1 - beta1)
    return out


def change_norms(system, weights, keys: Dict[int, tuple]) -> Dict[tuple, float]:
    out = {}
    for net in (system.generator, system.encoder, system.discriminator):
        for p in net.parameters():
            k = keys[id(p)]
            out[k] = float((p.detach() - weights[k[0]][k[1]]).norm())
    return out


def count_work(cfg: Dict, train_cfg: Dict, batch: int) -> SimpleNamespace:
    """Operations of one step over the reference on the meta device
    (forward and backward, the D update's regeneration included)."""
    spec = nets.param_spec(cfg, train=True)
    meta = {net: {n: torch.empty(s, device="meta") for n, s in tensors.items()}
            for net, tensors in spec.items()}
    size = cfg["crop_size"]
    host = {"image_hr": torch.empty(batch, size, size, 3, device="meta"),
            "label": torch.zeros(batch, size, size, dtype=torch.int32, device="meta")}
    if nets.guided(cfg):
        host["guiding_image"] = torch.empty(batch, size, size, 3, device="meta")
        host["guiding_label"] = torch.zeros(batch, size, size, dtype=torch.int32, device="meta")
    ref = ref_train.TrainReference(cfg, train_cfg, meta, "meta", 0, zeros=True,
                                   checkpoint_blocks=False)
    return SimpleNamespace(bf16_flops=work.count_flops(lambda: ref.step(host)), int8_ops=0.0)


def _logs_flag(logs) -> torch.Tensor:
    return torch.isfinite(torch.stack([v.float() for v in logs.values()])).all()


def setup(ctx) -> None:
    from deepsee_torch.train.state import create_train_state
    from deepsee_torch.train.steps import make_train_step

    t = ctx.cell.traffic
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "random VGG19 features": the benchmark's weights
        ctx.state = create_train_state(ctx.system, init=False)
    ctx.pool = harness.make_pool(ctx)
    ctx.step = make_train_step(ctx.system)
    keys = leaf_keys(ctx.system)
    t1 = time.perf_counter()
    ctx.first_logs, ctx.first_fakes = [], []
    real_generate = ctx.system.train_generate

    def keep_fake(*args, **kwargs):
        fake = real_generate(*args, **kwargs)
        if torch.is_grad_enabled():       # the G update's; the D update's runs without
            ctx.first_fakes.append(fake.detach().float().cpu())
        return fake

    ctx.system.train_generate = keep_fake
    for i in range(t["check_steps"]):
        logs = ctx.step(ctx.state, ctx.pool[i % len(ctx.pool)])
        ctx.first_logs.append({k: float(v) for k, v in logs.items()})
        if i == 0:
            ctx.first_grads = first_grad_norms(ctx.state, keys)
    ctx.system.train_generate = real_generate
    ctx.changes = change_norms(ctx.system, ctx.weights, keys)
    t2 = time.perf_counter()
    ctx.work = count_work(ctx.cfg, vars(ctx.exp.train), t["batch"])
    ctx.setup_notes = (f"traffic set-up: state and inputs {t1 - t0!r} s, the first "
                       f"{t['check_steps']} steps {t2 - t1!r} s, operations counted "
                       f"{time.perf_counter() - t2!r} s")


class _Ranges:
    """The benchmark's host ranges and optimizer events in a traced step."""

    def __init__(self, tracer, cuda: bool):
        self.tracer, self.cuda = tracer, cuda
        self.open = None
        self.opt_ms_events = []

    def enter(self, name: str) -> None:
        if self.tracer.on:
            self.open = self.tracer.range(name)
            self.open.__enter__()

    def leave(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def wrap(self, opt, after: Optional[str]) -> None:
        real = opt.step

        def step(*args, **kwargs):
            with self.tracer.range("optimizer"):
                e0 = torch.cuda.Event(enable_timing=True) if self.cuda else None
                if e0 is not None:
                    e0.record()
                out = real(*args, **kwargs)
                if e0 is not None:
                    e1 = torch.cuda.Event(enable_timing=True)
                    e1.record()
                    self.opt_ms_events.append((e0, e1))
            if after is not None:
                self.leave()
                self.enter(after)
            return out

        opt.step = step


def window(ctx, seconds: float, tracer, max_steps: Optional[int] = None) -> SimpleNamespace:
    t = ctx.cell.traffic
    cuda = ctx.device.type == "cuda"
    ranges = _Ranges(tracer, cuda)
    if tracer.on:
        ranges.wrap(ctx.state.opt_g, "d_update")
        ranges.wrap(ctx.state.opt_d, None)
    flags = []
    failed, steps, notes = 0, 0, []
    pool_n = len(ctx.pool)
    with tracer, tracer.range("window"):
        harness.sync(ctx.device)
        start = time.perf_counter()
        end = start + seconds
        try:
            while time.perf_counter() < end and (max_steps is None or steps < max_steps):
                with tracer.range("step"):
                    ranges.enter("g_update")
                    logs = ctx.step(ctx.state, ctx.pool[(t["check_steps"] + steps) % pool_n])
                    ranges.leave()
                flags.append(_logs_flag(logs))
                steps += 1
        except RuntimeError as err:       # a step that raises fails the run
            failed += 1
            notes.append(f"step {steps} raised: {err!r}")
        harness.sync(ctx.device)
        stop = time.perf_counter()
    if flags:
        failed += int((~torch.stack(flags)).sum())
    opt_ms = [a.elapsed_time(b) for a, b in ranges.opt_ms_events]
    per_step = [opt_ms[i] + opt_ms[i + 1] for i in range(0, len(opt_ms) - 1, 2)]
    record = SimpleNamespace(units=steps, batch=t["batch"], work=ctx.work, optimizer_ms=per_step,
                             elt_bytes=2 if ctx.cfg["compute_dtype"] == "bfloat16" else 4)
    notes.append(f"train: {steps} steps in {stop - start!r} s")
    return SimpleNamespace(attempted=steps, failed=failed, notes=notes, record=record,
                           end_to_end={"train_img_per_s": steps * t["batch"] / (stop - start)})



def reference_readings(ctx, q=None, batch_rows: Optional[int] = None) -> SimpleNamespace:
    """The reference's first steps from the same weights, batches and
    seeds: losses, first-gradient norms, change norms.  `q`: a lower
    precision put in the program's place; `batch_rows`: the step on that
    many rows of each batch (a planted fault)."""
    t = ctx.cell.traffic
    ref = ref_train.TrainReference(ctx.cfg, vars(ctx.exp.train), ctx.weights, ctx.device,
                                   ctx.exp.train.seed, q=q)
    initial = {k: v.clone() for k, v in ref.leaves().items()}
    losses, grads, fakes = [], None, []
    with harness.strict_float32():
        for i in range(t["check_steps"]):
            batch = ctx.pool[i % len(ctx.pool)]
            if batch_rows is not None:
                batch = {k: v[:batch_rows] for k, v in batch.items()}
            logs, g = ref.step(batch)
            losses.append({k: float(v) for k, v in logs.items()})
            fakes.append(ref.last_fake)
            if i == 0:
                grads = {k: float(v.norm()) for k, v in g.items()}
            del g
    changes = {k: float((v - initial[k]).norm()) for k, v in ref.leaves().items()}
    return SimpleNamespace(losses=losses, grads=grads, changes=changes, fakes=fakes)


def fake_mse(fakes, ref_fakes) -> float:
    """The worst image's mean squared error over the steps' fakes (a fake
    with fewer rows, as a planted fault makes, is held to its rows)."""
    worst = 0.0
    for a, b in zip(fakes, ref_fakes):
        n = min(a.shape[0], b.shape[0])
        d = (a[:n].to(b.device).float() - b[:n].float()) ** 2
        worst = max(worst, float(d.mean(dim=(1, 2, 3)).max()))
    return worst


def readings(program, ref) -> Dict[str, float]:
    """The numbers compared: `program` and `ref` each carry losses, grads
    (first-gradient norms) and changes (change norms) per leaf, and the
    fakes of the first steps' G updates."""
    keep = ref_train.moving_leaves(ref.grads)
    return {"loss_gap": ref_train.loss_gap(program.losses, ref.losses),
            "grad_gap": ref_train.norm_gap(program.grads, ref.grads)[0],
            "change_gap": ref_train.norm_gap(program.changes, ref.changes, keep)[0],
            "fake_mse": fake_mse(program.fakes, ref.fakes)}


def program_readings(ctx) -> SimpleNamespace:
    return SimpleNamespace(losses=ctx.first_logs, grads=ctx.first_grads, changes=ctx.changes,
                           fakes=ctx.first_fakes)


def check(ctx, win) -> Dict[str, Dict]:
    values = readings(program_readings(ctx), reference_readings(ctx))
    return {name: {"value": v, "limit": float(ctx.cell.limits[name])}
            for name, v in values.items()}
