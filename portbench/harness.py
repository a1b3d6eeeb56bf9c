"""One run of one cell: set-up, the measured window, the output check and
the result line's numbers.  `run.py` is the command; this module is what it
drives, and what the CPU tests drive at a tiny size (`device="cpu"`).

Set-up (`setup_s`, from the process's start): the program's system built
from the configuration file, the weights made on the device from the seed
and loaded into it with strict key checking, the traffic kind's own set-up
(its inputs, the warm-up of every shape it will use, the operations counted
over the reference).  Then the window, in which nothing builds or
compiles.  After it the program's peak memory is read, its state freed, and
the traffic kind compares what the window produced with the plain
reference (`reference/`) run on the same weights and inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from portbench import seeded, spec
from portbench.reference import nets
from portbench.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepsee_tpu")
THREADS = 4     # the host's torch threads: the load comes from one process


@contextlib.contextmanager
def strict_float32():
    """cuDNN convolutions and matrix products in full float32 (TF32 off)
    inside the block: the reference's precision."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def make_pool(ctx) -> list:
    """The traffic's distinct batches, made on the device from the seed."""
    t = ctx.cell.traffic
    gen = torch.Generator(device=ctx.device).manual_seed(derived_seed(ctx.seed, 1))
    return [seeded.make_batch(t["batch"], ctx.cfg["crop_size"], ctx.cfg["label_nc"],
                              nets.guided(ctx.cfg), gen) for _ in range(t["pool"])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def experiment(config: dict, train: bool):
    """The program's Experiment for a configuration file: its preset with
    the file's "model" fields (the file holds the configuration as run)."""
    from deepsee_torch.config import get_preset, tiny_test_experiment

    preset = config["preset"]
    exp = tiny_test_experiment() if preset == "tiny_test" else get_preset(preset)
    model = dataclasses.replace(exp.model, **config["model"])
    tr = dataclasses.replace(exp.train, **config.get("train", {}))
    return exp.replace(model=model, train=tr, is_train=train)


def derived_seed(seed: int, salt: int) -> int:
    """A second stream's seed from the run's seed (64 bits)."""
    return (seed * 6364136223846793005 + salt * 1442695040888963407) % (1 << 63)


def device_info(device: torch.device, chips: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def build(cell: spec.Cell, seed: int, device: torch.device) -> SimpleNamespace:
    """The context a traffic kind works in: the configuration, the
    program's system with the seeded weights, the weights themselves."""
    from deepsee_torch.system import SRSystem

    kind = cell.kind()
    train = bool(getattr(kind, "TRAIN", False))
    exp = experiment(cell.config, train)
    if train:   # the step's coin and noise generators follow the run's seed
        exp = exp.replace(train=dataclasses.replace(exp.train,
                                                    seed=derived_seed(seed, 3) % (1 << 31)))
    model = dataclasses.asdict(exp.model)
    weights = seeded.make_weights(nets.param_spec(model, train), seed, device)
    system = SRSystem(exp, device=device)
    for name, net in system.networks().items():
        net.load_state_dict(weights[name], strict=True)
    return SimpleNamespace(cell=cell, kind=kind, exp=exp, cfg=model, seed=seed, device=device,
                           system=system, weights=weights)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(ctx: SimpleNamespace) -> None:
    """Free the program's state before the reference runs."""
    ctx.system = None
    ctx.state = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, Dict]
    device: Dict
    checks: Dict[str, Dict]
    breakdown: Optional[Dict] = None

    def line(self) -> Dict:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t0: Optional[float] = None, log=print) -> Result:
    """One run; `t0` is the process's start on time.perf_counter's clock."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    torch.set_num_threads(THREADS)
    t_start = time.perf_counter()
    ctx = build(cell, seed, device)
    sync(device)
    t_built = time.perf_counter()
    ctx.kind.setup(ctx)
    sync(device)
    setup_s = time.perf_counter() - t0
    log(f"setup_s {setup_s!r}: to the harness {t_start - t0!r}, system and weights "
        f"{t_built - t_start!r}, the traffic's set-up {time.perf_counter() - t_built!r}")
    log(getattr(ctx, "setup_notes", ""))
    tracer = Tracer(trace, device.type)
    window = ctx.kind.window(ctx, seconds, tracer)
    sync(device)
    info = device_info(device, cell.chips)
    if trace and device.type == "cuda":
        info["busy_s"], info["window_s"] = tracer.busy_s, tracer.window_s
    release(ctx)
    t_check = time.perf_counter()
    checks = ctx.kind.check(ctx, window)
    log(f"output check {time.perf_counter() - t_check!r} s" + (
        f", the card's peak since the start {torch.cuda.max_memory_allocated(device)}"
        if device.type == "cuda" else ""))
    correct = window.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    names = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    units = {m["name"]: m["unit"] for m in cell.per_layer + cell.end_to_end}
    metrics: Dict[str, Dict] = {}
    breakdown = None
    if trace:
        record = SimpleNamespace(**vars(window.record), trace=tracer, cfg=ctx.cfg,
                                 config=cell.config, traffic=cell.traffic)
        for name in names:
            value = cell.reader(name).read(record)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
        if device.type == "cuda":
            breakdown = {"device_ops": tracer.device_ops(), "idle_gaps": tracer.idle_gaps()}
    else:
        values = dict(window.end_to_end, setup_s=setup_s)
        for name in names:
            if name in values:
                metrics[name] = {"value": float(values[name]), "unit": units[name]}
    for note in window.notes:
        log(note)
    return Result(correct=correct, attempted=window.attempted, failed=window.failed,
                  metrics=metrics, device=info, checks=checks, breakdown=breakdown)
