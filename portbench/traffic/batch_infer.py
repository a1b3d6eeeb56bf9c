"""Batch inference: a caller that super-resolves a stream of batches, as
the port's evaluator feeds them (deepsee_torch/eval/evaluator.py, two
batches in flight).

Parameters (the traffic mix's file): `batch`, `in_flight` (batches
enqueued before the host waits for the oldest), `pool` (distinct seeded
batches in pinned host memory, cycled), `warmup` (batches run before the
window), `check_batches` (batches of the window kept for the output check,
drawn from the seed by reservoir sampling over every batch the window
finishes).  The configuration says whether the model is guided (a guiding
image and label map per sample) and whether it runs under the port's
`int8_inference()` ("int8").

A batch is submitted when its host arrays are handed to
`SRSystem.preprocess`; it is done when its fake (and a flag saying whether
the fake is finite) has been copied into pinned host memory.  The window
submits batches for `seconds`, then waits for those in flight.

The window runs from the first submission until the last batch submitted
before `seconds` have passed is done.  End-to-end: `infer_img_per_s`, the
images of every batch the window submitted over the window's length;
`infer_p95_ms`, the 95th percentile over those batches, each from
submission to done.  Output check: each kept fake against
the reference's float32 output (`reference.nets.infer`, with the
configuration's quantization where it has one) on the same weights and
host batch; the number compared is the worst image's mean squared error.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import deque
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import harness, work
from portbench.reference import nets
from portbench.reference.ops import Quant, QuantLog

TRAIN = False


def _guided(ctx) -> bool:
    return nets.guided(ctx.cfg)


def quant(config: Dict):
    """The reference's quantization for a configuration (None for bf16)."""
    q = config.get("int8")
    return None if q is None else Quant(bits=8, min_ch=q["min_ch"], smooth=q["smooth"])


def program_mode(config: Dict):
    """The context the program's calls run in: int8_inference() where the
    configuration quantizes."""
    q = config.get("int8")
    if q is None:
        return contextlib.nullcontext()
    from deepsee_torch.models.layers import int8_inference

    return int8_inference(min_ch=q["min_ch"], smooth=q["smooth"])


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return t.pin_memory() if torch.cuda.is_available() else t



def count_work(cfg: Dict, config: Dict, batch: int) -> SimpleNamespace:
    """Operations of one batch over the reference on the meta device: the
    int8 convs' apart, with their shapes."""
    spec = nets.param_spec(cfg)
    meta = {net: {n: torch.empty(s, device="meta") for n, s in tensors.items()}
            for net, tensors in spec.items()}
    size, guided = cfg["crop_size"], nets.guided(cfg)
    host = {"image_hr": torch.empty(batch, size, size, 3, device="meta"),
            "label": torch.empty(batch, size, size, dtype=torch.int32, device="meta")}
    if guided:
        host["guiding_image"] = torch.empty(batch, size, size, 3, device="meta")
        host["guiding_label"] = torch.empty(batch, size, size, dtype=torch.int32, device="meta")
    log = QuantLog()
    total = work.count_flops(lambda: nets.infer(meta, cfg, host, quant(config), log))
    int8 = work.k4_ops(log.convs)
    return SimpleNamespace(bf16_flops=total - int8, int8_ops=int8, k4_convs=log.convs)


class Stream:
    """The loop shared by the warm-up and the window."""

    def __init__(self, ctx, tracer, stage_events: bool):
        t = ctx.cell.traffic
        self.ctx, self.tracer = ctx, tracer
        self.system = ctx.system
        self.depth = t["in_flight"]
        self.use_full = _guided(ctx) or ctx.cfg.get("full_style_image", False)
        self.cuda = ctx.device.type == "cuda"
        self.stage_events = stage_events and self.cuda
        self.pending = deque()
        self.stages: Dict[str, list] = {"encode": [], "generate": []}
        self._event_log = []

    def _event(self):
        if not self.cuda:
            return None
        e = torch.cuda.Event(enable_timing=self.stage_events)
        e.record()
        return e

    def submit(self, index: int, host: Dict[str, torch.Tensor], out: torch.Tensor,
               flag: torch.Tensor) -> None:
        rng = self.tracer.range
        t_submit = time.perf_counter()
        marks = []
        with rng("preprocess"):
            pre = self.system.preprocess(host)
        if self.stage_events:
            marks.append(self._event())
        with rng("encode_style"):
            style = self.system.encode_style(pre, use_full=self.use_full, no_noise=True)
        if self.stage_events:
            marks.append(self._event())
        with rng("generate"):
            fake, _ = self.system.generate(pre, style=style)
        if self.stage_events:
            marks.append(self._event())
        with rng("to_host"):
            out.copy_(fake, non_blocking=True)
            flag.copy_(torch.isfinite(fake).all().reshape(1), non_blocking=True)
            done = self._event()
        if marks:
            self._event_log.append(marks)
        self.pending.append((index, t_submit, done, out, flag))

    def wait_oldest(self):
        """(index, submitted, done, out, flag) of the oldest batch in flight,
        once its fake is in host memory."""
        index, t_submit, done, out, flag = self.pending.popleft()
        with self.tracer.range("wait"):
            if done is not None:
                done.synchronize()
        return index, t_submit, time.perf_counter(), out, flag

    def stage_ms(self) -> Dict[str, list]:
        for enc0, enc1, gen1 in self._event_log:
            self.stages["encode"].append(enc0.elapsed_time(enc1))
            self.stages["generate"].append(enc1.elapsed_time(gen1))
        return self.stages


def setup(ctx) -> None:
    t, cfg = ctx.cell.traffic, ctx.cfg
    t0 = time.perf_counter()
    pool = harness.make_pool(ctx)
    ctx.host_pool = [{k: _pinned(v.cpu()) for k, v in b.items()} for b in pool]
    del pool
    size = cfg["crop_size"]
    buffers = t["check_batches"] + t["in_flight"] + 1
    ctx.out_buffers = [_pinned(torch.empty(t["batch"], size, size, 3)) for _ in range(buffers)]
    ctx.flags = [_pinned(torch.empty(1, dtype=torch.bool)) for _ in range(buffers)]
    from portbench.trace import Tracer

    t1 = time.perf_counter()
    stream = Stream(ctx, Tracer(False), False)
    with program_mode(ctx.cell.config), torch.inference_mode():
        for i in range(t["warmup"]):
            stream.submit(i, ctx.host_pool[i % len(ctx.host_pool)], ctx.out_buffers[i % 2],
                          ctx.flags[i % 2])
            if len(stream.pending) >= stream.depth:
                stream.wait_oldest()
        while stream.pending:
            stream.wait_oldest()
    t2 = time.perf_counter()
    ctx.work = count_work(cfg, ctx.cell.config, t["batch"])
    ctx.setup_notes = (f"traffic set-up: inputs {t1 - t0!r} s, warm-up {t2 - t1!r} s, "
                       f"operations counted {time.perf_counter() - t2!r} s")


def window(ctx, seconds: float, tracer, max_batches: Optional[int] = None) -> SimpleNamespace:
    """Submit batches for `seconds` (or `max_batches` of them), then wait
    for those in flight."""
    t = ctx.cell.traffic
    keep = t["check_batches"]
    rng = np.random.RandomState(harness.derived_seed(ctx.seed, 2) % (1 << 32))
    free = list(zip(ctx.out_buffers, ctx.flags))
    kept: List[tuple] = []          # (pool index, out, flag)
    latencies, done_at = [], []
    failed = finished = 0
    notes: List[str] = []
    stream = Stream(ctx, tracer, tracer.on)
    pool_n = len(ctx.host_pool)

    def complete():
        nonlocal failed, finished
        index, t_submit, t_done, out, flag = stream.wait_oldest()
        latencies.append(t_done - t_submit)
        done_at.append(t_done)
        if not bool(flag[0]):
            failed += 1
        # reservoir sampling of the batches kept for the check
        slot = finished if finished < keep else int(rng.randint(0, finished + 1))
        finished += 1
        if slot < keep:
            if slot < len(kept):
                free.append(kept[slot][1:])
                kept[slot] = (index % pool_n, out, flag)
            else:
                kept.append((index % pool_n, out, flag))
        else:
            free.append((out, flag))

    with program_mode(ctx.cell.config), torch.inference_mode(), tracer, \
            tracer.range("window"):
        harness.sync(ctx.device)
        start = time.perf_counter()
        end = start + seconds
        i = 0
        try:
            while time.perf_counter() < end and (max_batches is None or i < max_batches):
                with tracer.range("loop"):
                    out, flag = free.pop()
                    stream.submit(i, ctx.host_pool[i % pool_n], out, flag)
                    i += 1
                    while len(stream.pending) >= stream.depth:
                        complete()
            while stream.pending:
                complete()
        except RuntimeError as err:        # a batch that raises fails the run
            failed += 1
            notes.append(f"batch {i} raised: {err!r}")
        harness.sync(ctx.device)
        stop = time.perf_counter()
    lat_ms = np.array(latencies) * 1e3
    p95 = float(np.percentile(lat_ms, 95)) if len(lat_ms) else math.nan
    notes.append(f"infer_p95_ms over {len(lat_ms)} batches: {p95!r} ms "
                 f"(median {float(np.median(lat_ms)) if len(lat_ms) else math.nan!r})")
    record = SimpleNamespace(units=i, batch=t["batch"], stage_ms=stream.stage_ms(), work=ctx.work,
                             full_trunk=stream.use_full,
                             elt_bytes=2 if ctx.cfg["compute_dtype"] == "bfloat16" else 4)
    return SimpleNamespace(attempted=i, failed=failed, kept=kept, notes=notes, record=record,
                           end_to_end={"infer_img_per_s": len(done_at) * t["batch"] / (stop - start),
                                       "infer_p95_ms": p95})


def reference_fakes(ctx, pool_index: int, q) -> torch.Tensor:
    """The reference's output on one pool batch, float32, TF32 off."""
    host = {k: v.to(ctx.device) for k, v in ctx.host_pool[pool_index].items()}
    with harness.strict_float32(), torch.no_grad():
        return nets.infer(ctx.weights, ctx.cfg, host, q)



def image_mse(fake: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per image mean squared error, (B,)."""
    return ((fake.to(ref.device).float() - ref) ** 2).mean(dim=(1, 2, 3))


def worst_mse(ctx, kept, q_ref, q_side=None) -> float:
    """The worst image's mean squared error of the kept fakes (or, with
    `q_side`, of the reference at that quantization put in the program's
    place on the same batches) against the reference at `q_ref`."""
    worst = math.nan if not kept else 0.0
    refs: Dict[tuple, torch.Tensor] = {}

    def ref(index, q):
        if (index, q) not in refs:
            refs[(index, q)] = reference_fakes(ctx, index, q)
        return refs[(index, q)]

    for pool_index, out, _ in kept:
        side = out if q_side is None else ref(pool_index, q_side)
        worst = max(worst, float(image_mse(side, ref(pool_index, q_ref)).max()))
    return worst


def check(ctx, win) -> Dict[str, Dict]:
    """The worst kept image's mean squared error against the reference."""
    value = worst_mse(ctx, win.kept, quant(ctx.cell.config))
    return {"worst_mse": {"value": value, "limit": float(ctx.cell.limits["worst_mse"])}}
