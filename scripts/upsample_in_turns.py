#!/usr/bin/env python3
"""Time the 2x nearest upsample between generator blocks two ways on one
card, at the shapes the port's paths give it, in turns.

    python3 scripts/upsample_in_turns.py [--rounds 2] [--reps 10]

The two ways:

* "interpolate": `F.interpolate(x, scale_factor=2, mode="nearest")`, made
  channels_last;
* "broadcast": the (B, H, W, C) view of x broadcast to (B, H, 2, W, 2, C)
  and copied into (B, 2H, 2W, C), returned as its (B, C, 2H, 2W) view;
  its backward is a sum over the copies.

First one call of each path with `upsample_nearest_2x` wrapped records the
inputs it gets (shape, dtype, whether grad flows): the main path
(`chip_smoke.PRESET` at `chip_smoke.BATCH`, bf16 inference), the faithful
training step of that preset at `chip_smoke.TRAIN_BATCH_LARGE` and of
`chip_smoke.PRESET_512` at `chip_smoke.BATCH_512`.  Then, for each input,
both ways are checked equal (outputs; gradients within one rounding of the
sum of four) and timed by CUDA events (`chip_smoke._event_ms`, `reps` calls
after a warm-up) in turns (interpolate, broadcast, broadcast, interpolate)
per round: the forward alone, and the forward and backward where the path
takes gradients.  One JSON line per input and round; the last line holds
per path the ms of all its upsample calls each way (medians over the
rounds) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepsee_torch.config import get_preset  # noqa: E402
from deepsee_torch.models import encoder as encoder_mod  # noqa: E402
from deepsee_torch.models import generator as generator_mod  # noqa: E402
from deepsee_torch.ops import _build  # noqa: E402
from deepsee_torch.train import steps as train_steps  # noqa: E402


def interpolate(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest").contiguous(
        memory_format=torch.channels_last)


def broadcast(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1)
    y = nhwc[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
    return y.permute(0, 3, 1, 2)


WAYS = {"interpolate": interpolate, "broadcast": broadcast}


def record_inputs() -> dict:
    """{path: Counter of (shape, dtype, grad)} from one call of each path."""
    seen = {}
    current = []

    def wrap(fn):
        def call(x):
            seen[current[0]][tuple(x.shape), str(x.dtype).split(".")[1],
                             torch.is_grad_enabled() and x.requires_grad] += 1
            return fn(x)
        return call

    saved = {mod: mod.upsample_nearest_2x for mod in (generator_mod, encoder_mod)}
    for mod, fn in saved.items():
        mod.upsample_nearest_2x = wrap(fn)
    try:
        current[:] = [f"main b{cs.BATCH}"]
        seen[current[0]] = collections.Counter()
        system = cs.seeded_system(cs.PRESET)
        cs.run_path(system, cs.make_batch(get_preset(cs.PRESET).model, cs.BATCH))
        del system
        for preset, batch_n in ((cs.PRESET, cs.TRAIN_BATCH_LARGE), (cs.PRESET_512, cs.BATCH_512)):
            current[:] = [f"step {preset} b{batch_n}"]
            seen[current[0]] = collections.Counter()
            system = cs.train_system(preset, batch_n)
            guided = system.cfg.net_e == "fullstyle"
            train_steps.make_train_step(system)(cs._state_of(system),
                                                cs.make_batch(system.cfg, batch_n, guided=guided))
            torch.cuda.synchronize()
            del system
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for mod, fn in saved.items():
            mod.upsample_nearest_2x = fn
    return seen


def check(x: torch.Tensor, gy: torch.Tensor, grad: bool) -> None:
    outs = {}
    for name, fn in WAYS.items():
        xi = x.detach().requires_grad_(grad)
        y = fn(xi)
        assert y.is_contiguous(memory_format=torch.channels_last), name
        if grad:
            y.backward(gy)
        outs[name] = (y.detach(), xi.grad)
    (y0, g0), (y1, g1) = outs.values()
    assert torch.equal(y0, y1)
    if grad:
        torch.testing.assert_close(g0, g1)


def time_input(shape, dtype: str, grad: bool, reps: int) -> dict:
    """ms per call of each way, forward (and forward + backward with grad),
    in turns."""
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    dt = getattr(torch, dtype)
    x = torch.randn(shape, generator=g, device="cuda", dtype=dt).contiguous(
        memory_format=torch.channels_last)
    b, c, h, w = shape
    gy = torch.randn((b, c, 2 * h, 2 * w), generator=g, device="cuda", dtype=dt).contiguous(
        memory_format=torch.channels_last)
    check(x, gy, grad)
    times = collections.defaultdict(list)
    for name in ("interpolate", "broadcast", "broadcast", "interpolate"):
        fn = WAYS[name]
        with torch.no_grad():
            times[f"{name}_fwd_ms"].append(cs._event_ms(lambda: fn(x), reps=reps))
        if grad:
            xg = x.detach().requires_grad_(True)

            def both():
                xg.grad = None
                fn(xg).backward(gy)
            times[f"{name}_fwd_bwd_ms"].append(cs._event_ms(both, reps=reps))
    del x, gy
    torch.cuda.empty_cache()
    return {k: statistics.mean(v) for k, v in times.items()}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("upsample_in_turns: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    seen = record_inputs()
    inputs = sorted({key for counter in seen.values() for key in counter})
    rounds = collections.defaultdict(list)
    for i in range(args.rounds):
        for shape, dtype, grad in inputs:
            row = time_input(shape, dtype, grad, args.reps)
            rounds[shape, dtype, grad].append(row)
            print("upsample " + json.dumps(dict(row, shape=shape, dtype=dtype, grad=grad,
                                                round=i)), flush=True)
    medians = {key: {k: statistics.median(r[k] for r in rows) for k in rows[0]}
               for key, rows in rounds.items()}
    totals = {}
    for path, counter in seen.items():
        total = collections.Counter()
        for key, n in counter.items():
            for way in WAYS:
                # the path's ms each way: the backward where grad flows
                total[way] += n * medians[key][f"{way}_fwd_bwd_ms" if key[2] else f"{way}_fwd_ms"]
        totals[path] = dict(total, calls=sum(counter.values()),
                            inputs=[list(k) + [n] for k, n in counter.items()])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print("upsample totals " + json.dumps(dict(totals, card=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
