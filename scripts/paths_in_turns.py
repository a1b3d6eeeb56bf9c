#!/usr/bin/env python3
"""Time the paths that K1's and K4's kernels serve, and the int8 main path's
PSNR, on one card, in rounds, so that two trees can be compared in turns.

    python3 scripts/paths_in_turns.py [--rounds 3] [--reps 5] [--steps 5]

The seeded systems and batches of `chip_smoke.py`:

* the main path (8x_independent_256x256 b32) in bf16 and under
  `int8_inference()`;
* the 8x guided path (8x_guided_256x256, the full encoder on the guiding
  image) at b32 under int8, and in bf16 at `chip_smoke.SERVE_BATCH` (8), the
  batch the serving phase sends: the full trunk's instance norms at batch 8;
* the faithful training step at `chip_smoke.TRAIN_BATCH` (4).

First the PSNR of the int8 main path, smoothing on and off, against bf16
(seeded weights and batch: the same in every run of one tree).  Then each
round times each path with CUDA events (`chip_smoke._event_ms`, `reps`
calls after a warm-up; the step `steps` times) and prints one JSON line;
the last line holds the medians and the card's name and power limit.

The script uses only helpers of `chip_smoke.py` that older trees of the
port have too (seeded systems and batches, `run_path`, `train_system`, the
event timers).  To compare two commits on one card, copy it into the parent
tree's `scripts/` and run the trees in turns (parent, change, change,
parent) in one call; to attribute a difference, swap single sources between
the trees.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepsee_torch.config import get_preset  # noqa: E402
from deepsee_torch.models.layers import int8_inference  # noqa: E402
from deepsee_torch.ops import _build  # noqa: E402
from deepsee_torch.train import steps as train_steps  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("paths_in_turns: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    guided = cs.SERVE_PRESETS["guided"]
    system = cs.seeded_system(cs.PRESET)
    batch = cs.make_batch(get_preset(cs.PRESET).model, cs.BATCH)
    gsys = cs.seeded_system(guided)
    gbatch = cs.make_batch(get_preset(guided).model, cs.BATCH, guided=True)
    gbatch8 = cs.make_batch(get_preset(guided).model, cs.SERVE_BATCH, guided=True)

    ref = cs.run_path(system, batch)
    with int8_inference():
        fake = cs.run_path(system, batch)
    with int8_inference(smooth=False):
        fake_ns = cs.run_path(system, batch)
    psnr = {"int8_vs_bf16_psnr_db": cs.psnr_db(fake, ref),
            "int8_nosmooth_vs_bf16_psnr_db": cs.psnr_db(fake_ns, ref)}
    print("paths psnr " + json.dumps(psnr), flush=True)
    del ref, fake, fake_ns

    tsys = cs.train_system(cs.PRESET, cs.TRAIN_BATCH)
    state = cs._state_of(tsys)
    step = train_steps.make_train_step(tsys)
    tbatch = cs.make_batch(tsys.cfg, cs.TRAIN_BATCH)
    step(state, tbatch)  # warm-up: cuDNN plans, the allocator

    def path_ms(sys_, batch_, use_full: bool, int8: bool) -> float:
        def call():
            with int8_inference() if int8 else contextlib.nullcontext():
                cs.run_path(sys_, batch_, use_full)
        return cs._event_ms(call, reps=args.reps)

    rounds = []
    for i in range(args.rounds):
        row = {"main_bf16_ms": path_ms(system, batch, False, False),
               "main_int8_ms": path_ms(system, batch, False, True),
               "guided_int8_ms": path_ms(gsys, gbatch, True, True),
               f"guided_b{cs.SERVE_BATCH}_bf16_ms": path_ms(gsys, gbatch8, True, False),
               f"step_b{cs.TRAIN_BATCH}_ms": cs._step_events_ms(step, state, tbatch,
                                                                 args.steps)}
        rounds.append(row)
        print("paths round " + json.dumps(dict(row, round=i)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print("paths medians " + json.dumps(
        dict({k: statistics.median(r[k] for r in rounds) for k in rounds[0]}, **psnr,
             card=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
