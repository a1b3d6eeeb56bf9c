#!/usr/bin/env python3
"""Time K1's instance-split statistics launches under every plan they take,
on one card.

    python3 scripts/split_plans.py [--out FILE] [--chosen-only]

At rank 0's stripe of each instance-split call of the 32x 512^2 spatial
step at two ranks (`split_kernels_in_turns.SHAPES`, bf16, no modulation),
for the partials launch and the backward sums launch: the device time
(`chip_smoke._device_ms`) of the plan `modnorm.split_plan` chooses, then of
every other ring plan that `modnorm.check_split_plan` accepts among
the channel tiles and cluster sizes (CLUSTERS), each beside the bound
(`chip_smoke._sp_stage_bound_ms`).  One JSON row per (shape, launch,
plan); the last row sums the chosen and the fastest plans per spatial step
of one rank (launches times ms) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepsee_torch.ops import _build  # noqa: E402
from deepsee_torch.ops import modnorm as mn  # noqa: E402
from split_kernels_in_turns import SHAPES, TARGET_MS, _inputs  # noqa: E402

CLUSTERS = (1, 2, 3, 4, 6, 8, 12, 16)
STAGES = ("partials", "sums")


def candidates(shape, stage: str):
    """Every plan of the split's kernels for `stage` at `shape`: the chosen
    one first."""
    chosen = mn.split_plan(shape, torch.bfloat16)
    b, c, h, w = shape
    out = [chosen]
    for tile in (64, 32, 16, 8):
        if c % tile:
            continue
        for k in CLUSTERS:
            if k > h * w:
                continue
            plan = dataclasses.replace(chosen, tile=tile, cluster=k,
                                       pixels_per_cta=math.ceil(h * w / k),
                                       grid=(k * c // tile, b))
            if plan != chosen:
                mn.check_split_plan(plan, shape, torch.bfloat16)
                out.append(plan)
    return out


def time_plan(stage: str, plan, pool, mean, rstd, lrelu: bool) -> float:
    real = mn.split_plan
    mn.split_plan = lambda *a, **k: plan
    try:
        if stage == "partials":
            fns = [functools.partial(mn.modnorm_instance_partials, x, 0, 2) for x, _ in pool]
        else:
            fns = [functools.partial(mn.modnorm_instance_backward_sums, x, None, g, mean, rstd,
                                     lrelu=lrelu) for x, g in pool]
        return cs._device_ms(fns, target_ms=TARGET_MS)
    finally:
        mn.split_plan = real


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--chosen-only", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("split_plans: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = open(args.out, "w") if args.out else sys.stdout
    gen = torch.Generator(device="cuda").manual_seed(16)
    totals = {s: {"chosen_ms": 0.0, "fastest_ms": 0.0, "bound_ms": 0.0} for s in STAGES}
    for shape, lrelu, fwd, bwd in SHAPES:
        pool = [_inputs(shape, gen) for _ in range(max(1, math.ceil(120e6 / (math.prod(shape)
                                                                            * 4))))]
        x0 = pool[0][0]
        _, mean, rstd = mn.modnorm_instance_apply(x0, None, mn.modnorm_instance_partials(x0, 0, 2),
                                                  lrelu=lrelu)
        for stage, n in (("partials", fwd), ("sums", bwd)):
            plans = candidates(shape, stage)[:1 if args.chosen_only else None]
            bound, _ = cs._sp_stage_bound_ms("instance", stage, shape, False, lrelu, 2)
            best = None
            for i, plan in enumerate(plans):
                ms = time_plan(stage, plan, pool, mean, rstd, lrelu)
                best = ms if best is None else min(best, ms)
                print(json.dumps({"shape": shape, "stage": stage, "chosen": i == 0,
                                  "tile": plan.tile, "cluster": plan.cluster,
                                  "blocks": plan.grid[0] * plan.grid[1], "us": ms * 1e3,
                                  "bound_us": bound * 1e3, "share": bound / ms}), file=out,
                      flush=True)
                if i == 0:
                    totals[stage]["chosen_ms"] += ms * n
            totals[stage]["fastest_ms"] += best * n
            totals[stage]["bound_ms"] += bound * n
        del pool
        torch.cuda.empty_cache()
    print(json.dumps({"per_spatial_step_and_rank": totals, "card": smi}), file=out, flush=True)
    if args.out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
