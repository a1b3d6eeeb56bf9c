#!/usr/bin/env python3
"""Time K1's instance forward under every launch plan it takes, on one card.

    python3 scripts/instance_plans.py [--out FILE] [--variants grid,on-chip]
                                      [--chosen-only]

For each shape of the instance forward with statistics out in a faithful
b4 training step of 8x_independent_256x256 (`chip_smoke.train_norms`: the
mini and full trunks and the discriminator on 2B = 8), and for the five
inference shapes of the main path at b32 (`chip_smoke.mini_trunk_norms`),
bf16: the device time (`chip_smoke._device_ms`) of the plan
`modnorm.instance_plan` chooses, then of every other plan that
`modnorm.check_instance_plan` accepts among the variants, channel tiles and
cluster sizes the kernel has, each beside the bound (x read once, out
written once), and the device time of a copy of x into a tensor like it
(`Tensor.copy_`: the bound's bytes moved with no statistics in between, the
floor a kernel that overlaps its loads with its arithmetic could approach).
One JSON row per (shape, plan), with the largest errors where a plan
disagrees with the plain version (such a plan is not counted; the script
exits 1 if the chosen one disagrees); the last row sums the chosen plans',
the fastest plans' and the copies' times per training step (launches times
ms) and per inference call.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepsee_torch.config import get_preset  # noqa: E402
from deepsee_torch.ops import modnorm as mn  # noqa: E402

CLUSTERS = (1, 2, 4, 8, 16)            # blocks per slab of the cluster variants
RUNS = (1, 2, 4, 8, 16, 32, 64)         # runs per slab of the grid variant


def shapes():
    """[(shape, lrelu, training launches per faithful b4 step, inference
    launches per b32 main-path call)]."""
    cfg = get_preset(cs.PRESET).model
    out = {}
    for g_full in (True, False):
        for stats, shape, _, lrelu, fwd, _ in cs.train_norms(cfg, cs.TRAIN_BATCH, g_full):
            if stats == "instance":
                out[(shape, lrelu)] = [fwd, 0]
    for shape, lrelu in cs.mini_trunk_norms(cfg, cs.BATCH):
        out.setdefault((shape, lrelu), [0, 0])[1] += 1
    return [(s, l, t, i) for (s, l), (t, i) in out.items()]


def candidates(shape, dtype, sms, variants=mn.INSTANCE_VARIANTS):
    """Every plan of `variants` the plan check accepts on a card of `sms`
    SMs."""
    c = shape[1]
    esize = torch.finfo(dtype).bits // 8
    plans = []
    for variant in variants:
        for tile_bytes in (16, mn.SECTOR, 2 * mn.SECTOR, mn.LINE):
            tile = tile_bytes // esize
            if tile < 8 or c % tile:
                continue
            # the grid variant also at as many runs as fill the card's blocks
            fill = 2 * sms // (shape[0] * c // tile)
            splits = sorted(set(RUNS) | {max(1, fill)}) if variant == "grid" else CLUSTERS
            for plan in mn._instance_candidates(shape, dtype, variant, tile, splits):
                if variant == "grid" and plan.pixels_per_cta * tile_bytes > 4 * max(
                        plan.smem_bytes, 1):
                    continue  # runs mostly streamed: slower than the cluster variants
                try:
                    mn.check_instance_plan(plan, shape, dtype, sms)
                except ValueError:
                    continue
                plans.append(plan)
    return plans


def time_plan(plan, shape, lrelu, dtype, gen, train: bool):
    """Device ms of the forward under `plan` (`train`: with statistics out,
    else the inference op), over a pool of inputs larger than the L2."""
    x0 = cs._kernel_inputs(shape, False, dtype, gen)[0]
    n = max(1, math.ceil(120e6 / (x0.numel() * x0.element_size() * 2)))
    pool = [x0] + [cs._kernel_inputs(shape, False, dtype, gen)[0] for _ in range(n - 1)]
    chosen = mn.instance_plan
    mn.instance_plan = lambda *_a, **_k: plan
    try:
        if train:
            out, mean, rstd = mn.modnorm_train(x0, None, stats="instance", lrelu=lrelu)
            want, wmean, wrstd = mn.modnorm_train_plain(x0, None, stats="instance",
                                                        lrelu=lrelu)
            ok = (cs._train_within(out, want, dtype)
                  and cs._train_within(mean, wmean, torch.float32)
                  and cs._train_within(rstd, wrstd, torch.float32))
            if not ok:
                print("instance plan disagrees " + json.dumps({
                    "shape": list(shape), "plan": dataclasses.asdict(plan),
                    "out": float((out.float() - want.float()).abs().max()),
                    "mean": float((mean - wmean).abs().max()),
                    "rstd": float((rstd - wrstd).abs().max()),
                    "bad_sets": int(((mean - wmean).abs() > 1e-5).sum())}), flush=True)
            call = functools.partial(mn.modnorm_train, stats="instance", lrelu=lrelu)
        else:
            kw = dict(stats="instance", lrelu=lrelu)
            ok = cs._within_tolerance(mn.modnorm(x0, **kw), mn.modnorm_plain(x0, **kw),
                                      "instance", dtype)
            call = functools.partial(mn.modnorm, **kw)
        ms = cs._device_ms([lambda a=a: call(a) for a in pool])
    finally:
        mn.instance_plan = chosen
    del pool
    torch.cuda.empty_cache()
    return ms, ok


def time_copy(shape, dtype, gen):
    """Device ms of `Tensor.copy_` of x of `shape` into a tensor like it,
    over a pool of inputs larger than the L2, as `time_plan` times."""
    x0 = cs._kernel_inputs(shape, False, dtype, gen)[0]
    n = max(1, math.ceil(120e6 / (x0.numel() * x0.element_size() * 2)))
    pool = [x0] + [cs._kernel_inputs(shape, False, dtype, gen)[0] for _ in range(n - 1)]
    outs = [torch.empty_like(a) for a in pool]
    ms = cs._device_ms([lambda a=a, o=o: o.copy_(a) for a, o in zip(pool, outs)])
    del pool, outs
    torch.cuda.empty_cache()
    return ms


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None, help="also write the rows to this file")
    parser.add_argument("--variants", default=",".join(mn.INSTANCE_VARIANTS),
                        help="the variants whose other plans are timed beside the chosen one")
    parser.add_argument("--chosen-only", action="store_true",
                        help="time the plan instance_plan chooses and no other")
    args = parser.parse_args()
    variants = tuple(v for v in args.variants.split(",") if v)
    if not torch.cuda.is_available():
        print("instance_plans: no CUDA device", file=sys.stderr)
        return 1
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows, disagree = [], []
    totals = {f"{key}_{kind}_ms": 0.0 for key in ("train", "infer")
              for kind in ("chosen", "best", "bound", "copy")}
    sms = mn.card_sms(torch.device("cuda"))
    for shape, lrelu, n_train, n_infer in shapes():
        chosen = mn.instance_plan(shape, dtype, sms)
        bound, _ = cs._train_bound_ms(False, shape, False, lrelu, 2)
        copy_ms = time_copy(shape, dtype, gen)
        best = None
        others = [] if args.chosen_only else [p for p in candidates(shape, dtype, sms, variants)
                                              if p != chosen]
        for plan in [chosen] + others:
            ms, ok = time_plan(plan, shape, lrelu, dtype, gen, train=n_train > 0)
            row = {"shape": list(shape), "lrelu": lrelu, "train_launches": n_train,
                   "infer_launches": n_infer, "chosen": plan == chosen,
                   "plan": dataclasses.asdict(plan), "ms": ms, "bound_ms": bound,
                   "share": bound / ms, "copy_ms": copy_ms, "ok": ok}
            rows.append(row)
            print("instance plan " + json.dumps(row), flush=True)
            if not ok:
                disagree.append(row)
                continue
            if best is None or ms < best[0]:
                best = (ms, plan)
            if plan == chosen:
                chosen_ms = ms
        for key, n in (("train", n_train), ("infer", n_infer)):
            totals[f"{key}_chosen_ms"] += n * chosen_ms
            totals[f"{key}_best_ms"] += n * best[0]
            totals[f"{key}_bound_ms"] += n * bound
            totals[f"{key}_copy_ms"] += n * copy_ms
        print("instance best " + json.dumps({"shape": list(shape), "ms": best[0],
                                             "plan": dataclasses.asdict(best[1]),
                                             "chosen_ms": chosen_ms}), flush=True)
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    totals["card"] = smi
    totals["plans_disagreeing"] = [(r["shape"], r["plan"]) for r in disagree]
    print("instance totals " + json.dumps(totals), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
            f.write(json.dumps(totals) + "\n")
    return 1 if any(r["chosen"] for r in disagree) else 0


if __name__ == "__main__":
    sys.exit(main())
