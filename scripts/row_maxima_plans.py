#!/usr/bin/env python3
"""Time K4 (b)'s row-maxima launch under a tensor-parallel shard under every
plan it takes, on one card.

    python3 scripts/row_maxima_plans.py [--out FILE] [--chosen-only]

At each row-block shape of one rank's int8 main-path call at two model
ranks (`tp_weight_kernels_in_turns.BLOCKS`) and the edge shapes of the
card tests (`EDGES`), for every cluster size and run of input
channels that the kernel takes (`int8conv.row_maxima_plan`'s chosen plan
first, then `int8conv._row_maxima_launch`'s): s_c and the maxima, smoothing
and not, bit for bit against `weight_row_maxima_plain` (the clusters' rows
of maxima folded by their elementwise max), then the device
time of the smoothing launch (`chip_smoke._device_ms`: a CUDA graph of launches on one weight, as
scripts/tp_weight_kernels_in_turns.py times it) beside its bound
(`chip_smoke._tp_weight_bounds`).  One JSON row per (shape, plan); the last
row sums the chosen and the fastest plans per tensor-parallel int8 call and
rank, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepsee_torch.ops import _build  # noqa: E402
from deepsee_torch.ops import int8conv as ic  # noqa: E402
from tp_weight_kernels_in_turns import BLOCKS, TARGET_MS  # noqa: E402

# (one rank's block, launches per int8 call and rank: 0 for the edges)
EDGES = [((100, 33, 3, 3), 0), ((64, 1, 3, 3), 0), ((40, 200, 1, 1), 0), ((7, 17, 3, 3), 0),
         ((130, 96, 5, 5), 0)]
COLUMNS = (1, 2, 4, 8, 16, 32)
CLUSTERS = (1, 2, 4, 8, 16)


def candidates(cout: int, cin: int, taps: int):
    chosen = ic.row_maxima_plan(cout, cin, taps)
    out = [chosen]
    for cluster in CLUSTERS:
        for columns in COLUMNS:
            if columns > 2 * cin or -(-cin // columns) < cluster:
                continue
            try:
                plan = ic._row_maxima_launch(cout, cin, taps, columns, cluster)
            except ValueError:
                continue
            if plan not in out:
                out.append(plan)
    return out


def launch(plan, w, mx_raw, mx, s_c, maxima, smooth: bool):
    cout, cin, kh, kw = w.shape
    err = ic._lib().int8_weight_row_maxima(
        w.data_ptr(), mx.data_ptr(), mx_raw.data_ptr(), s_c.data_ptr(), maxima.data_ptr(), cout,
        cin, kh * kw, int(smooth), plan.grid, plan.columns, plan.cluster, plan.vec, plan.smem,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"row_maxima_plans: {plan}: CUDA error {err}")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--chosen-only", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("row_maxima_plans: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = open(args.out, "w") if args.out else sys.stdout
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    totals = {"chosen_ms": 0.0, "fastest_ms": 0.0, "bound_ms": 0.0, "launches": 0}
    shapes = [(block, n) for role, block, n in BLOCKS if role == "row"] + EDGES
    for block, n in shapes:
        cout, cin, kh, kw = block
        w = torch.randn(block, generator=gen, device=dev) * 0.05
        x = (torch.randn((2, cin, 16, 16), generator=gen, device=dev)
             * torch.logspace(-1.5, 0.5, cin, device=dev)[:, None, None])
        mx_raw, mx = ic.absmax_channels_plain(x)
        want = {sm: ic.weight_row_maxima_plain(w, mx_raw, mx, sm) for sm in (True, False)}
        bound = cs._tp_weight_bounds("row", block)["weight_row_maxima"][0]
        plans = candidates(cout, cin, kh * kw)[:1 if args.chosen_only else None]
        best = None
        for i, plan in enumerate(plans):
            s_c = torch.empty(cin, device=dev)
            maxima = torch.empty((plan.parts, cout + 1), device=dev)
            for smooth in (False, True):  # the smoothing launch last: its results stay
                maxima.fill_(float("nan"))
                launch(plan, w, mx_raw, mx, s_c, maxima, smooth)
                torch.cuda.synchronize()
                ok = (torch.equal(s_c, want[smooth][0])
                      and torch.equal(maxima.amax(0), want[smooth][1]))
                if not ok:
                    raise AssertionError(f"row_maxima_plans: {list(block)} {plan} "
                                         f"smooth={smooth} differs from the plain version")
            ms = cs._device_ms([lambda: launch(plan, w, mx_raw, mx, s_c, maxima, True)],
                               target_ms=TARGET_MS)
            best = ms if best is None else min(best, ms)
            print(json.dumps({"block": list(block), "chosen": i == 0, **plan._asdict(),
                              "us": ms * 1e3, "bound_us": bound * 1e3, "share": bound / ms,
                              "bit_for_bit": True}), file=out, flush=True)
            if i == 0:
                totals["chosen_ms"] += ms * n
        totals["fastest_ms"] += best * n
        totals["bound_ms"] += bound * n
        totals["launches"] += n
    print(json.dumps({"per_tp_int8_call_and_rank": totals, "card": smi}), file=out, flush=True)
    if args.out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
