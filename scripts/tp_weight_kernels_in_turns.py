#!/usr/bin/env python3
"""Time K4 (b)'s launches under a tensor-parallel shard on one card, so that
two trees can be compared in turns.

    python3 scripts/tp_weight_kernels_in_turns.py [--label NAME] [--rounds 1]

Under tensor parallelism a rank quantizes its block of each sharded conv's
weight in two launches of (b) around the model group's MAX all-reduce
(ops/int8conv.py::int8_conv_sharded): the column maxima
(`ic.weight_column_maxima`) or the row maxima (`ic.weight_row_maxima`) of
its block, then the scales and k_q from the group's maxima
(`ic.quantize_weight_columns`, `ic.quantize_weight_rows`).  At each block
shape of one rank's int8 main-path call (`BLOCKS`: 8x_independent_256x256
over two model ranks, the blocks chip_smoke.py's "tp int8 kernel" lines
list), the script checks every launch bit for bit against its plain
version, on two blocks of a seeded weight (the all-reduce as the
elementwise maximum of their first launches), then times each launch with
`chip_smoke._device_ms` on one block (a CUDA graph of calls on one weight,
which stays in the L2 as the spectral norm's fresh weight does in the
forward; replays timed by CUDA events) beside its bound
(`chip_smoke._tp_weight_bounds`), and prints one JSON line per shape and
round.  The last line holds, per tensor-parallel int8 call and rank (each
shape's launches per call times its median ms), the totals, their share of
the bound, the device time of the smallest launch in the same harness
(`floor_us`: one float zeroed, the launch's own cost in a graph), and the
card's name and power limit.

It uses only the wrappers' public calls and helpers of `chip_smoke.py` that
the port has had since its int8 tensor-parallel slice: to compare two
commits, copy it into the other tree's `scripts/` and run the trees in turns
(parent, change, change, parent) in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepsee_torch.ops import _build  # noqa: E402
from deepsee_torch.ops import int8conv as ic  # noqa: E402

# (role, one rank's block (Cout, Cin, kh, kw), launches per int8 call and rank)
BLOCKS = [("column", (64, 64, 3, 3), 1), ("column", (256, 512, 3, 3), 5),
          ("column", (512, 128, 3, 3), 2), ("column", (512, 256, 3, 3), 8),
          ("row", (256, 64, 3, 3), 1), ("row", (512, 256, 3, 3), 5)]
TARGET_MS = 10.0
KERNELS = ("weight_column_maxima", "weight_row_maxima", "weight_scales")


def _k_q_oihw(k_q: torch.Tensor, cin: int) -> torch.Tensor:
    return k_q[..., :cin].permute(0, 3, 1, 2)


def _equal(got, want) -> bool:
    if isinstance(got, torch.Tensor):
        if got.dim() == 4 and got.dtype == torch.int8:
            got = _k_q_oihw(got, want.shape[1])
        return bool(torch.equal(got, want))
    return all(_equal(g, w) for g, w in zip(got, want))


def check_and_time(role: str, block, gen) -> dict:
    """Bit for bit against the plain versions on two blocks, then the device
    ms of each launch on the first block."""
    cout, cin, kh, kw = block
    whole = (2 * cout, cin, kh, kw) if role == "column" else (cout, 2 * cin, kh, kw)
    weight = torch.randn(whole, generator=gen, device="cuda") * 0.05
    xcin = whole[1]
    x = (torch.randn((2, xcin, 16, 16), generator=gen, device="cuda")
         * torch.logspace(-1.5, 0.5, xcin, device="cuda")[:, None, None])
    ws = [w.contiguous() for w in weight.chunk(2, 0 if role == "column" else 1)]
    xs = [x, x] if role == "column" else list(x.chunk(2, 1))
    maxima = [ic.absmax_channels_plain(t) for t in xs]
    if role == "column":
        first = [ic.weight_column_maxima(w) for w in ws]
        want_first = [ic.weight_column_maxima_plain(w) for w in ws]
        top = torch.maximum(*first)
        second = [ic.quantize_weight_columns(w, *m, top) for w, m in zip(ws, maxima)]
        want_second = [ic.quantize_weight_columns_plain(w, *m, top) for w, m in zip(ws, maxima)]
        fns = {"weight_column_maxima": lambda: ic.weight_column_maxima(ws[0]),
               "weight_scales": lambda: ic.quantize_weight_columns(ws[0], *maxima[0], top)}
    else:
        launched = [ic.weight_row_maxima(w, *m, True) for w, m in zip(ws, maxima)]
        want_first = [ic.weight_row_maxima_plain(w, *m, True) for w, m in zip(ws, maxima)]
        top = torch.maximum(launched[0][1], launched[1][1])
        second = [ic.quantize_weight_rows(w, f[0], top) for w, f in zip(ws, launched)]
        want_second = [ic.quantize_weight_rows_plain(w, f[0], top) for w, f in zip(ws, launched)]
        # the maxima folded over their parts, where the launch gives them in parts
        first = [(s_c, m.reshape(-1, cout + 1).amax(0)) for s_c, m in launched]
        s_c0 = launched[0][0]
        fns = {"weight_row_maxima": lambda: ic.weight_row_maxima(ws[0], *maxima[0], True),
               "weight_scales": lambda: ic.quantize_weight_rows(ws[0], s_c0, top)}
    torch.cuda.synchronize()
    ok = all(_equal(g, w) for g, w in zip(first + second, want_first + want_second))
    if not ok:
        raise AssertionError(f"tp_weight_kernels_in_turns: {role} {list(block)} differs from "
                             "its plain version")
    return {key: cs._device_ms([fn], target_ms=TARGET_MS) for key, fn in fns.items()}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tp_weight_kernels_in_turns: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(18)
    times = {(role, block): {} for role, block, _ in BLOCKS}
    for r in range(args.rounds):
        for role, block, _ in BLOCKS:
            t = check_and_time(role, block, gen)
            for k, v in t.items():
                times[(role, block)].setdefault(k, []).append(v)
            print(json.dumps({"label": args.label, "round": r, "role": role,
                              "block": list(block), "ms": t, "bit_for_bit": True}), flush=True)
    totals = {k: {"ms": 0.0, "bound_ms": 0.0, "launches": 0} for k in KERNELS}
    per_shape = []
    for role, block, n in BLOCKS:
        bounds = cs._tp_weight_bounds(role, block)
        row = {"role": role, "block": list(block), "per_call": n}
        for key, values in times[(role, block)].items():
            ms = statistics.median(values)
            bound = bounds[key][0]
            row[key] = {"us": ms * 1e3, "bound_us": bound * 1e3, "share": bound / ms}
            acc = totals[key]
            acc["ms"] += ms * n
            acc["bound_ms"] += bound * n
            acc["launches"] += n
        per_shape.append(row)
    for acc in totals.values():
        acc["bound_share"] = acc["bound_ms"] / acc["ms"]
    one = torch.empty(1, device="cuda")
    floor_us = 1e3 * cs._device_ms([one.zero_], target_ms=TARGET_MS)
    print(json.dumps({"label": args.label, "per_tp_int8_call_and_rank": totals,
                      "per_shape": per_shape, "floor_us": floor_us, "card": smi,
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
