#!/usr/bin/env python3
"""Time K1's instance-split statistics launches on one card, so that two
trees can be compared in turns.

    python3 scripts/split_kernels_in_turns.py [--label NAME] [--rounds 1]

The instance split (ops/modnorm.py::SplitInstanceModnorm) runs where maps
are striped over the model ranks.  At rank 0's stripe of each of its calls
in the 32x 512^2 spatial training step at two ranks (`SHAPES`, bf16, no
modulation, the step's leaky ReLU flag), the script times the partials
launch (`mn.modnorm_instance_partials(x, 0, 2)`) and the backward sums
launch (`mn.modnorm_instance_backward_sums`) with `chip_smoke._device_ms`
(a CUDA graph of calls over inputs larger than the L2, replays timed by
CUDA events) beside each launch's bound (`chip_smoke._sp_stage_bound_ms`),
and prints one JSON line per shape and round; the last line holds, per
spatial step of one rank (each shape's launches per step times its median
ms), the totals, their share of the bound, and the card's name and power
limit.

It uses only the ops' public calls and helpers of `chip_smoke.py` that the
port has had since its spatial slice: to compare two commits, copy it into
the other tree's `scripts/` and run the trees in turns (parent, change,
change, parent) in one call.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepsee_torch.ops import _build  # noqa: E402
from deepsee_torch.ops import modnorm as mn  # noqa: E402

# rank 0's stripe (B, C, H, W), the leaky ReLU flag, forward and backward
# launches per spatial step of one rank: every instance-split call of the
# 32x_guided_512x512 step at b2 over two model ranks (the encoder's instance
# norms, the discriminator's at the stripes' uneven heights)
SHAPES = [((2, 32, 256, 512), True, 2, 1), ((2, 64, 128, 256), True, 2, 1),
          ((2, 128, 64, 128), True, 2, 1), ((2, 256, 128, 256), True, 2, 1),
          ((2, 128, 128, 256), False, 2, 1), ((4, 64, 64, 129), True, 2, 2),
          ((4, 128, 32, 65), True, 2, 2), ((4, 256, 32, 66), True, 2, 2),
          ((4, 64, 32, 65), True, 2, 2), ((4, 128, 16, 33), True, 2, 2),
          ((4, 256, 16, 34), True, 2, 2)]
POOL_BYTES = 120e6   # inputs per shape: more than twice the 50 MB L2
TARGET_MS = 10.0


def _inputs(shape, gen):
    cl = torch.channels_last
    x = (torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.7).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return x.contiguous(memory_format=cl), g.contiguous(memory_format=cl)


def time_shape(shape, lrelu: bool, gen) -> dict:
    """Device ms per call of the partials and the sums launch at `shape`."""
    pool = [_inputs(shape, gen)
            for _ in range(max(1, math.ceil(POOL_BYTES / (math.prod(shape) * 4))))]
    x0 = pool[0][0]
    _, mean, rstd = mn.modnorm_instance_apply(x0, None, mn.modnorm_instance_partials(x0, 0, 2),
                                              lrelu=lrelu)
    partials = [functools.partial(mn.modnorm_instance_partials, x, 0, 2) for x, _ in pool]
    sums = [functools.partial(mn.modnorm_instance_backward_sums, x, None, g, mean, rstd,
                              lrelu=lrelu) for x, g in pool]
    out = {"partials": cs._device_ms(partials, target_ms=TARGET_MS),
           "sums": cs._device_ms(sums, target_ms=TARGET_MS)}
    del pool
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("split_kernels_in_turns: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(16)
    times = {shape: {"partials": [], "sums": []} for shape, *_ in SHAPES}
    for r in range(args.rounds):
        for shape, lrelu, _, _ in SHAPES:
            t = time_shape(shape, lrelu, gen)
            for k, v in t.items():
                times[shape][k].append(v)
            print(json.dumps({"label": args.label, "round": r, "shape": shape, "ms": t}),
                  flush=True)
    totals = {"partials": {"ms": 0.0, "bound_ms": 0.0, "launches": 0},
              "sums": {"ms": 0.0, "bound_ms": 0.0, "launches": 0}}
    per_shape = []
    for shape, lrelu, fwd, bwd in SHAPES:
        row = {"shape": shape}
        for stage, n in (("partials", fwd), ("sums", bwd)):
            ms = statistics.median(times[shape][stage])
            bound, _ = cs._sp_stage_bound_ms("instance", stage, shape, False, lrelu, 2)
            row[stage] = {"us": ms * 1e3, "bound_us": bound * 1e3, "share": bound / ms}
            acc = totals[stage]
            acc["ms"] += ms * n
            acc["bound_ms"] += bound * n
            acc["launches"] += n
        per_shape.append(row)
    for acc in totals.values():
        acc["bound_share"] = acc["bound_ms"] / acc["ms"]
    print(json.dumps({"label": args.label, "per_spatial_step_and_rank": totals,
                      "per_shape": per_shape, "card": smi, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
