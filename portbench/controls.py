"""The readings the output check's limits are set from, on the card at the
cell's own size:

    python3 -m portbench.controls --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--batches 12]

For each seed of --seeds, the program's timed path (the cell's traffic,
`--batches` batches) and the number the check compares, as a run reads it:
the lower readings.  For each seed of --control-seeds, the control: the
nearest precision below the configuration's put in the program's place.
For a bf16 configuration that is the program's own int8 path
(int8_inference(), its 23 W8A8 convs); for an int8 one, the reference's
W4A4 recipe against its W8A8 one on the same kept batches.  One JSON line
per reading; the check's limit lies between the largest lower reading and
the smallest control reading (PERF.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from portbench import harness, spec
from portbench.reference.ops import FP8
from portbench.trace import Tracer


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def train_readings(cell: spec.Cell, seed: int, control: bool, device) -> list:
    kind = cell.kind()
    t0 = time.perf_counter()
    ctx = harness.build(cell, seed, device)
    kind.setup(ctx)
    harness.release(ctx)
    ref = kind.reference_readings(ctx)
    out = [dict(what="program", control=False, **kind.readings(kind.program_readings(ctx), ref))]
    if control:
        low = kind.reference_readings(ctx, q=FP8())
        out.append(dict(what="reference fp8 vs float32", control=True,
                        **kind.readings(low, ref)))
        half = kind.reference_readings(ctx, batch_rows=cell.traffic["batch"] // 2)
        out.append(dict(what="fault: half the batch left out", control=True,
                        **kind.readings(half, ref)))
    for row in out:
        row.update(workload=cell.name, seed=seed, seconds=time.perf_counter() - t0)
    return out


def reading(cell: spec.Cell, seed: int, batches: int, control: bool, device) -> dict:
    kind = cell.kind()
    q_ref = kind.quant(cell.config)
    if control and q_ref is None:
        cell = dataclasses.replace(cell, config=dict(cell.config,
                                                     int8={"min_ch": 64, "smooth": True}))
    t0 = time.perf_counter()
    ctx = harness.build(cell, seed, device)
    kind.setup(ctx)
    win = kind.window(ctx, 1e9, Tracer(False), max_batches=batches)
    harness.release(ctx)
    if not control:
        value = kind.worst_mse(ctx, win.kept, q_ref)
        what = "program"
    elif q_ref is None:       # the program's int8 path against the float32 reference
        value = kind.worst_mse(ctx, win.kept, None)
        what = "program int8 vs float32 reference"
    else:
        value = kind.worst_mse(ctx, win.kept, q_ref, dataclasses.replace(q_ref, bits=4))
        what = "reference W4A4 vs W8A8"
    return {"workload": cell.name, "seed": seed, "control": control, "what": what,
            "worst_mse": value, "batches": win.attempted, "failed": win.failed,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="readings for the output check's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--batches", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.controls: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda")
    train = bool(getattr(cell.kind(), "TRAIN", False))
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            rows = (train_readings(cell, seed, control, device) if train
                    else [reading(cell, seed, args.batches, control, device)])
            for row in rows:
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
