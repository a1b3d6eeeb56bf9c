"""The benchmark of deepsee_torch on one NVIDIA H100:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It runs the cell of BENCHMARK.json once and
prints one JSON line last on standard output: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer ones
with --trace 1), device, the traced run's breakdown, and last the numbers
of the output check beside their limits (also the last lines of standard
error).  It exits with 2, printing no result, without a CUDA card or with
fewer cards than the cell asks for, and with 3 where JAX, flax, optax or
the JAX package got loaded.  Every cache it or the port builds lies in the
checkout (the port's kernels in deepsee_torch/_build/, anything else in
.portbench_cache/).
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on time.perf_counter's clock (Linux), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parents[1] / ".portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ.setdefault(var, str(CACHE / sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0,
                         log=lambda m: print(m, file=sys.stderr))
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"portbench: the run loaded {leaked}", file=sys.stderr)
        return 3
    for name, c in result.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
