#!/usr/bin/env python3
"""How far float32 rounding alone moves the buffers of the port's and the
JAX package's train steps, on the CPU, at the tiny test configuration.

    python3 scripts/step_parity_rounding.py [--init plain|remat]

For each configuration of tests/test_torch_train_remat.py (independent,
guided, reuse_fake; two faithful steps without remat, SGD) the two packages
run `tests/torch_step_parity.run_both` twice: from the initial weights, and
from the same weights with every parameter moved by one ulp (the direction
of each element drawn from a seed).  Per step it prints the largest
absolute difference over the buffers (spectral u / v, running statistics)
and the buffer where it lies, for: JAX against the port, JAX against JAX
nudged, the port against the port nudged, and the two nudged runs.

`--init plain` draws the JAX init without remat (what the parity tests
use); `--init remat` draws it as the JAX package does with `remat=True`
(flax's `nn.remat` draws other values for the same tree).  A gap between
the packages that is smaller than what a one-ulp nudge makes within one
package is rounding, not a fault of the port.
"""

from __future__ import annotations

import argparse
import os
import sys

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)

import conftest  # noqa: E402,F401  (JAX on the CPU platform, as the tests run it)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_step_parity as tsp  # noqa: E402
from deepsee_tpu.system import SRSystem as JaxSystem  # noqa: E402
from deepsee_tpu.system import SystemVariables  # noqa: E402
from test_torch_layers import realistic_variables  # noqa: E402

BUFFERS = ("weight_u", "weight_v", "running_mean", "running_var")
CONFIGS = {"independent": (tsp.INDEPENDENT, (), True), "guided": (tsp.GUIDED, (), False),
           "reuse_fake": (tsp.GUIDED, (("reuse_fake", True),), False)}
NUDGE_SEED = 5


def initial(model, train, remat: bool) -> SystemVariables:
    jexp, _ = tsp.experiments(model, train + (("remat", remat),))
    v = JaxSystem(jexp).init(jax.random.PRNGKey(0))
    return SystemVariables(g=realistic_variables(v.g, 1), e=realistic_variables(v.e, 2),
                           d=realistic_variables(v.d, 3), vgg=jax.device_get(v.vgg))


def nudged(variables: SystemVariables, seed: int) -> SystemVariables:
    """Every float32 parameter one ulp up or down."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.dtype != np.float32:
            return a
        return np.nextafter(a, np.where(rng.rand(*a.shape) < 0.5, -np.inf, np.inf)
                            .astype(np.float32)).astype(np.float32)

    nets = {}
    for net in ("g", "e", "d"):
        tree = dict(getattr(variables, net))
        tree["params"] = walk(tree["params"])
        nets[net] = tree
    return SystemVariables(vgg=variables.vgg, **nets)


def buffers(snapshot) -> dict:
    return {(net, k): v.numpy() for net in snapshot for k, v in snapshot[net].items()
            if k.endswith(BUFFERS)}


def worst(a: dict, b: dict):
    key = max(a, key=lambda k: np.abs(a[k] - b[k]).max())
    return float(np.abs(a[key] - b[key]).max()), ".".join(key)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--init", choices=("plain", "remat"), default="remat")
    args = parser.parse_args()
    torch.set_num_threads(4)
    for name, (model, train, independent) in CONFIGS.items():
        start = initial(model, train, args.init == "remat")
        runs = {}
        for tag, variables in (("base", start), ("nudged", nudged(start, NUDGE_SEED))):
            tsp.initial_variables = lambda jexp, v=variables: v
            runs[tag] = tsp.run_both(model=model, train=train, independent=independent)
        for step in range(len(runs["base"])):
            jax_b, port_b = (buffers(s) for s in runs["base"][step][3:])
            jax_n, port_n = (buffers(s) for s in runs["nudged"][step][3:])
            print(f"init {args.init} {name} step {step}: "
                  f"jax-port {worst(jax_b, port_b)}; jax-jax_nudged {worst(jax_b, jax_n)}; "
                  f"port-port_nudged {worst(port_b, port_n)}; "
                  f"jax_nudged-port_nudged {worst(jax_n, port_n)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
