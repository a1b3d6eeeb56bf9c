#!/usr/bin/env python3
"""Where the port's first train step parts from the JAX package's at the
JAX multichip test's width (ngf=8, tests/test_train_step.py:55-67), and
whether float32 rounding alone explains it, on the CPU.

    python3 scripts/wide_step_parity.py [--ngf 8] [--batch 4] [--top 6]
        [--readout_lr 1e3] [--nudge_seeds 10]

Both packages run one seeded step (tests/torch_step_parity.run_both: SGD,
fixed coins, shape-keyed noise, the independent model without noise
injection, as tests/test_torch_tp_step.py's "seeded" run) twice: from the
initial weights, and from the same weights with every parameter moved by
one ulp (`step_parity_rounding.nudged`).  Per parameter leaf it prints the
step's relative error (`torch_step_parity.step_error`) of the port against
JAX, of JAX against JAX nudged, and of the port against the port nudged,
for the `--top` leaves where the port and JAX part most.

A blend weight's step (SGD_LR times a gradient of ~1e-5) is a few ulps of
the weight itself, so its step error and its nudge spread are mostly the
weight's rounding.  The script reads those gradients again from one more
pair of runs (each package, from the initial and the nudged weights) with
the step's learning rate at `--readout_lr`, where a step of the blend
weights resolves their gradient to ~1e-11, and prints them for the SEAN
blocks of largest kappa (below).

Then, for every SEAN block of the port's generator, the cancellation in the
gradient of its blend weights: d loss / d sigmoid(alpha_gamma) is the sum
over every element of the modulation of dL/dgamma * (gamma_style -
gamma_seg) (and likewise for beta).  It prints kappa = sum |term| / |sum
term|: a relative error e in the terms can move the sum by up to kappa * e.
A gap between the packages no larger than what a one-ulp nudge makes within
one package, on a leaf with a large kappa, is rounding, not a fault.

Last, the port alone, on tests/test_torch_tp_wide.py's "noise" run (two
faithful SGD steps at batch 4 from the same weights): per network the
relative L2 after the second step of one process nudged by one ulp from
each of `--nudge_seeds` seeds (0: none of this part), and of two model
ranks (gloo, 1 x 2), against the one process unnudged.
"""

from __future__ import annotations

import argparse
import os
import sys

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: E402,F401  (JAX on the CPU platform, as the tests run it)
import torch  # noqa: E402

import torch_step_parity as tsp  # noqa: E402
from deepsee_torch.models import normalization as tnorm  # noqa: E402
from deepsee_torch.system import SRSystem  # noqa: E402
from deepsee_torch.train import state as tstate  # noqa: E402
from deepsee_torch.train import steps as tsteps  # noqa: E402
import _torch_dist_worker as worker  # noqa: E402
from step_parity_rounding import BUFFERS, NUDGE_SEED, nudged  # noqa: E402
from torch_seeded import batch_for  # noqa: E402


def leaf_steps(run):
    """{(net, key): (jax step, port step)} of the first step of a run_both run."""
    (jbefore, tbefore), _, _, jsnap, tsnap = run[0]
    return {(net, k): ((jsnap[net][k] - jbefore[net][k]).numpy(),
                       (tsnap[net][k] - tbefore[net][k]).numpy())
            for net in jsnap for k in jsnap[net] if not k.endswith(BUFFERS)}


def sean_cancellation(texp, variables, batch):
    """Per SEAN block of the port's generator, for gamma and beta: the sum
    of the terms of d loss / d sigmoid(alpha), the sum of their magnitudes,
    and the gradient of alpha that the step's SGD took (from its update),
    at the G step of one seeded port step."""
    mod_conv, normalize = tnorm.SEANBlock._mod_conv, tnorm._SEANCore._normalize
    seen, grads = {}, {}

    def capture_conv(self, inp, weight, bias, up2):
        if torch.is_grad_enabled() and isinstance(self, tnorm.SEANBlock):
            params = {k: getattr(self, k).weight.detach().clone()
                      for k in ("mlp_gamma", "mlp_beta", "mlp_style_gamma", "mlp_style_beta")}
            biases = {k: getattr(self, k).bias.detach().clone() for k in params}
            alphas = (self.alpha_gamma.item(), self.alpha_beta.item())
            seen[self] = (inp.detach(), up2, params, biases, alphas)
        return mod_conv(self, inp, weight, bias, up2)

    def capture_norm(self, x, sharded, mod, lrelu):
        if mod.requires_grad and self in seen:
            mod.register_hook(lambda g, block=self: grads.__setitem__(block, g.detach()))
        return normalize(self, x, sharded, mod, lrelu)

    port = SRSystem(texp, device="cpu")
    port.load_jax_variables(variables.g, variables.e, variables.d, variables.vgg)
    names = {m: n for n, m in port.generator.named_modules()}
    tnorm.SEANBlock._mod_conv, tnorm._SEANCore._normalize = capture_conv, capture_norm
    try:
        with tsp.patched(True):
            state = tstate.create_train_state(port, init=False)
            before = {n: (m.alpha_gamma.item(), m.alpha_beta.item())
                      for m, n in names.items() if isinstance(m, tnorm.SEANBlock)}
            tsteps.make_train_step(port)(state, batch)
    finally:
        tnorm.SEANBlock._mod_conv, tnorm._SEANCore._normalize = mod_conv, normalize
    out = {}
    with torch.no_grad():
        for block, (inp, up2, w, b, alphas) in seen.items():
            gmod = grads[block].double()
            c = gmod.shape[1] // 2
            name = names[block]
            after = (block.alpha_gamma.item(), block.alpha_beta.item())
            for i, (seg, sty, half) in enumerate((("mlp_gamma", "mlp_style_gamma", slice(0, c)),
                                                  ("mlp_beta", "mlp_style_beta", slice(c, None)))):
                zero_s, zero_t = torch.zeros_like(w[sty]), torch.zeros_like(w[seg])
                y_seg = mod_conv(block, inp, torch.cat([w[seg], zero_s], 1), b[seg], up2)
                y_sty = mod_conv(block, inp, torch.cat([zero_t, w[sty]], 1), b[sty], up2)
                terms = gmod[:, half] * (y_sty.double() - y_seg.double())
                s = torch.sigmoid(torch.tensor(alphas[i], dtype=torch.float64))
                key = f"{name}.alpha_{'gamma' if i == 0 else 'beta'}"
                out[key] = {"sum": float(terms.sum()), "abs_sum": float(terms.abs().sum()),
                            "terms": terms.numel(),
                            "alpha_grad_from_terms": float(s * (1 - s) * terms.sum()),
                            "alpha_grad_of_step": (before[name][i] - after[i]) / tsp.SGD_LR}
    return out


def second_step_spread(texp, variables, seeds: int):
    """{net: (the nudged one-process runs' relative L2 after the second
    "noise" step, sorted; the two model ranks')} against the run unnudged."""
    import json
    import tempfile

    port = SRSystem(texp, device="cpu")
    port.load_jax_variables(variables.g, variables.e, variables.d, variables.vgg)
    weights = {net: m.state_dict() for net, m in port.networks().items()}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(weights, os.path.join(tmp, "weights.pt"))
        with open(os.path.join(tmp, "wide.json"), "w") as f:
            json.dump({"model_axis": 2}, f)
        ranks = worker.Spawned(tmp, ["tp_wide"], world=2)
        runs = [worker.step_run(weights, model=worker.TP_WIDE, nudge_seed=seed)
                for seed in [None] + list(range(seeds))]
        rank = ranks.results(timeout=600.0)[0][0]["tp_wide"]

    def flat(run, net):
        snap = run["steps"][1][1]
        return torch.cat([v.double().reshape(-1) for _, v in sorted(snap[net].items())])

    out = {}
    for net in ("g", "e", "d"):
        ref = flat(runs[0], net)
        rel = sorted(float((flat(r, net) - ref).norm() / ref.norm()) for r in runs[1:])
        out[net] = (rel, float((flat(rank, net) - ref).norm() / ref.norm()))
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ngf", type=int, default=8)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--top", type=int, default=6)
    parser.add_argument("--readout_lr", type=float, default=1e3)
    parser.add_argument("--nudge_seeds", type=int, default=10)
    args = parser.parse_args()
    torch.set_num_threads(4)
    model = dict(tsp.INDEPENDENT, ngf=args.ngf)
    jexp, texp = tsp.experiments(model)
    start = tsp.initial_variables(jexp)
    runs, readout = {}, {}
    sgd_lr = tsp.SGD_LR
    for tag, variables in (("base", start), ("nudged", nudged(start, NUDGE_SEED))):
        tsp.initial_variables = lambda jexp_, v=variables: v
        for lr, out in ((sgd_lr, runs), (args.readout_lr, readout)):
            tsp.SGD_LR = lr
            out[tag] = leaf_steps(tsp.run_both(model=model, independent=True,
                                               batch_size=args.batch, pattern=(True,)))
    tsp.SGD_LR = sgd_lr
    base, nudge = runs["base"], runs["nudged"]
    gap = {k: tsp.step_error(base[k][1], base[k][0]) for k in base}
    print(f"ngf {args.ngf}, batch {args.batch}: the first seeded step, relative error of a "
          f"leaf's step (STEP_RTOL {tsp.STEP_RTOL})")
    for key in sorted(gap, key=gap.get, reverse=True)[:args.top]:
        jax_spread = tsp.step_error(nudge[key][0], base[key][0])
        port_spread = tsp.step_error(nudge[key][1], base[key][1])
        print(f"  {'.'.join(key)}: port vs JAX {gap[key]:.3e}; JAX vs JAX nudged 1 ulp "
              f"{jax_spread:.3e}; port vs port nudged 1 ulp {port_spread:.3e}", flush=True)
    cancel = sean_cancellation(texp, start, batch_for(jexp.model, False, batch=args.batch))
    print("SEAN blend weights: kappa = sum |term| / |sum term| of d loss / d sigmoid(alpha); "
          f"the gradient d loss / d alpha read at lr {args.readout_lr:g} (JAX, JAX nudged, "
          "port, port nudged)")
    for key, r in sorted(cancel.items(), key=lambda kv: -kv[1]["abs_sum"] / abs(kv[1]["sum"])):
        gkey = ("g", key)
        read = [-float(readout[tag][gkey][side].sum()) / args.readout_lr
                for side in (0, 1) for tag in ("base", "nudged")]
        print(f"  {key}: kappa {r['abs_sum'] / abs(r['sum']):.3e} over {r['terms']} terms; "
              f"alpha's gradient from the terms {r['alpha_grad_from_terms']:.6e}, "
              f"of the port's step {r['alpha_grad_of_step']:.6e}; read "
              + ", ".join(f"{g:.6e}" for g in read)
              + f"; step: port vs JAX {gap.get(gkey, float('nan')):.3e}", flush=True)
        block, kind = key.rsplit(".alpha_", 1)
        convs = [f"{block}.{c}.weight" for c in (f"mlp_{kind}", f"mlp_style_{kind}")]
        print("    the block's convs it blends, step: port vs JAX (JAX vs JAX nudged, port vs "
              "port nudged) " + ", ".join(
                  f"{c.rsplit('.', 2)[1]} {gap[('g', c)]:.3e} "
                  f"({tsp.step_error(nudge[('g', c)][0], base[('g', c)][0]):.3e}, "
                  f"{tsp.step_error(nudge[('g', c)][1], base[('g', c)][1]):.3e})"
                  for c in convs), flush=True)
    if not args.nudge_seeds:
        return 0
    torch.set_num_threads(1)
    spread = second_step_spread(texp, start, args.nudge_seeds)
    print(f"the port's second \"noise\" step at ngf {args.ngf}, relative L2 against one process: "
          f"one process nudged by one ulp ({args.nudge_seeds} seeds, sorted); two model ranks")
    for net, (rel, rank) in spread.items():
        print(f"  {net}: nudged " + ", ".join(f"{r:.2e}" for r in rel) + f"; ranks {rank:.2e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
