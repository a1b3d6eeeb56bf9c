"""One rank of the port's data-parallel, tensor-parallel and spatial tests
(tests/test_torch_dist_*.py, tests/test_torch_tp_*.py, tests/test_torch_sp_*.py).

    python tests/_torch_dist_worker.py OUT_DIR TASK[,TASK...]

with torchrun's variables set by the spawning test (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and CLI_PORTS.  It runs torch on one
intra-op thread, joins a gloo process group on the CPU for the tasks other
than "cli", runs them, leaves the group, then runs the "cli" task where
asked, and saves what the tasks return to OUT_DIR/rank<R>.pt.  The "cli"
task joins no group itself: the CLIs do, with --multihost, each on its own
port of CLI_PORTS.

A worker shards kernels of TP_MIN_SHARD_CH channels or more
(`shard.MIN_SHARD_CH`), so that the tiny networks shard.  Imports no
deepsee_tpu: a worker is a process of the port alone.  The
functions that make a task's run (`step_run`, `eval_run`, ...) are also
called by the tests in one process, for the comparison.
"""

from __future__ import annotations

import builtins
import dataclasses
import itertools
import os
import sys
import warnings

import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]  # torch_seeded; the repository's packages

from deepsee_torch.config import MeshConfig, tiny_test_experiment  # noqa: E402
from deepsee_torch.data import DataLoader, SyntheticDataset  # noqa: E402
from deepsee_torch.eval.evaluator import InferenceEvaluator  # noqa: E402
from deepsee_torch.models import encoder as tenc  # noqa: E402
from deepsee_torch.models import layers as tlayers  # noqa: E402
from deepsee_torch.models import normalization as tnorm  # noqa: E402
from deepsee_torch.parallel import distributed, shard  # noqa: E402
from deepsee_torch.system import SRSystem  # noqa: E402
from deepsee_torch.train import state as tstate  # noqa: E402
from deepsee_torch.train import steps as tsteps  # noqa: E402
from torch_seeded import COINS, SGD_LR, batch_for, normal_for, uniform_for  # noqa: E402

GLOBAL_BATCH = 4
# the encoder and discriminator batch norms taken across ranks
# (deepsee_torch/models/layers.py::GlobalMoments), on the independent model
# without noise injection
NORM_CONFIGS = {"batch": dict(add_noise=False, norm_e="batch", norm_d="spectralbatch"),
                "sync_batch": dict(add_noise=False, norm_e="spectralsync_batch",
                                   norm_d="spectralbatch")}
STEPS = 2
EVAL_SAMPLES = 8
EVAL_BATCH = 2
TRAIN_SAMPLES = 8          # one epoch of the trainer task: 8 / 4 = 2 steps
# tensor parallelism: model_axis 2 with the JAX package's multichip test's
# min_shard_ch (tests/test_train_step.py:55-67), which shards every network
# of the tiny configuration (its 64-wide trunk, the encoder trunks, D, VGG)
TP_MIN_SHARD_CH = 8
TP_MODEL_AXIS = 2
# the JAX package's multichip test itself: its trunk width and its (data,
# model) layout (tests/test_train_step.py:55-60); `_tp_wide_task` reads the
# layout it runs from OUT_DIR/wide.json
TP_WIDE = dict(ngf=8)


def rows(batch, rank: int, world: int):
    """This rank's contiguous rows of a global numpy batch."""
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def snapshot(system: SRSystem):
    """G's, E's and D's parameters and buffers, cloned; under tensor
    parallelism with every shard gathered (all model ranks call it)."""
    nets = {"g": system.generator, "e": system.encoder, "d": system.discriminator}
    return {net: {k: v.detach().clone() for k, v in shard.gather_state_dict(m).items()}
            for net, m in nets.items()}


def tp_mesh() -> MeshConfig:
    """This world laid out as (world / TP_MODEL_AXIS) x TP_MODEL_AXIS."""
    return MeshConfig(data_axis=distributed.world_size() // TP_MODEL_AXIS,
                      model_axis=TP_MODEL_AXIS)


def _norm_calls(calls):
    """The generator's batch-statistics K1 calls recorded into `calls`:
    ("one", channels) for the one-launch modnorm_train, ("split", channels,
    ranks of its group) for modnorm_train_sync."""
    one, split = tnorm.modnorm_train, tnorm.modnorm_train_sync

    def one_launch(x, mod=None, *, stats, **k):
        if stats == "batch":
            calls.append(("one", x.shape[1]))
        return one(x, mod, stats=stats, **k)

    def split_launch(x, mod=None, *, group=None, **k):
        calls.append(("split", x.shape[1], torch.distributed.get_world_size(group)))
        return split(x, mod, group=group, **k)

    return ((tnorm, "modnorm_train", one_launch), (tnorm, "modnorm_train_sync", split_launch))


class _Patches:
    """Attribute replacements undone on exit."""

    def __init__(self, *triples):
        self.triples, self.saved = triples, []

    def __enter__(self):
        for obj, name, value in self.triples:
            self.saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


def _sgd():
    return ((tstate, "make_g_optimizer",
             lambda system, tc: torch.optim.SGD(tstate.g_params(system), lr=SGD_LR)),
            (tstate, "make_d_optimizer",
             lambda system, tc: torch.optim.SGD(system.discriminator.parameters(), lr=SGD_LR)))


def _seeded_draws():
    """Coins fixed to COINS and noise as numpy functions of the global
    draw's shape, each rank keeping its rows (tests/torch_step_parity.py
    feeds the same numbers to both packages)."""
    pairs = itertools.cycle(COINS)

    def draw(values):
        return lambda shape, device: distributed.rank_rows(
            lambda s: torch.from_numpy(values(s)).to(device), shape)

    normal, uniform = draw(normal_for), draw(uniform_for)
    return ((tsteps, "draw_coins", lambda system, generator: next(pairs)),
            (tlayers, "draw_injection_noise",
             lambda shape, generator, device: normal(shape, device)),
            (tenc, "draw_noise", lambda shape, dist, generator, device:
             (uniform if dist == "uniform" else normal)(shape, device)))


def nudge(system: SRSystem, ulps: int, seed: int) -> None:
    """Scale every G, E and D parameter by (1 + ulps * 2^-23 * r), r ~ N(0,
    1) drawn from `seed`: a change at float32's rounding level (as
    chip_smoke.py's `_nudge`)."""
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in filter(None, (system.generator, system.encoder, system.discriminator)):
            for p in net.parameters():
                p.mul_(1 + ulps * 2.0 ** -23 * torch.randn(p.shape, generator=generator))


def load_weights(system: SRSystem, weights) -> None:
    """`weights` (state dicts of g, e, d, vgg) into the system; noise
    injection weights they lack (a model saved without it) drawn N(0, 0.1^2)
    from a fixed seed, so that the injected noise reaches the output."""
    generator = torch.Generator().manual_seed(11)
    for net, module in system.networks().items():
        missing, unexpected = module.load_state_dict(weights[net], strict=False)
        if unexpected or any(".noise_" not in k for k in missing):
            raise KeyError(f"{net}: missing {missing}, unexpected {unexpected}")
        with torch.no_grad():
            for key in missing:
                t = module.get_parameter(key)
                t.copy_(0.1 * torch.randn(t.shape, generator=generator))


def step_run(weights=None, model=(), seeded_draws: bool = False, nudge_seed=None, train=(),
             mesh=None, steps: int = STEPS):
    """`steps` (STEPS) faithful steps of the tiny independent model with SGD on this
    rank's rows of the global batch (GLOBAL_BATCH): from `weights` (state
    dicts of g, e, d, vgg) or the seeded init, nudged by one ulp from
    `nudge_seed` where it is given, with
    COINS and numpy noise (`seeded_draws`) or the state's own generators;
    `model` and `train` override configuration fields, `mesh` the layout.
    Returns per step the logs and the snapshot after it, the coins drawn
    and the generator's batch-statistics K1 calls (`_norm_calls`)."""
    exp = tiny_test_experiment()
    exp = exp.replace(model=dataclasses.replace(exp.model, **dict(model)),
                      train=dataclasses.replace(exp.train, **dict(train)),
                      mesh=mesh or MeshConfig())
    system = SRSystem(exp, device="cpu")
    coins, calls = [], []
    draw = tsteps.draw_coins
    patches = _sgd() + _norm_calls(calls) + (_seeded_draws() if seeded_draws else (
        (tsteps, "draw_coins", lambda s, g: coins.append(draw(s, g)) or coins[-1]),))
    with _Patches(*patches), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        if weights is not None:
            load_weights(system, weights)
        state = tstate.create_train_state(system, init=weights is None)
        if nudge_seed is not None:
            nudge(system, 1, nudge_seed)
        step = tsteps.make_train_step(system)
        batch = rows(batch_for(exp.model, False, batch=GLOBAL_BATCH), distributed.data_rank(),
                     distributed.data_world())
        out = []
        for _ in range(steps):
            logs = step(state, batch)
            out.append(({k: float(v) for k, v in logs.items()}, snapshot(system)))
    return {"steps": out, "coins": coins, "norm_calls": calls}


def eval_system():
    exp = tiny_test_experiment().replace(is_train=False)
    system = SRSystem(exp, device="cpu")
    system.init(torch.Generator().manual_seed(0))
    return exp, system


def eval_run(order=None):
    """The evaluator on EVAL_SAMPLES synthetic samples at batch EVAL_BATCH
    with FID and LPIPS (seeded random networks): this rank's stripe of them
    in file order, or in one process the samples `order` lists."""
    exp, system = eval_system()
    dataset = SyntheticDataset(exp, length=EVAL_SAMPLES)
    if order is not None:
        dataset = _Reordered(dataset, order)
    loader = DataLoader(dataset, EVAL_BATCH, shuffle=False, drop_last=True, num_workers=1,
                        shard_index=distributed.rank(), num_shards=distributed.world_size())
    ev = InferenceEvaluator(system, EVAL_SAMPLES)
    result = ev.run(loader)
    result.pop("eval_seconds")
    return result


class _Reordered:
    def __init__(self, dataset, order):
        self.dataset, self.order = dataset, list(order)

    def __len__(self):
        return len(self.order)

    def __getitem__(self, i):
        return self.dataset[self.order[i]]


def trainer_exp(root: str):
    """The trainer task's experiment, laid out over this process's world."""
    exp = tiny_test_experiment(checkpoints_dir=root)
    return exp.replace(mesh=MeshConfig(data_axis=distributed.world_size()),
                       train=dataclasses.replace(
                           exp.train, batch_size=GLOBAL_BATCH, niter=1, niter_decay=0,
                           print_freq=GLOBAL_BATCH, save_latest_freq=GLOBAL_BATCH,
                           display_freq=10 ** 9, evaluation_freq=0))


def _trainer_task(out_dir: str):
    """One epoch of `Trainer.run` over TRAIN_SAMPLES synthetic samples, with
    the paths of each step's rows and every file this rank opened for
    writing (or directory it made) under the run's root."""
    from deepsee_torch.train import loop

    root = os.path.join(out_dir, "ckpt")
    exp = trainer_exp(root)
    writes, seen = [], []
    real_open, real_makedirs = builtins.open, os.makedirs

    def recording_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+") and str(file).startswith(root):
            writes.append(str(file))
        return real_open(file, mode, *a, **k)

    def recording_makedirs(name, *a, **k):
        if str(name).startswith(root):
            writes.append(str(name))
        return real_makedirs(name, *a, **k)

    dataset = lambda exp_, phase=None: SyntheticDataset(exp_, length=TRAIN_SAMPLES)  # noqa: E731
    with _Patches((builtins, "open", recording_open), (os, "makedirs", recording_makedirs),
                  (loop, "create_dataset", dataset)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = loop.Trainer(exp, device="cpu")
        step = trainer.step_gd

        def recording_step(state, batch):
            seen.append(list(batch["path"]))
            return step(state, batch)

        trainer.step_gd = recording_step
        state = trainer.run()
    return {"paths": seen, "writes": writes, "step": state.step,
            "snapshot": snapshot(trainer.system), "opt_g": state.opt_g.state_dict(),
            "opt_d": state.opt_d.state_dict()}


def _cli_task(out_dir: str):
    """The training and evaluation CLIs with --multihost on the tiny
    configuration (each joins and leaves its own process group)."""
    from deepsee_torch import evaluate as eval_cli
    from deepsee_torch.train import __main__ as train_cli

    tiny = lambda name: tiny_test_experiment().replace(name=name)  # noqa: E731
    root = os.path.join(out_dir, "cli")
    train_port, eval_port = os.environ["CLI_PORTS"].split(",")
    with _Patches((train_cli, "get_preset", tiny), (eval_cli, "get_preset", tiny)), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        os.environ["MASTER_PORT"] = train_port
        code = train_cli.main(["--name", "tiny", "--multihost", "--data_axis", "2", "--device",
                               "cpu", "--synthetic", "--batch_size", str(GLOBAL_BATCH),
                               "--max_steps", "1", "--checkpoints_dir", root])
        os.environ["MASTER_PORT"] = eval_port
        result = eval_cli.main(["--name", "tiny", "--multihost", "--device", "cpu",
                                "--synthetic", "--no_checkpoint", "--no_fid", "--no_lpips",
                                "--batch_size", "2", "--num_samples", "8"])
    return {"train_exit": code, "eval": result}


def _step_task(out_dir: str):
    weights = torch.load(os.path.join(out_dir, "weights.pt"), weights_only=True)
    return {"seeded": step_run(weights, model=dict(add_noise=False), seeded_draws=True),
            "noise": step_run(weights),
            "noise_remat": step_run(weights, train=dict(remat=True)),
            "noise_remat_convs": step_run(weights, train=dict(remat=True,
                                                              remat_policy="convs"))}


def _norms_task(out_dir: str):
    """The seeded steps of each of NORM_CONFIGS, from its weights file."""
    out = {}
    for name, model in NORM_CONFIGS.items():
        weights = torch.load(os.path.join(out_dir, f"weights_{name}.pt"), weights_only=True)
        out[name] = step_run(weights, model=model, seeded_draws=True)
    return out


# -- tensor parallelism (tests/test_torch_tp_*.py) ------------------------------


def _tp_step_task(out_dir: str):
    """The noise steps of the tiny model laid out as `tp_mesh`, and at one
    data rank also the seeded and the remat "full" ones, with the
    collectives' counts."""
    from deepsee_torch.parallel import tensor as tp

    weights = torch.load(os.path.join(out_dir, "weights.pt"), weights_only=True)
    mesh = tp_mesh()
    tp.reset_counts()
    out = {"noise": step_run(weights, mesh=mesh)}
    if mesh.data_axis == 1:
        out["seeded"] = step_run(weights, model=dict(add_noise=False), seeded_draws=True,
                                 mesh=mesh)
        out["noise_remat"] = step_run(weights, train=dict(remat=True), mesh=mesh)
    out["counts"] = {k: dict(v) for k, v in tp.counts.items()}
    return out


def _tp_wide_task(out_dir: str):
    """The "noise" steps of `_tp_step_task` at TP_WIDE, laid out as
    OUT_DIR/wide.json's model_axis says (the data axis the rest of the
    world), from OUT_DIR/weights.pt."""
    import json

    with open(os.path.join(out_dir, "wide.json")) as f:
        model_axis = json.load(f)["model_axis"]
    weights = torch.load(os.path.join(out_dir, "weights.pt"), weights_only=True)
    mesh = MeshConfig(data_axis=distributed.world_size() // model_axis, model_axis=model_axis)
    return step_run(weights, model=TP_WIDE, mesh=mesh)


def _gathered_grads(module):
    """Every parameter's gradient, the sharded ones gathered."""
    return {name: shard.gathered(p, p.grad).clone() for name, p in module.named_parameters()}


def conv_pair_run():
    """A spectral conv pair (16 -> 32 -> 16 channels) in train mode, the
    first column- and the second row-sharded where there are model ranks:
    the output, every gradient (gathered) and u / v after the forward."""
    from deepsee_torch.parallel import tensor as tp

    g = torch.Generator().manual_seed(5)
    convs = [tlayers.Conv2d(16, 32, 3, spectral=True), tlayers.Conv2d(32, 16, 3, spectral=True)]
    for conv in convs:
        conv.init_params(g)
        with torch.no_grad():
            conv.weight_orig.mul_(30.0)  # sigma well away from 1
            conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, generator=g))
    fresh_uv = [(c.weight_u.clone(), c.weight_v.clone()) for c in convs]
    x = torch.randn(2, 16, 8, 8, generator=g).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    w = torch.randn(2, 16, 8, 8, generator=g)
    if distributed.model_world() > 1:
        shard.shard_module(convs[0], {"weight_orig": tp.COLUMN, "bias": tp.COLUMN})
        shard.shard_module(convs[1], {"weight_orig": tp.ROW, "bias": None})
    h = convs[0](x)
    y = convs[1](tlayers.leaky_relu(h), sharded=convs[0].out_sharded)
    (y * w).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad,
            "grads": [_gathered_grads(c) for c in convs],
            "uv": [(c.weight_u.clone(), c.weight_v.clone()) for c in convs],
            "uv_moved": torch.tensor([float((c.weight_u - u).norm() + (c.weight_v - v).norm())
                                      for c, (u, v) in zip(convs, fresh_uv)])}


def sean_run(norm_1: bool):
    """A train-mode SEANBlock of 16 channels (batch statistics), its four
    modulation convs column-sharded where there are model ranks, and with
    `norm_1` its mlp_shared too (the JAX plan under norm_1) and its input
    given as this rank's channel block: the output (gathered), the
    gradients of x, the style and every parameter (gathered), the running
    statistics."""
    from deepsee_torch.parallel import tensor as tp

    exp = tiny_test_experiment()
    block = tnorm.SEANBlock(exp.model, 16).train()
    g = torch.Generator().manual_seed(6)
    for m in block.modules():
        if hasattr(m, "init_params"):
            m.init_params(g)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    x = (torch.randn(2, 16, 8, 8, generator=g) * 2 + 0.5).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    seg = torch.nn.functional.one_hot(torch.randint(0, exp.model.semantic_nc, (2, 8, 8),
                                                    generator=g), exp.model.semantic_nc)
    seg = seg.permute(0, 3, 1, 2).float().contiguous(memory_format=torch.channels_last)
    style = torch.randn(2, exp.model.label_nc, exp.model.regional_style_size,
                        generator=g).requires_grad_(True)
    w = torch.randn(2, 16, 8, 8, generator=g)
    sharded = norm_1 and distributed.model_world() > 1
    if distributed.model_world() > 1:
        shard.shard_module(block, {
            name: (tp.COLUMN if name.startswith("mlp_") and (norm_1 or "shared" not in name)
                   else None) for name, _ in block.named_parameters()})
    inp = tp.scatter(x) if sharded else x
    out = block(inp, seg, style, lrelu=True, sharded=sharded)
    out = tp.full(out, block.out_sharded)
    (out * w).sum().backward()
    norm = block.param_free_norm
    return {"out": out.detach(), "x_grad": x.grad, "style_grad": style.grad,
            "grads": _gathered_grads(block),
            "running": (norm.running_mean.clone(), norm.running_var.clone())}


def eval_generator_run():
    """The tiny model in eval mode (K1's affine mode), seeded trained-like
    weights, laid out as `tp_mesh` where there are ranks: the fake and the
    style of a batch."""
    from deepsee_torch.weights import randomize_weights

    exp = tiny_test_experiment().replace(is_train=False)
    system = SRSystem(exp, device="cpu")
    system.init(torch.Generator().manual_seed(2))
    randomize_weights(system.networks().values(), torch.Generator().manual_seed(3))
    if distributed.world_size() > 1:
        mesh = tp_mesh()
        distributed.set_model_axis(mesh.model_axis)
        shard.shard_system(system, mesh)
    batch = batch_for(exp.model, False, batch=2)
    fake, style = system.generate(system.preprocess(batch), use_full=False)
    return {"fake": fake.clone(), "style": style.clone()}


# int8 inference under tensor parallelism: every conv of at least this many
# channels (the whole layer's) quantizes, as the JAX package's mesh test runs
# it (tests/test_int8_inference.py:191-243)
TP_INT8_MIN_CH = 8


def int8_generator_run():
    """`eval_generator_run` under int8_inference(min_ch=TP_INT8_MIN_CH): the
    fake and the style, the quantized convs this process ran and the MAX
    all-reduces it made."""
    from deepsee_torch.ops import int8conv as ic
    from deepsee_torch.parallel import tensor as tp

    ic.reset_launches()
    tp.reset_counts()
    with tlayers.int8_inference(min_ch=TP_INT8_MIN_CH):
        out = eval_generator_run()
    return dict(out, quantized_convs=torch.tensor(ic.plain_calls["int8_conv"]),
                max_calls=torch.tensor(tp.counts["max"]["calls"]))


JAX_VARIABLES = "jax_int8_variables.pkl"  # (g, e) numpy trees the test writes into OUT_DIR


def int8_jax_weights_run(out_dir: str):
    """The tiny eval system holding the JAX package's variables that the
    test wrote into out_dir (`SRSystem.load_jax_variables`), laid out as
    `tp_mesh` where there are ranks, under int8_inference(min_ch=
    TP_INT8_MIN_CH): the fake of `batch_for`'s batch, for the JAX package's
    one-device int8 fake of the same weights and batch."""
    import pickle

    with open(os.path.join(out_dir, JAX_VARIABLES), "rb") as f:
        g, e = pickle.load(f)
    exp = tiny_test_experiment().replace(is_train=False)
    system = SRSystem(exp, device="cpu")
    system.load_jax_variables(g, e)
    if distributed.world_size() > 1:
        mesh = tp_mesh()
        distributed.set_model_axis(mesh.model_axis)
        shard.shard_system(system, mesh)
    with tlayers.int8_inference(min_ch=TP_INT8_MIN_CH):
        fake, _ = system.generate(system.preprocess(batch_for(exp.model, False, batch=2)),
                                  use_full=False)
    return {"fake": fake.clone()}


class _Recorded:
    """Every call of int8conv's plain activation quantizer and integer
    product while open: the s_c, s_x, x_q, and k_q, s_k of each quantized
    conv, in call order."""

    def __init__(self):
        from deepsee_torch.ops import int8conv as ic

        self.ic, self.calls = ic, []
        self.saved = ic.quantize_activation_plain, ic.igemm_plain

    def __enter__(self):
        act, igemm = self.saved

        def recording_act(x, s_c, *a, **k):
            s_x, x_q = act(x, s_c, *a, **k)
            self.calls.append({"s_c": s_c.clone(), "s_x": s_x.clone(), "x_q": x_q.clone()})
            return s_x, x_q

        def recording_igemm(x_q, k_q, s_x, s_k, *a, **k):
            self.calls[-1].update(k_q=k_q.clone(), s_k=s_k.clone())
            return igemm(x_q, k_q, s_x, s_k, *a, **k)

        self.ic.quantize_activation_plain, self.ic.igemm_plain = recording_act, recording_igemm
        return self

    def __exit__(self, *exc):
        self.ic.quantize_activation_plain, self.ic.igemm_plain = self.saved


INT8_CONV_MODES = ("smooth", "nosmooth")


def int8_convs_run(mode: str):
    """An eval-mode conv pair (16 -> 32 -> 16 channels, 3x3) under
    int8_inference(min_ch=TP_INT8_MIN_CH, smooth=mode == "smooth"), the
    first column- and the second row-sharded where there are model ranks,
    on an activation whose channel ranges spread over two decades: each
    conv's output (the column conv's gathered) and its quantization (s_c,
    s_x, s_k, k_q OIHW, x_q NCHW) with the sharded pieces gathered, as one
    process computes them for the whole layer."""
    from deepsee_torch.parallel import tensor as tp

    g = torch.Generator().manual_seed(9)
    convs = [tlayers.Conv2d(16, 32, 3), tlayers.Conv2d(32, 16, 3)]
    for conv in convs:
        conv.init_params(g)
        with torch.no_grad():
            spread = 1.0 + 20.0 * torch.rand(conv.weight.shape[1], generator=g)
            conv.weight.mul_(spread[:, None, None])  # column maxima far apart
            conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, generator=g))
        conv.eval()
    scales = torch.logspace(-1.5, 0.5, 16)[:, None, None]
    x = (torch.randn(2, 16, 8, 8, generator=g) * scales).contiguous(
        memory_format=torch.channels_last)
    sharded = distributed.model_world() > 1
    if sharded:
        shard.shard_module(convs[0], {"weight": tp.COLUMN, "bias": tp.COLUMN})
        shard.shard_module(convs[1], {"weight": tp.ROW, "bias": None})
    tp.reset_counts()
    with tlayers.int8_inference(min_ch=TP_INT8_MIN_CH, smooth=mode == "smooth"), \
            torch.no_grad(), _Recorded() as rec:
        h = convs[0](x)
        y = convs[1](tlayers.leaky_relu(h), sharded=convs[0].out_sharded)
    out = {"h": tp.full(h, convs[0].out_sharded), "y": y,
           "max_calls": torch.tensor(tp.counts["max"]["calls"])}
    column, row = rec.calls
    if sharded:  # the blocks of each rank gathered: column along Cout, row along Cin
        column = dict(column, k_q=tp.all_gather_values(column["k_q"], 0),
                      s_k=tp.all_gather_values(column["s_k"], 0))
        row = dict(row, k_q=tp.all_gather_values(row["k_q"], 1),
                   x_q=tp.all_gather_values(row["x_q"], 1),
                   s_c=tp.all_gather_values(row["s_c"], 0))
    return dict(out, column=column, row=row)


def _tp_ops_task(out_dir: str):
    distributed.set_model_axis(TP_MODEL_AXIS)
    return {"conv_pair": conv_pair_run(), "sean_norm_0": sean_run(False),
            "sean_norm_1": sean_run(True), "eval_generator": eval_generator_run(),
            "int8_generator": int8_generator_run(),
            "int8_jax_weights": int8_jax_weights_run(out_dir),
            **{f"int8_convs_{m}": int8_convs_run(m) for m in INT8_CONV_MODES}}


def tp_trainer_exp(root: str, **train):
    """The tensor-parallel trainer tasks' experiment: the tiny model at
    batch 2 (one data rank), an evaluation of 4 samples after 2 steps,
    laid out as `tp_mesh` where there are ranks."""
    exp = tiny_test_experiment(checkpoints_dir=root)
    mesh = tp_mesh() if distributed.world_size() > 1 else MeshConfig()
    return exp.replace(mesh=mesh, train=dataclasses.replace(
        exp.train, evaluation_freq=4, num_evaluation_samples=4, **train))


def trainer_batches():
    """Two NHWC batches of 2 (tests/test_torch_trainer.py's)."""
    import numpy as np

    cfg = tiny_test_experiment().model
    rng = np.random.RandomState(0)
    return [{"image_hr": np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32),
             "label": rng.randint(0, cfg.label_nc, (2, 32, 32)).astype(np.int32)}
            for _ in range(2)]


def trainer_state(trainer):
    """The trainer's networks and both optimizers' states, gathered."""
    import copy

    return {"snapshot": snapshot(trainer.system), "step": trainer.state.step,
            "opt": {k: copy.deepcopy(shard.gather_optimizer_state(getattr(trainer.state, k)))
                    for k in ("opt_g", "opt_d")}}


def _tp_trainer_task(out_dir: str):
    """(1) Two fresh steps with an in-training evaluation, the latest
    checkpoint written, the state, and the evaluator on the gathered
    networks; (2) the one-process checkpoint in OUT_DIR/one restored (the
    state right after) and one more step."""
    from deepsee_torch.eval.evaluator import evaluate_set
    from deepsee_torch.train import loop

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fresh = loop.Trainer(tp_trainer_exp(os.path.join(out_dir, "tp")), device="cpu")
        fresh.run(trainer_batches(), max_steps=2)
        result = evaluate_set(InferenceEvaluator(fresh._inference_system(), 4),
                              trainer_batches())
        result.pop("eval_seconds")
        out = {"fresh": trainer_state(fresh), "eval": result}
        resumed = loop.Trainer(tp_trainer_exp(os.path.join(out_dir, "one")), device="cpu",
                               continue_train=True)
        out["restored"] = trainer_state(resumed)
        resumed.run(trainer_batches(), max_steps=3)
        out["resumed"] = trainer_state(resumed)
    return out


def _tp_cli_task(out_dir: str):
    """python -m deepsee_torch.train --multihost --model_axis 2 on the
    tiny model (its own process group)."""
    from deepsee_torch.train import __main__ as train_cli

    def preset(name):
        return tiny_test_experiment().replace(name=name)

    os.environ["MASTER_PORT"] = os.environ["CLI_PORTS"].split(",")[0]
    with _Patches((train_cli, "get_preset", preset)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        code = train_cli.main(["--name", "tiny", "--multihost", "--model_axis", "2", "--device",
                               "cpu", "--synthetic", "--batch_size", "2", "--max_steps", "2",
                               "--checkpoints_dir", os.path.join(out_dir, "tp_cli")])
    return {"train_exit": code}


# -- spatial sharding (tests/test_torch_sp_*.py) --------------------------------------

# the windows of the presets, (k, s, p[, padding mode]): the 3x3 convs at
# stride 1 and 2, D's 4x4 convs at stride 2 and 1, the "nospade" generator's
# reflection-padded 3x3 conv; "pool" the 3x3 stride-2 pool between D's
# scales, "d_chain" the pool and D's four windows in a row (uneven stripes,
# and at 1 x 4 stripes of one row under a 4-row window)
SP_WINDOWS = {"3x3s1": [(3, 1, 1)], "3x3s2": [(3, 2, 1)], "4x4s2": [(4, 2, 2)],
              "4x4s1": [(4, 1, 2)], "3x3reflect": [(3, 1, 1, "reflect")], "pool": [],
              "d_chain": [(4, 2, 2), (4, 2, 2), (4, 1, 2), (4, 1, 2)]}
# the window cases, the tiny model's discriminator and a train-mode
# "nospade" generator block (Pix2PixResnetBlock: its reflect windows, its
# instance norms across the stripes)
SP_OPS_CASES = list(SP_WINDOWS) + ["discriminator", "pix2pix"]
SP_PLANTED = ("zero_halo", "stripe_stats")


def sp_mesh(model_axis: int = 2) -> MeshConfig:
    """This world laid out as (world / model_axis) x model_axis, spatial."""
    return MeshConfig(data_axis=distributed.world_size() // model_axis, model_axis=model_axis,
                      partition="spatial")


def planted(fault):
    """The planted faults the spatial tests must catch: "zero_halo" (every
    rank pads its own stripe's edges with zeros: the halo exchange returns
    zeros) and "stripe_stats" (K1's statistics per stripe: the all-reduces
    of its partials and sums do nothing)."""
    from deepsee_torch.parallel import spatial

    if fault is None:
        return _Patches()
    if fault == "zero_halo":
        gather = spatial._all_gather
        return _Patches((spatial, "_all_gather", lambda kind, t: (
            [torch.zeros_like(t)] * distributed.model_world() if kind.startswith("halo")
            else gather(kind, t))))
    if fault == "stripe_stats":
        return _Patches((spatial, "_stats_reduce", lambda kind, group: (lambda t: None)))
    raise ValueError(fault)


def _stripe_rows(full, rows):
    """This rank's rows of a whole NCHW tensor under the layout `rows` (the
    whole tensor where nothing is striped)."""
    if rows is None:
        return full
    lo, hi = rows.span()
    return full[:, :, lo:hi]


def window_run(case: str, seed: int = 21, width: int = 12):
    """A window case of SP_WINDOWS on (2, 8, 32, width), "pix2pix" (a
    train-mode Pix2PixResnetBlock of 8 channels on the same) or
    "discriminator" (the tiny model's multiscale D in train mode, its
    instance norms across the stripes, on 64 rows: its pooled scale leaves
    each of 4 ranks a row) float32, laid out as the active mesh stripes it:
    the output and the input's gradient (gathered whole) and the parameters'
    gradients (summed over the model group) of sum(y * w) for seeded x, w."""
    from deepsee_torch.models.discriminator import MultiscaleDiscriminator
    from deepsee_torch.models.generator import Pix2PixResnetBlock
    from deepsee_torch.ops.pooling import avg_pool_3x3_s2
    from deepsee_torch.parallel import spatial

    g = torch.Generator().manual_seed(seed)
    cfg = tiny_test_experiment().model
    channels, height = (cfg.semantic_nc + 3, 64) if case == "discriminator" else (8, 32)
    x_full = torch.randn(2, channels, height, width, generator=g)
    rows = spatial.Rows.even(height) if spatial.active() else None
    x = _stripe_rows(x_full, rows).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    if case == "discriminator":
        net = MultiscaleDiscriminator(cfg).train()
        for m in net.modules():
            if hasattr(m, "init_params"):
                m.init_params(g)
        outs = [t for scale in net(x) for t in scale]
        layouts = ([r for scale in net.output_rows(height) for r in scale] if rows is not None
                   else [None] * len(outs))
        params = list(net.parameters())
    elif case == "pix2pix":
        block = Pix2PixResnetBlock(channels).train()
        for m in block.modules():
            if hasattr(m, "init_params"):
                m.init_params(g)
        with torch.no_grad():  # weights of trained-like size, not the init's gain 0.02
            for p in block.parameters():
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
        outs, layouts, params = [block(x)], [rows], list(block.parameters())
    else:
        convs = []
        for k, s, p, *mode in SP_WINDOWS[case]:
            conv = tlayers.Conv2d(channels, channels, k, s, p, padding_mode=(mode or ["zeros"])[0])
            with torch.no_grad():
                conv.weight.copy_(0.2 * torch.randn(conv.weight.shape, generator=g))
                conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, generator=g))
            convs.append(conv)
        y, r = x, rows
        if case in ("pool", "d_chain"):
            y = avg_pool_3x3_s2(y, r)
            r = None if r is None else r.window(3, 2, 1)
        for conv in convs:
            y = tlayers.leaky_relu(conv(y, rows=r))
            r = None if r is None else r.window(conv.kernel_size, conv.stride, conv.padding)
        outs, layouts, params = [y], [r], [p for c in convs for p in c.parameters()]
    loss = 0.0
    for t, r in zip(outs, layouts):
        height_out = t.shape[2] if r is None else r.height
        w = torch.randn(t.shape[0], t.shape[1], height_out, t.shape[3], generator=g)
        loss = loss + (t * _stripe_rows(w, r)).sum()
    loss.backward()
    spatial.sum_replicated_grads(params)
    return {"outs": [spatial.gather_rows(t.detach(), 2, r) for t, r in zip(outs, layouts)],
            "x_grad": spatial.gather_rows(x.grad, 2, rows),
            "grads": [p.grad.clone() for p in params],
            "rows": [None if r is None else r.bounds for r in layouts]}


def _sp_ops_task(out_dir: str):
    """Every window case laid out 1 x world, and the discriminator case
    under each planted fault, with the collectives' counts."""
    from deepsee_torch.parallel import spatial

    spatial.use_mesh(MeshConfig(model_axis=distributed.world_size(), partition="spatial"))
    spatial.reset_counts()
    out = {case: window_run(case) for case in SP_OPS_CASES}
    out["counts"] = {k: dict(v) for k, v in spatial.counts.items()}
    for fault in SP_PLANTED:
        with planted(fault):
            out[fault] = window_run("discriminator")
    return out


SP_INFER_CONFIGS = ("tiny", "fmcap")


def sp_infer_exp(name: str):
    """The inference configurations held against the JAX package: the tiny
    one (tests/test_spatial_sharding.py) and the 32x PureSEAN tail with the
    fm-cap quirk at crop 128 (tests/test_512_spatial.py)."""
    from deepsee_torch.config import DataConfig, Experiment, ModelConfig, TrainConfig

    if name == "tiny":
        return tiny_test_experiment().replace(is_train=False)
    cfg = ModelConfig(start_size=8, crop_size=128, load_size=512, ngf=2, nef=2,
                      regional_style_size=128, max_fm_size=32, add_noise=False,
                      compute_dtype="float32")
    return Experiment(name="t512sp", model=cfg, train=TrainConfig(batch_size=2),
                      data=DataConfig(), is_train=False)


def sp_infer_run(name: str, weights, batch, planted_fault=None):
    """preprocess -> encode (mini trunk) -> generate, no noise, on this data
    rank's rows of `batch` (numpy NHWC) and this model rank's stripe of H:
    the fake gathered whole and the style."""
    from deepsee_torch.parallel import spatial

    system = SRSystem(sp_infer_exp(name), device="cpu")
    for net, module in system.networks().items():
        module.load_state_dict(weights[net])
    batch = spatial.shard_rows(rows(batch, distributed.data_rank(), distributed.data_world()))
    with planted(planted_fault):
        fake, style = system.generate(system.preprocess(batch), use_full=False, no_noise=True)
    return {"fake": spatial.gather_rows(fake, dim=1).clone(), "style": style.clone()}


# int8 inference on stripes: every conv of at least this many channels
# quantizes, as the JAX package's mesh test runs it
# (tests/test_int8_inference.py:191-243)
SP_INT8_MIN_CH = 8
SP_INT8_MODES = ("smooth", "nosmooth")
# the planted fault of the int8 runs: no MAX all-reduce, each stripe
# quantizing with its own maxima
SP_INT8_PLANTED = "stripe_maxima"


class _StripedScales:
    """Every quantized conv's s_c, s_k, s_x and k_q while open, and one
    process's quantization of the conv's input gathered whole (the model
    group's stripes): {"got": ..., "want": ...} per conv in call order, from
    the wrappers of (b) and (c) that `int8_conv_striped` calls."""

    def __init__(self):
        from deepsee_torch.ops import int8conv as ic

        self.ic, self.calls = ic, []
        self.saved = ic.quantize_weight, ic.quantize_activation

    def __enter__(self):
        from deepsee_torch.parallel import spatial

        weight_fn, act_fn = self.saved

        def weight(w, mx_raw, mx, smooth):
            out = weight_fn(w, mx_raw, mx, smooth)
            self.calls.append({"weight": w.detach().clone(), "smooth": smooth,
                               "got": dict(zip(("s_c", "s_k", "s_x", "k_q"), out))})
            return out

        def activation(x, s_c, s_x):
            call = self.calls[-1]
            q = self.ic.quantize_plain(spatial.gather_rows(x), call.pop("weight"),
                                       call["smooth"])
            call["want"] = {"s_c": q.s_c, "s_k": q.s_k, "s_x": q.s_x, "k_q": q.k_q}
            return act_fn(x, s_c, s_x)

        self.ic.quantize_weight, self.ic.quantize_activation = weight, activation
        return self

    def __exit__(self, *exc):
        self.ic.quantize_weight, self.ic.quantize_activation = self.saved


def sp_int8_run(weights, batch, mode: str = "smooth", fault=None, nudge_seed=None):
    """The tiny system of SP_INFER_CONFIGS holding `weights` under
    int8_inference(min_ch=SP_INT8_MIN_CH, smooth=mode == "smooth"): the
    preprocess -> encode -> generate of `sp_infer_run` on this data rank's
    rows of `batch` and this model rank's stripes (the whole batch where
    there are no ranks): the fake gathered whole, the quantized convs and
    the MAX all-reduces (calls, bytes) and halos (calls, bytes) they made,
    and where the map is striped every conv's scales beside one process's
    quantization of its gathered input (`_StripedScales`).  `fault`
    SP_INT8_PLANTED: the MAX all-reduce the identity.  `nudge_seed`: the
    weights nudged by one ulp (`nudge`)."""
    from deepsee_torch.ops import int8conv as ic
    from deepsee_torch.parallel import spatial

    system = SRSystem(sp_infer_exp("tiny"), device="cpu")
    for net, module in system.networks().items():
        module.load_state_dict(weights[net])
    if nudge_seed is not None:
        nudge(system, 1, nudge_seed)  # G and E: an inference system has no D
    batch = spatial.shard_rows(rows(batch, distributed.data_rank(), distributed.data_world()))
    patches = (_Patches((spatial, "all_reduce_max", lambda t: t)) if fault == SP_INT8_PLANTED
               else _Patches())
    recorder = _StripedScales() if spatial.active() else _Patches()
    ic.reset_launches()
    spatial.reset_counts()
    with tlayers.int8_inference(min_ch=SP_INT8_MIN_CH, smooth=mode == "smooth"), patches, \
            recorder:
        pre = system.preprocess(batch)
        counts = {k: dict(spatial.counts[k]) for k in ("max", "halo")}
        fake, _ = system.generate(pre, use_full=False, no_noise=True)
        counts = {k: {n: spatial.counts[k][n] - counts[k][n] for n in ("calls", "bytes")}
                  for k in counts}
    return {"fake": spatial.gather_rows(fake, dim=1).clone(),
            "quantized_convs": ic.plain_calls["int8_conv"], "collectives": counts,
            "scales": getattr(recorder, "calls", None)}


def sp_nospade_run(data):
    """The tiny "nospade" generator (Pix2PixResnetBlock blocks) in eval mode
    holding data["weights"], on this data rank's rows of data["inputs"] (lr,
    seg, style: numpy NHWC, style (B, 19, S)) and this model rank's stripes
    of lr and seg: the fake (B, H, W, 3) gathered whole."""
    import numpy as np

    from deepsee_torch.models.generator import DeepSEEGenerator
    from deepsee_torch.parallel import spatial

    net = DeepSEEGenerator(tiny_test_experiment().model, variant="nospade").eval()
    net.load_state_dict(data["weights"])
    mine = rows(data["inputs"], distributed.data_rank(), distributed.data_world())
    if spatial.active():
        mine = dict(mine, lr=spatial.stripe(mine["lr"], 1), seg=spatial.stripe(mine["seg"], 1))

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)

    with torch.no_grad():
        fake = net(nchw(mine["lr"]), nchw(mine["seg"]), torch.from_numpy(mine["style"]))
    return {"fake": spatial.gather_rows(fake, dim=2).permute(0, 2, 3, 1).clone()}


def _sp_infer_task(out_dir: str):
    from deepsee_torch.parallel import spatial

    mesh = sp_mesh()
    spatial.use_mesh(mesh)
    out = {}
    for name in SP_INFER_CONFIGS:
        data = torch.load(os.path.join(out_dir, f"infer_{name}.pt"), weights_only=False)
        out[name] = sp_infer_run(name, data["weights"], data["batch"])
    data = torch.load(os.path.join(out_dir, "infer_tiny.pt"), weights_only=False)
    for mode in SP_INT8_MODES:
        out[f"int8_{mode}"] = sp_int8_run(data["weights"], data["batch"], mode)
    out["nospade"] = sp_nospade_run(torch.load(os.path.join(out_dir, "nospade.pt"),
                                               weights_only=False))
    if mesh.data_axis == 1:
        for fault in SP_PLANTED:
            out[f"tiny_{fault}"] = sp_infer_run("tiny", data["weights"], data["batch"], fault)
        out[f"int8_{SP_INT8_PLANTED}"] = sp_int8_run(data["weights"], data["batch"],
                                                     fault=SP_INT8_PLANTED)
    return out


def _sp_step_task(out_dir: str):
    """The spatial 1 x 2 (or 2 x 2) runs of the tiny model from
    OUT_DIR/weights.pt: "noise", and at one data rank "seeded" (held
    against JAX), "noise_remat" ("full") and the first "noise" step under
    each planted fault; the collectives' counts of the "noise" run."""
    from deepsee_torch.parallel import spatial

    weights = torch.load(os.path.join(out_dir, "weights.pt"), weights_only=True)
    mesh = sp_mesh()
    spatial.reset_counts()
    out = {"noise": step_run(weights, mesh=mesh)}
    out["counts"] = {k: dict(v) for k, v in spatial.counts.items()}
    if mesh.data_axis == 1:
        out["seeded"] = step_run(weights, model=dict(add_noise=False), seeded_draws=True,
                                 mesh=mesh)
        spatial.reset_counts()
        out["noise_remat"] = step_run(weights, train=dict(remat=True), mesh=mesh)
        out["remat_counts"] = {k: dict(v) for k, v in spatial.counts.items()}
        out["replayed"] = dict(spatial.replayed)
        for fault in SP_PLANTED:
            with planted(fault):
                out[fault] = step_run(weights, mesh=mesh, steps=1)
    return out


def sp_trainer_exp(root: str):
    """The spatial trainer task's experiment: the tiny model at batch 2, a
    display and an evaluation of 4 samples after 2 steps, laid out as
    `sp_mesh` where there are ranks."""
    exp = tp_trainer_exp(root)
    mesh = sp_mesh() if distributed.world_size() > 1 else MeshConfig()
    return exp.replace(mesh=mesh, train=dataclasses.replace(exp.train, display_freq=4))


def _sp_trainer_task(out_dir: str):
    """(1) Two fresh steps with a display and an evaluation, the latest
    checkpoint written, the state and the displayed visuals; (2) the
    one-process checkpoint in OUT_DIR/one restored (the state right after)
    and one more step."""
    from deepsee_torch.train import loop

    shown = {}

    class Capture(loop.Visualizer):
        def display_current_results(self, visuals, epoch, step):
            shown.update(visuals)

    with _Patches((loop, "Visualizer", Capture)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fresh = loop.Trainer(sp_trainer_exp(os.path.join(out_dir, "sp")), device="cpu")
        fresh.run(trainer_batches(), max_steps=2)
        out = {"fresh": trainer_state(fresh), "shown": shown}
        resumed = loop.Trainer(sp_trainer_exp(os.path.join(out_dir, "one")), device="cpu",
                               continue_train=True)
        out["restored"] = trainer_state(resumed)
        resumed.run(trainer_batches(), max_steps=3)
        out["resumed"] = trainer_state(resumed)
    return out


def _sp_cli_task(out_dir: str):
    """python -m deepsee_torch.train --multihost --model_axis 2 --partition
    spatial on the tiny model (its own process group)."""
    from deepsee_torch.train import __main__ as train_cli

    def preset(name):
        return tiny_test_experiment().replace(name=name)

    os.environ["MASTER_PORT"] = os.environ["CLI_PORTS"].split(",")[0]
    with _Patches((train_cli, "get_preset", preset)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        code = train_cli.main(["--name", "tiny", "--multihost", "--model_axis", "2",
                               "--partition", "spatial", "--device", "cpu", "--synthetic",
                               "--batch_size", "2", "--max_steps", "2", "--checkpoints_dir",
                               os.path.join(out_dir, "sp_cli")])
    return {"train_exit": code}


TASKS = {"step": _step_task, "norms": _norms_task, "eval": lambda out_dir: eval_run(),
         "trainer": _trainer_task, "tp_step": _tp_step_task, "tp_wide": _tp_wide_task,
         "tp_ops": _tp_ops_task, "tp_trainer": _tp_trainer_task, "sp_ops": _sp_ops_task,
         "sp_infer": _sp_infer_task, "sp_step": _sp_step_task, "sp_trainer": _sp_trainer_task}
# tasks that join no group themselves (the CLIs do, with --multihost)
UNGROUPED = {"cli": _cli_task, "tp_cli": _tp_cli_task, "sp_cli": _sp_cli_task}


def free_ports(n: int):
    """`n` distinct ports that were free a moment ago."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


class Spawned:
    """This file started as `world` ranks on localhost (fresh ports), each
    rank's output in OUT_DIR/rank<R>.log; `results` waits for them."""

    def __init__(self, out_dir: str, tasks, world: int = 2):
        import subprocess

        port, *cli_ports = free_ports(3)
        self.out_dir, self.world, self.procs, self.logs = out_dir, world, [], []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       CLI_PORTS=",".join(map(str, cli_ports)), OMP_NUM_THREADS="1")
            self.logs.append(os.path.join(out_dir, f"rank{rank}.log"))
            with open(self.logs[-1], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), out_dir, ",".join(tasks)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))

    def results(self, timeout: float = 150.0):
        """Wait for every rank; the first to fail, or the timeout, ends them
        all and raises with their output.  Each rank's results and output."""
        import time

        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in self.procs):
                if any(p.returncode for p in self.procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        outputs = []
        for path in self.logs:
            with open(path) as f:
                outputs.append(f.read())
        if any(p.returncode for p in self.procs):
            raise RuntimeError("data-parallel workers failed: " + repr(
                [(r, p.returncode, o[-4000:]) for r, (p, o) in
                 enumerate(zip(self.procs, outputs))]))
        return [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)], outputs


def main() -> None:
    out_dir, tasks = sys.argv[1], sys.argv[2].split(",")
    torch.set_num_threads(1)
    shard.MIN_SHARD_CH = TP_MIN_SHARD_CH
    grouped = [task for task in tasks if task not in UNGROUPED]
    results = {}
    if grouped:
        distributed.init_distributed("gloo", device="cpu")
        try:
            results = {task: TASKS[task](out_dir) for task in grouped}
        finally:
            distributed.reset_layout()
            torch.distributed.destroy_process_group()
    for task in tasks:
        if task in UNGROUPED:
            results[task] = UNGROUPED[task](out_dir)
    torch.save(results, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


if __name__ == "__main__":
    main()
