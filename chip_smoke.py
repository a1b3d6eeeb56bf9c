#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepsee_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds every CUDA kernel from deepsee_torch/csrc with nvcc.
2. Kernel phase: holds each kernel against its plain PyTorch version, in
   bf16 and float32, at the shapes the paths give it (`kernel_shapes`: the
   main path, the full trunk at 256^2 b32 and 512^2 b8, the 32x generator
   at b8) and, for the instance mode, at batch 1 and at the generator's
   instance-norm shape.  Times each shape in bf16 by device time: its calls
   are captured in a CUDA graph and the replays timed with CUDA events
   (`_device_ms`), beside its bound, the plain version and one library call
   (F.batch_norm or F.instance_norm); the host's own microseconds per
   wrapper call are printed apart (`_host_us`).
3. Main path: 8x 256^2 independent inference (preset 8x_independent_256x256,
   batch 32, bf16): preprocess -> mini style encode -> generate, with seeded
   random weights (randomize_weights).  Checks the output, that every
   kernel launch of the path happened, the bf16 output against a float32
   run, and a float32 card run against the plain CPU path.  Then the
   full-trunk style encode (use_full=True) on the same system: 5 instance
   launches, a finite style, bf16 against float32.
4. Guided paths: 8x_guided_256x256 at batch 32 and 32x_guided_512x512 at
   batch 8, bf16: preprocess (one-hot of the guiding label too) -> the full
   trunk on the guiding image -> generate, with the same checks, and K1's
   device time per call of each path beside its bound.  The 32x path runs
   again with fold_upsampled_mod_conv=True: both timed, the outputs
   compared.
5. Times each path (ms per batch, img/s, stages, peak memory) and traces
   one call with torch.profiler (device time by kernel and category, the
   idle share).
6. Explorative phase: the 12 modes of deepsee_torch/inference/modes.py and
   baseline_upscale on the main path's system (bf16, B=4, n=5): shapes,
   finite values, the K1 launches each mode's own calls imply (one encode
   and one generator call, or fewer), the same torch.Generator seed twice
   gives the same output and another seed another one (inference_noise,
   inference_multi_modal); ms per mode by CUDA events after one warm-up.
7. Serving phase (as scripts/bench_server.py drives the JAX daemon):
   exports 8x_independent_256x256 and 8x_guided_256x256 (seeded weights,
   trace batch 8) with torch.export on the card, holds each program
   against the live system (bf16 PSNR; float32 with TF32 off), starts one
   ServingServer with both, and sends 128 mixed independent / styled /
   guided requests from 16 client threads over /v1/super_resolve_bin.
   Every response is held against the loaded program called directly on
   the batch the daemon formed for it; no request may fail; K1's launches in the window must be
   each program's batches times its launches per batch.  Prints
   requests/s, p50/p99 latency and batch fill per program.
8. Training phase (`training_phase`): each training kernel (batch
   statistics, instance with statistics out, both backwards) against its
   plain version at every shape of the b4 and b16 steps, bf16 and float32,
   timed at b4 with its launch plan and the GB/s of the bytes its design
   moves; a float32 step on the card against the CPU, beside the
   CPU's own spread under weights nudged by 1 and 8 float32 ulps; bf16
   step gradients against float32; the faithful b4 and b16 and reuse_fake
   b4 steps with K1's launches per step checked against `train_norms`,
   timed and profiled; faithful against reuse_fake at b16 in turns; the
   Trainer with a save and a resume; the training CLI for 20 steps.

Prints the card's name and power limit, one {"kernels": [...]} line (the
inference kernels per main-path call, the training kernels per faithful b4
step), and as the last line {"ok": true, "device": {...}}.  Any
failure exits non-zero; without a CUDA device it exits non-zero at once and
prints no result.  float32 comparisons run with TF32 off
(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
False).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepsee_torch import serve
from deepsee_torch import server as server_mod
from deepsee_torch import system as system_mod
from deepsee_torch.config import ModelConfig, get_preset
from deepsee_torch.inference import modes
from deepsee_torch.ops import _build
from deepsee_torch.ops import modnorm as mn
from deepsee_torch.system import SRSystem
from deepsee_torch.train import steps as train_steps
from deepsee_torch.train.loop import Trainer
from deepsee_torch.train.state import create_train_state, g_params
from deepsee_torch.utils.images import tensor2im
from deepsee_torch.weights import load_reference_checkpoint, randomize_weights

PRESET = "8x_independent_256x256"
BATCH = 32
PRESET_512 = "32x_guided_512x512"
BATCH_512 = 8
# the guided paths: preset -> batch, and K1's launches per call of each
GUIDED_PATHS = {"8x_guided_256x256": BATCH, PRESET_512: BATCH_512}
GUIDED_LAUNCHES = {"8x_guided_256x256": {"affine": 10, "instance": 5},
                   PRESET_512: {"affine": 14, "instance": 5}}
SEED = 0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

# bf16 output vs the float32 output of the same weights and inputs, PSNR over
# the [-1, 1] range.  The first H100 run measured 55.0 dB (PERF.md, PR 1);
# 45 dB leaves room for other cuDNN algorithm choices.
MIN_BF16_PSNR_DB = 45.0
# float32 card path (cuDNN, TF32 off, kernels) vs float32 CPU path (plain
# versions), batch 1: summation-order differences through ~25 convs; the
# first H100 run measured 6.7e-6 (PERF.md, PR 1).
MAX_F32_CPU_DIFF = 1e-4
# the serving programs, float32 (TF32 off), against the live system on the
# same inputs: the same operations on the same device
MAX_F32_SERVED_DIFF = 1e-5
# a served response against the loaded program called directly on the
# batch the daemon formed for it: uint8 levels (tensor2im truncates)
MAX_SERVED_U8_DIFF = 1
# the explorative phase: batch, variants per sample, noise
MODES_B, MODES_N = 4, 5
MODES_KNOBS = dict(noise_delta=0.3, n_interpolation=MODES_N)
# the serving phase (scripts/bench_server.py's defaults)
SERVE_PRESETS = {"indep": PRESET, "guided": "8x_guided_256x256"}
SERVE_BATCH, SERVE_CLIENTS, SERVE_REQUESTS = 8, 16, 128
# the device of the explorative and serving phases
DEVICE = "cuda"

# bf16 full-trunk style vs the float32 one (TF32 off), relative to
# max|float32 style|: five bf16 convs and norms at ~3 significant digits
# each; the first H100 runs measured 9.5e-3 (PERF.md).
MAX_FULL_STYLE_REL_DIFF = 0.05

# name in the kernels line -> (modnorm mode, the one library call timed beside it)
KERNEL_INFO = {
    "modnorm_affine": ("affine", "F.batch_norm (eval, running stats; without the fused "
                                 "modulation and leaky ReLU)"),
    "modnorm_instance": ("instance", "F.instance_norm (without the fused leaky ReLU)"),
}
KERNEL_SOURCE = "deepsee_torch/csrc/modnorm.cu"
TPU_KERNEL = ("deepsee_tpu/ops/pallas/modnorm.py:38 "
              "(git show fe9393d^:deepsee_tpu/ops/pallas/modnorm.py)")


def log(msg: str) -> None:
    print(msg, flush=True)


# -- the modnorm launches of each path -------------------------------------

def generator_norms(cfg: ModelConfig, batch: int):
    """Every modnorm launch of one generator call, grouped by shape:
    [(mode, (B, C, H, W), with_mod, lrelu, launches per call)]."""
    s, c = cfg.start_size, 16 * cfg.ngf
    mode = "instance" if cfg.norm_g_spec.param_free_kind == "instance" else "affine"
    # head_0 at s, G_middle_0/1 at 2s, up_i at 2^(i+2) s; two norms per block
    blocks = [s, 2 * s, 2 * s] + [s * 2 ** (i + 2) for i in range(cfg.n_blocks - 1)]
    return [(mode, (batch, c, hw, hw), True, True, 2 * blocks.count(hw))
            for hw in sorted(set(blocks))]


def mini_trunk_norms(cfg: ModelConfig, batch: int):
    """The five instance norms of a mini-trunk style encode on the LR image:
    [((B, C, H, W), lrelu)] of MiniTrunk initial/conv0/conv1 at s, conv2 at
    2s, and the final head at 2s."""
    s, nef = cfg.start_size, cfg.nef
    return [((batch, nef, s, s), True), ((batch, 2 * nef, s, s), True),
            ((batch, 4 * nef, s, s), True), ((batch, 8 * nef, 2 * s, 2 * s), True),
            ((batch, cfg.regional_style_size, 2 * s, 2 * s), False)]


def full_trunk_norms(cfg: ModelConfig, batch: int):
    """The five instance norms of a full-trunk style encode on the HR image:
    [((B, C, H, W), lrelu)] of FullTrunk initial/down0/down1/up_conv and the
    final head."""
    s, nf = cfg.crop_size, cfg.nef
    return [((batch, nf, s, s), True), ((batch, 2 * nf, s // 2, s // 2), True),
            ((batch, 4 * nf, s // 4, s // 4), True),
            ((batch, 8 * nf, s // 2, s // 2), True),
            ((batch, cfg.regional_style_size, s // 2, s // 2), False)]


def path_norms(cfg: ModelConfig, batch: int, full_trunk: bool):
    """Every modnorm launch of one call of a path (style encode, generate):
    [(mode, (B, C, H, W), with_mod, lrelu, launches per call)]."""
    trunk = full_trunk_norms if full_trunk else mini_trunk_norms
    return generator_norms(cfg, batch) + [("instance", shape, False, lrelu, 1)
                                          for shape, lrelu in trunk(cfg, batch)]


def expected_launches(norms):
    out = {mode: 0 for mode in mn.launches}
    for mode, _, _, _, per_call in norms:
        out[mode] += per_call
    return out


def kernel_shapes(cfg: ModelConfig, batch: int):
    """Every shape the kernel phase holds and times:
    [(group, mode, (B, C, H, W), with_mod, lrelu, launches per main-path call)];
    only the "main path" group has launches on the main path.  The guided
    paths' shapes are the main path's generator shapes with the full trunk
    at 256^2 b32 (8x), and the 32x generator with the full trunk at 512^2 b8."""
    rows = [("main path",) + r for r in path_norms(cfg, batch, full_trunk=False)]
    mini = [r for r in rows if r[1] == "instance"]
    rows += [("batch 1", mode, (1,) + shape[1:], m, lrelu, 0)
             for _, mode, shape, m, lrelu, _ in mini]
    rows += [(f"full trunk {cfg.crop_size}^2", "instance", shape, False, lrelu, 0)
             for shape, lrelu in full_trunk_norms(cfg, batch)]
    cfg512 = get_preset(PRESET_512).model
    rows += [(f"full trunk {cfg512.crop_size}^2", "instance", shape, False, lrelu, 0)
             for shape, lrelu in full_trunk_norms(cfg512, BATCH_512)]
    # norm_g=...instance3x3: the generator's 512-channel trunk at 64^2, with
    # its 1024-channel modulation
    rows.append(("generator instance", "instance", (batch, 16 * cfg.ngf, 64, 64),
                 True, True, 0))
    # the 32x generator; at 512^2 its modulation has 2^31 elements
    rows += [("32x generator", mode, shape, m, lrelu, 0)
             for mode, shape, m, lrelu, _ in generator_norms(cfg512, BATCH_512)]
    return rows


# -- kernel phase ------------------------------------------------------------

def _kernel_inputs(shape, with_mod, dtype, gen):
    b, c, h, w = shape
    dev = torch.device("cuda")
    x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    mod = None
    if with_mod:
        mod = torch.randn((b, 2 * c, h, w), generator=gen, device=dev).to(dtype)
        mod = mod.contiguous(memory_format=torch.channels_last)
    mean = torch.randn(c, generator=gen, device=dev) * 0.5
    var = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
    return x, mod, mean, var


def _within_tolerance(got, want, mode, dtype):
    """The affine mode does the plain version's float32 operations in the
    same order (near-exact: 1e-6 of max|out|); the instance mode's two-pass
    chunk statistics, merged across the cluster, differ from the plain
    version's reductions by a few float32 ulps (2e-6 of max|out|).  bf16
    adds the one rounding both make from float32, which may fall on either
    side: 1 bf16 ulp of |out|, elementwise."""
    diff = (got.float() - want.float()).abs()
    slack = (1e-6 if mode == "affine" else 2e-6) * max(1.0, float(want.abs().max()))
    if dtype == torch.bfloat16:
        slack = slack + torch.finfo(torch.bfloat16).eps * want.float().abs()
    return bool((diff <= slack).all())


def _event_ms(fn, reps: int = 10) -> float:
    """Mean ms per call of `fn` by CUDA events around a host loop, after
    warm-up: for stages of the path, whose device work dwarfs the host's."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fns, target_ms: float = 20.0, max_calls: int = 1000) -> float:
    """Device ms per call of cycling through `fns`: the calls are captured in
    a CUDA graph and five replays timed with CUDA events, so the host's work
    per call (checks, allocation, the ctypes call) is not in the number; the
    gaps between the graph's kernels are.  The graph holds enough rounds of
    `fns` to last about `target_ms`."""
    for fn in fns:  # warm-up: builds, allocator, cuDNN plans
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for fn in fns:
        fn()
    end.record()
    end.synchronize()
    round_ms = max(start.elapsed_time(end), 1e-3)  # host-bound for small calls: an upper bound
    rounds = int(max(1, min(max_calls // len(fns), math.ceil(target_ms / round_ms))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (5 * rounds * len(fns))
    del graph
    return ms


def _host_us(fn, calls: int = 20) -> float:
    """Host microseconds per call of `fn` (wrapper checks, allocation, the
    launch), with the device queue far from full."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _bound_ms(mode, shape, with_mod, lrelu, elt_bytes):
    """Least time for the function: each input read once, the output written
    once, over the HBM rate; or its float32 operations over the CUDA-core
    rate; whichever is larger."""
    b, c, h, w = shape
    n = b * c * h * w
    tensors = 2 + (2 if with_mod else 0)            # x, out (+ the 2C mod)
    nbytes = n * tensors * elt_bytes + (2 * c * 4 if mode == "affine" else 0)
    per_elt = (2 if mode == "affine" else 7) + (2 if with_mod else 0) + (1 if lrelu else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n * per_elt / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _instance_variant(shape, dtype) -> str:
    # an earlier version of the package, timed by this script for comparison,
    # has no plan
    plan = getattr(mn, "instance_plan", None)
    return plan(shape, dtype).variant if plan else "one block per slab"


def kernel_phase(cfg: ModelConfig, batch: int):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for group, mode, shape, with_mod, lrelu, per_call in kernel_shapes(cfg, batch):
        for dtype in (torch.bfloat16, torch.float32):
            x, mod, mean, var = _kernel_inputs(shape, with_mod, dtype, gen)
            kw = dict(stats=mode, mean=mean, var=var, lrelu=lrelu)
            got = mn.modnorm(x, mod, **kw)
            torch.cuda.synchronize()
            want = mn.modnorm_plain(x, mod, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = _within_tolerance(got, want, mode, dtype)
            row = {"group": group, "mode": mode, "shape": list(shape), "mod": with_mod,
                   "lrelu": lrelu, "dtype": str(dtype).replace("torch.", ""),
                   "launches_per_call": per_call, "max_abs_err": err,
                   "max_abs_out": float(want.abs().max()), "ok": ok}
            if mode == "instance":
                row["variant"] = _instance_variant(shape, dtype)
                if hasattr(mn, "clusters_in_flight"):
                    row["clusters_in_flight"] = mn.clusters_in_flight(shape, dtype, with_mod,
                                                                      lrelu)
            del got, want
            if dtype == torch.bfloat16:  # the main path's type: time it
                set_bytes = x.numel() * x.element_size() * (4 if with_mod else 2)
                pool = [(x, mod)] + [
                    _kernel_inputs(shape, with_mod, dtype, gen)[:2]
                    for _ in range(max(0, math.ceil(120e6 / set_bytes) - 1))]
                row["ms"] = _device_ms([lambda a=a, m=m: mn.modnorm(a, m, **kw)
                                        for a, m in pool])
                row["host_us"] = _host_us(lambda: mn.modnorm(x, mod, **kw))
                row["plain_ms"] = _device_ms([lambda a=a, m=m: mn.modnorm_plain(a, m, **kw)
                                              for a, m in pool])
                # one library call for the normalization, without the fused
                # modulation and leaky ReLU where the row has them
                if mode == "instance":
                    row["library_ms"] = _device_ms([lambda a=a: F.instance_norm(a, eps=1e-5)
                                                    for a, _ in pool])
                else:
                    row["library_ms"] = _device_ms([
                        lambda a=a: F.batch_norm(a, mean, var, training=False, eps=1e-5)
                        for a, _ in pool])
                row["bound_ms"], row["bound_by"] = _bound_ms(
                    mode, shape, with_mod, lrelu, x.element_size())
                row["bound_share"] = row["bound_ms"] / row["ms"]
                del pool
            log("kernel " + json.dumps(row))
            rows.append(row)
            del x, mod
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"modnorm disagrees with its plain version: {bad}")
    return rows


# -- path phase --------------------------------------------------------------

def make_batch(cfg: ModelConfig, batch: int, guided: bool = False):
    """A seeded batch as bench.py makes it: the HR image and its label map
    and, for the guided model, a guiding image and its label map."""
    rng = np.random.RandomState(SEED)
    hw = (batch, cfg.crop_size, cfg.crop_size)
    keys = ("image_hr", "label") + (("guiding_image", "guiding_label") if guided else ())
    return {k: (np.tanh(rng.randn(*hw, 3)).astype(np.float32) if "image" in k
                else rng.randint(0, cfg.label_nc, hw).astype(np.int32)) for k in keys}


def run_path(system: SRSystem, batch, use_full: bool = False):
    """One call of a path: preprocess -> style encode (the mini trunk on the
    LR image; with use_full the full trunk on the HR or guiding image) ->
    generate."""
    with torch.inference_mode():
        pre = system.preprocess(batch)
        style = system.encode_style(pre, use_full=use_full, no_noise=True)
        fake, _ = system.generate(pre, style=style)
    return fake


def _like(system: SRSystem, compute_dtype: str, device: str, **model) -> SRSystem:
    exp = system.exp.replace(model=dataclasses.replace(
        system.cfg, compute_dtype=compute_dtype, **model))
    other = SRSystem(exp, device=device)
    for name, net in system.networks().items():
        other.networks()[name].load_state_dict(net.state_dict())
    return other


def seeded_system(preset: str) -> SRSystem:
    """The preset's inference system on the card, bf16, with seeded random
    weights."""
    system = SRSystem(get_preset(preset).replace(is_train=False))
    system.init(torch.Generator().manual_seed(SEED))
    randomize_weights(system.networks().values(), torch.Generator().manual_seed(SEED + 1))
    return system


def drive_path(tag: str, system: SRSystem, batch, norms, use_full: bool):
    """Drive the path once with the launch counts set to 0 just before and
    read just after; check the launches and the output; then time the path
    and its stages and profile one call.  Returns (output, launches)."""
    cfg = system.cfg
    batch_n = len(batch["label"])
    expected = expected_launches(norms)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mn.reset_launches()
    fake = run_path(system, batch, use_full)
    torch.cuda.synchronize()
    launches = dict(mn.launches)
    log(f"{tag} launches per call: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{tag}: modnorm launches {launches} != {expected}")
    shape = (batch_n, cfg.crop_size, cfg.crop_size, 3)
    if tuple(fake.shape) != shape or not bool(torch.isfinite(fake).all()):
        raise AssertionError(f"{tag}: bad output: {tuple(fake.shape)}, finite="
                             f"{bool(torch.isfinite(fake).all())}")
    if float(fake.abs().max()) > 1.0:
        raise AssertionError(f"{tag}: output outside [-1, 1]")
    log(f"{tag} output {shape}: std {float(fake.std()):.4f}, "
        f"saturated share {float((fake.abs() > 0.99).float().mean()):.4f}")

    # timing: ms per batch of the whole path and of its stages
    torch.cuda.synchronize()
    reps = 10
    run_path(system, batch, use_full)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        run_path(system, batch, use_full)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    with torch.inference_mode():
        pre = system.preprocess(batch)
        style = system.encode_style(pre, use_full=use_full)
        pre_ms = _event_ms(lambda: system.preprocess(batch))
        enc_ms = _event_ms(lambda: system.encode_style(pre, use_full=use_full))
        gen_ms = _event_ms(lambda: system.generate(pre, style=style))
    timing = {"ms_per_batch": ms, "img_per_s": batch_n / ms * 1e3,
              "host_ms_per_batch": host_ms, "preprocess_ms": pre_ms,
              "encode_ms": enc_ms, "generate_ms": gen_ms,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"{tag} timing " + json.dumps(timing))
    profile_path(tag, system, batch, ms, use_full)
    return fake, launches


def psnr_db(a, b) -> float:
    """PSNR of a against b over the [-1, 1] range."""
    mse = float(((a.float() - b.float()) ** 2).mean())
    return 10 * math.log10(4.0 / mse) if mse > 0 else float("inf")


def check_bf16_psnr(tag: str, fake, fake32) -> None:
    """The bf16 output against the float32 one (TF32 off)."""
    mse = float(((fake - fake32) ** 2).mean())
    psnr = 10 * math.log10(4.0 / mse) if mse > 0 else float("inf")
    log(f"bf16 vs float32 {tag}: PSNR {psnr:.2f} dB (min {MIN_BF16_PSNR_DB}), "
        f"max abs diff {float((fake - fake32).abs().max()):.4f}")
    if not psnr >= MIN_BF16_PSNR_DB:
        raise AssertionError(f"bf16 {tag} PSNR {psnr:.2f} dB < {MIN_BF16_PSNR_DB}")


def check_card_vs_cpu(tag: str, system32: SRSystem, batch, use_full: bool):
    """The float32 card path against the plain CPU path, one sample.
    Returns the card's output."""
    one = {k: v[:1] for k, v in batch.items()}
    card1 = run_path(system32, one, use_full).cpu()
    t0 = time.perf_counter()
    cpu1 = run_path(_like(system32, "float32", "cpu"), one, use_full)
    cpu_s = time.perf_counter() - t0
    cpu_diff = float((card1 - cpu1).abs().max())
    log(f"float32 card vs CPU plain {tag}: max abs diff {cpu_diff:.2e} "
        f"(max {MAX_F32_CPU_DIFF}); the CPU took {cpu_s:.1f} s")
    if not cpu_diff <= MAX_F32_CPU_DIFF:
        raise AssertionError(f"card {tag} differs from the CPU path by {cpu_diff}")
    return card1


def path_phase(batch_n: int):
    """The main path: 8x 256^2 independent inference, then the full-trunk
    encode on the same system."""
    system = seeded_system(PRESET)
    cfg = system.cfg
    batch = make_batch(cfg, batch_n)
    fake, launches = drive_path("path", system, batch,
                                path_norms(cfg, batch_n, full_trunk=False), use_full=False)
    pre = system.preprocess(batch)
    style_full = full_trunk_encode(system, pre)

    # bf16 vs float32 (TF32 off) on the same weights and inputs
    torch.cuda.empty_cache()
    system32 = _like(system, "float32", "cuda")
    style32 = system32.encode_style(pre, use_full=True)
    rel = float((style_full - style32).abs().max() / style32.abs().max())
    log(f"bf16 vs float32 full-trunk style: max abs diff / max|style| {rel:.2e} "
        f"(max {MAX_FULL_STYLE_REL_DIFF}), max|style| {float(style32.abs().max()):.3e}")
    if not rel <= MAX_FULL_STYLE_REL_DIFF:
        raise AssertionError(f"bf16 full-trunk style differs from float32 by {rel}")
    del pre, style_full, style32
    check_bf16_psnr("path", fake, run_path(system32, batch))
    check_card_vs_cpu("path", system32, batch, use_full=False)
    return launches, system


def guided_phase(preset: str, batch_n: int, rows):
    """A guided path: preprocess (one-hot of the guiding label too) -> the
    full-trunk style encode on the guiding image -> generate, at full width.
    For the 32x preset, also the path with fold_upsampled_mod_conv."""
    system = seeded_system(preset)
    cfg = system.cfg
    batch = make_batch(cfg, batch_n, guided=True)
    norms = path_norms(cfg, batch_n, full_trunk=True)
    if expected_launches(norms) != dict(dict.fromkeys(mn.launches, 0), **GUIDED_LAUNCHES[preset]):
        raise AssertionError(f"{preset}: the path's norms give {expected_launches(norms)}, "
                             f"not {GUIDED_LAUNCHES[preset]}")
    tag = f"{preset} path"
    fake, launches = drive_path(tag, system, batch, norms, use_full=True)
    log(f"{tag} kernels " + json.dumps({mode: path_kernel_times(rows, norms, mode)
                                        for mode in ("affine", "instance")}))
    if cfg.load_size >= 512:
        fold_compare(tag, system, batch, fake, norms)
    system32 = _like(system, "float32", "cuda")
    del system
    torch.cuda.empty_cache()
    check_bf16_psnr(tag, fake, run_path(system32, batch, use_full=True))
    del fake
    torch.cuda.empty_cache()
    card1 = check_card_vs_cpu(tag, system32, batch, use_full=True)
    if cfg.load_size >= 512:
        one = {k: v[:1] for k, v in batch.items()}
        fold1 = run_path(_like(system32, "float32", "cuda", fold_upsampled_mod_conv=True),
                         one, use_full=True).cpu()
        diff = float((fold1 - card1).abs().max())
        log(f"{tag}: float32 folded vs literal, one sample: max abs diff {diff:.2e} "
            f"(max {MAX_F32_CPU_DIFF})")
        if not diff <= MAX_F32_CPU_DIFF:
            raise AssertionError(f"{tag}: the folded conv differs by {diff}")
    return launches


def fold_compare(tag: str, system: SRSystem, batch, fake, norms) -> None:
    """The path with fold_upsampled_mod_conv=True on the same weights: its
    launches, the two outputs' difference (bf16), and both timed in turns
    (literal, fold, fold, literal)."""
    fold = _like(system, system.cfg.compute_dtype, "cuda", fold_upsampled_mod_conv=True)
    mn.reset_launches()
    fake_fold = run_path(fold, batch, use_full=True)
    torch.cuda.synchronize()
    if dict(mn.launches) != expected_launches(norms):
        raise AssertionError(f"{tag} folded: modnorm launches {dict(mn.launches)}")
    if not bool(torch.isfinite(fake_fold).all()):
        raise AssertionError(f"{tag} folded: output not finite")
    times = {"literal": [], "fold": []}
    for name in ("literal", "fold", "fold", "literal"):
        sys_ = fold if name == "fold" else system
        times[name].append(_event_ms(lambda: run_path(sys_, batch, use_full=True), reps=5))
    log(f"{tag} fold_upsampled_mod_conv " + json.dumps({
        "literal_ms_per_batch": times["literal"], "fold_ms_per_batch": times["fold"],
        "max_abs_diff_bf16": float((fake_fold - fake).abs().max())}))


def full_trunk_encode(system: SRSystem, pre):
    """The full-trunk style encode (use_full=True) once, with its launch
    check, then timed."""
    cfg = system.cfg
    mn.reset_launches()
    style = system.encode_style(pre, use_full=True)
    torch.cuda.synchronize()
    launches = dict(mn.launches)
    log(f"full-trunk encode launches: {launches} (expected 5 instance)")
    if launches != dict(dict.fromkeys(mn.launches, 0), instance=5):
        raise AssertionError(f"full-trunk encode: modnorm launches {launches}")
    shape = (pre["image_lr"].shape[0], cfg.label_nc, cfg.regional_style_size)
    if tuple(style.shape) != shape or not bool(torch.isfinite(style).all()):
        raise AssertionError(f"bad full-trunk style: {tuple(style.shape)}, finite="
                             f"{bool(torch.isfinite(style).all())}")
    ms = _event_ms(lambda: system.encode_style(pre, use_full=True))
    log("full-trunk encode " + json.dumps({"shape": list(shape), "ms": ms}))
    return style


# -- explorative phase -------------------------------------------------------

def mode_table(system: SRSystem, batch, gen):
    """The 12 modes and baseline_upscale: name -> (call, encodes, generator
    calls, leading dims of each image output).  Every mode is one batched
    call; `gen` is the torch.Generator of the noisy modes."""
    b, n = MODES_B, MODES_N
    style = modes.encode_only(system, batch)
    other = torch.roll(style, shifts=1, dims=0)
    return {
        "encode_only": (lambda: modes.encode_only(system, batch), 1, 0, None),
        "generate_with_style": (lambda: modes.generate_with_style(system, batch, style),
                                0, 1, (b,)),
        "baseline_upscale": (lambda: modes.baseline_upscale(system, batch), 0, 0, (b,)),
        "inference_noise": (lambda: modes.inference_noise(system, batch, gen(), n),
                            1, 1, (b, n)),
        "inference_multi_modal": (lambda: modes.inference_multi_modal(system, batch, gen()),
                                  1, 1, (b, n)),
        "inference_replace_semantics": (
            lambda: modes.inference_replace_semantics(system, batch), 1, 1, (b,)),
        "inference_reference_semantics": (
            lambda: modes.inference_reference_semantics(system, batch), 1, 1, (b, b)),
        "inference_interpolation": (lambda: modes.inference_interpolation(system, batch),
                                    1, 1, (b, n)),
        "inference_interpolation_style": (
            lambda: modes.inference_interpolation_style(system, batch, style, other),
            0, 1, (b, n)),
        "inference_particular_combined": (
            lambda: modes.inference_particular_combined(system, batch, gen()), 1, 1, (b,)),
        "inference_particular_full": (
            lambda: modes.inference_particular_full(system, batch), 1, 1, (b,)),
        "inference_reference": (lambda: modes.inference_reference(system, batch),
                                1, 1, (b, b)),
        "inference_reference_interpolation": (
            lambda: modes.inference_reference_interpolation(system, batch), 1, 1, (b, n)),
    }


def _tensors_of(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    return [t for o in out for t in _tensors_of(o)]


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device=DEVICE).manual_seed(seed)


def _noise_seeds(count: int):
    """Seeds whose first draw, inference_noise's coin, turns the style
    noise on (the coin is 1/2 either way), so that two of them must give
    two different outputs."""
    seeds = [s for s in range(100) if not system_mod.draw_coin(_generator(s))]
    return seeds[:count]


def launches_per_call(cfg: ModelConfig, encodes: int, gens: int):
    """K1 launches of `encodes` style encodes (five instance norms, either
    trunk) and `gens` generator calls (the path's affine or instance
    norms) of one model."""
    out = {mode: 5 * encodes if mode == "instance" else 0 for mode in mn.launches}
    for mode, n in expected_launches(generator_norms(cfg, 1)).items():
        out[mode] += gens * n
    return out


def explorative_phase(system: SRSystem):
    """Each mode once with its launch count and output check; same seed
    twice, another seed once for the two noisy modes; ms per mode."""
    t0 = time.perf_counter()
    cfg = system.cfg
    system.exp = system.exp.replace(**MODES_KNOBS)
    batch = system.preprocess(make_batch(cfg, MODES_B))
    seed = {"value": _noise_seeds(1)[0]}
    table = mode_table(system, batch, lambda: _generator(seed["value"]))
    image = (cfg.crop_size, cfg.crop_size, 3)
    timings = {}
    for name, (call, encodes, gens, lead) in table.items():
        torch.cuda.synchronize()
        mn.reset_launches()
        out = call()
        torch.cuda.synchronize()
        launches = dict(mn.launches)
        expected = launches_per_call(cfg, encodes, gens)
        if launches != expected:
            raise AssertionError(f"mode {name}: modnorm launches {launches} != {expected}")
        tensors = _tensors_of(out)
        if not all(bool(torch.isfinite(t).all()) for t in tensors):
            raise AssertionError(f"mode {name}: output not finite")
        if lead is None:
            shapes_ok = tuple(out.shape) == (MODES_B, cfg.label_nc, cfg.regional_style_size)
        else:
            imgs = [t for t in tensors if tuple(t.shape[-3:]) == image]
            shapes_ok = bool(imgs) and all(tuple(t.shape[:-3]) == lead for t in imgs) and all(
                float(t.abs().max()) <= 1.0 for t in imgs)
        if not shapes_ok:
            raise AssertionError(f"mode {name}: bad output shapes "
                                 f"{[tuple(t.shape) for t in tensors]}")
        timings[name] = {"ms": _event_ms(call, reps=3), "launches": launches,
                         "shapes": [list(t.shape) for t in tensors]}
        log(f"mode {name} " + json.dumps(timings[name]))
        del out, tensors

    # the generator decides the noise: same seed, same output; another, another
    seed_a, seed_b = _noise_seeds(2)
    for name in ("inference_noise", "inference_multi_modal"):
        call = table[name][0]
        runs = []
        for s in (seed_a, seed_a, seed_b):
            seed["value"] = s
            runs.append(_tensors_of(call())[0].float())
        same = float((runs[0] - runs[1]).abs().max())
        apart = float((runs[0] - runs[2]).abs().max())
        log(f"mode {name} seeds {seed_a}, {seed_a}, {seed_b}: max abs diff same seed "
            f"{same:.3e}, other seed {apart:.3e}")
        if same != 0.0 or not apart > 1e-2:
            raise AssertionError(f"mode {name}: the generator does not decide the noise "
                                 f"(same seed {same}, other seed {apart})")
    log("explorative phase " + json.dumps({
        "batch": MODES_B, "n": MODES_N, "ms_per_mode": {k: v["ms"] for k, v in timings.items()},
        "wall_s": time.perf_counter() - t0}))


# -- serving phase -------------------------------------------------------------

def _serve_requests(manifests):
    """The window's requests, seeded: (program, alias, headers, raw body,
    per-sample args as the daemon decodes them)."""
    rng = np.random.RandomState(SEED + 2)
    out = []
    for i in range(SERVE_REQUESTS):
        kind = ("indep", "styled", "guided")[i % 3]
        alias = "guided" if kind == "guided" else "indep"
        m = manifests[alias]
        crop, start, nc = m["crop_size"], m["start_size"], m["label_nc"]
        lr = rng.randint(0, 256, (start, start, 3), dtype=np.uint8)
        lab = rng.randint(0, nc, (crop, crop), dtype=np.uint8)
        parts, headers = [lr.tobytes(), lab.tobytes()], {"X-DS-Model": alias}
        args = [server_mod.image_from_u8(lr.reshape(-1), start),
                server_mod.label_from_u8(lab.reshape(-1), crop, nc)]
        if kind == "styled":
            style = (0.5 * np.tanh(rng.randn(nc, m["regional_style_size"]))).astype("<f4")
            parts.append(style.tobytes())
            headers["X-DS-Style"] = "1"
            args.append(style[None])
        elif kind == "guided":
            g_img = rng.randint(0, 256, (crop, crop, 3), dtype=np.uint8)
            g_lab = rng.randint(0, nc, (crop, crop), dtype=np.uint8)
            parts += [g_img.tobytes(), g_lab.tobytes()]
            args += [server_mod.image_from_u8(g_img.reshape(-1), crop),
                     server_mod.label_from_u8(g_lab.reshape(-1), crop, nc)]
        program = f"{alias}/{'styled' if kind == 'styled' else 'end_to_end'}"
        out.append((program, headers, b"".join(parts), args))
    return out


def _client(port: int, requests, results, lock) -> None:
    """One client thread: its share of the requests over one keep-alive
    connection; (index, status, body, style bytes, seconds) per request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        for i, (_, headers, raw, _) in requests:
            t = time.perf_counter()
            conn.request("POST", "/v1/super_resolve_bin", body=raw,
                         headers=dict(headers, **{"Content-Type": "application/octet-stream"}))
            resp = conn.getresponse()
            body = resp.read()
            style_n = int(resp.getheader("X-DS-Style-Bytes") or 0)
            with lock:
                results[i] = (resp.status, body, style_n, time.perf_counter() - t)
    finally:
        conn.close()


def check_served_program(tag: str, fn, args, want) -> None:
    """A loaded bf16 program against the live system on one trace batch."""
    with torch.inference_mode():
        got = fn(*(torch.from_numpy(a).to(DEVICE) for a in args))
    got = got if isinstance(got, tuple) else (got,)
    psnr = psnr_db(got[0], want[0])
    style_diff = float((got[1] - want[1]).abs().max()) if len(got) > 1 else 0.0
    log(f"served {tag} vs live system: PSNR {psnr:.2f} dB (min {MIN_BF16_PSNR_DB}), "
        f"max abs diff {float((got[0] - want[0]).abs().max()):.3e}, style {style_diff:.3e}")
    if not psnr >= MIN_BF16_PSNR_DB:
        raise AssertionError(f"served {tag}: PSNR {psnr:.2f} dB against the live system")


def _trace_batch_args(cfg, guided: bool):
    rng = np.random.RandomState(SEED + 3)
    b, crop, start = SERVE_BATCH, cfg.crop_size, cfg.start_size
    lr = np.tanh(rng.randn(b, start, start, 3)).astype(np.float32)
    lab = rng.randint(0, cfg.label_nc, (b, crop, crop)).astype(np.int32)
    style = (0.5 * np.tanh(rng.randn(b, cfg.label_nc, cfg.regional_style_size))
             ).astype(np.float32)
    e2e = (lr, lab)
    if guided:
        e2e += (np.tanh(rng.randn(b, crop, crop, 3)).astype(np.float32),
                rng.randint(0, cfg.label_nc, (b, crop, crop)).astype(np.int32))
    return e2e, (lr, lab, style)


def _live(system: SRSystem, args, styled: bool):
    keys = ("image_lr", "label", "guiding_image", "guiding_label")
    batch = system.preprocess(dict(zip(keys, args[:2] if styled else args)))
    if styled:
        style = torch.from_numpy(args[2]).to(DEVICE)
        return system.generate(batch, style=style)[0], None
    return system.generate(batch, use_full=system.cfg.guiding_style_image)


def export_and_check(alias: str, system: SRSystem, out_dir: str):
    """Export the model's two programs on the card (bf16), save, load, and
    hold them against the live system; then the float32 programs (TF32
    off) against the float32 system.  Returns the export record."""
    cfg = system.cfg
    guided = cfg.guiding_style_image
    t0 = time.perf_counter()
    programs = serve.export_serving(system, SERVE_BATCH)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve.save_serving(out_dir, system.exp, programs, SERVE_BATCH, system.device)
    save_s = time.perf_counter() - t0
    sizes = {name: os.path.getsize(os.path.join(out_dir, f"{name}.pt2")) / 2 ** 20
             for name in programs}
    t0 = time.perf_counter()
    loaded = {name: serve.load_serving(out_dir, name) for name in programs}
    load_s = time.perf_counter() - t0
    del programs
    e2e_args, styled_args = _trace_batch_args(cfg, guided)
    for name, args in (("end_to_end", e2e_args), ("styled", styled_args)):
        want = _live(system, args, name == "styled")
        check_served_program(f"{alias}/{name} bf16", loaded[name], args, want)

    system32 = _like(system, "float32", DEVICE)
    programs32 = serve.export_serving(system32, SERVE_BATCH)
    f32_diff = {}
    for name, args in (("end_to_end", e2e_args), ("styled", styled_args)):
        with torch.inference_mode():
            got = programs32[name].module()(*(torch.from_numpy(a).to(DEVICE) for a in args))
        got = got[0] if isinstance(got, tuple) else got
        f32_diff[name] = float((got - _live(system32, args, name == "styled")[0]).abs().max())
    del programs32, system32
    torch.cuda.empty_cache()
    log(f"served {alias} float32 (TF32 off) vs live system: max abs diff "
        f"{json.dumps(f32_diff)} (max {MAX_F32_SERVED_DIFF})")
    if not all(d <= MAX_F32_SERVED_DIFF for d in f32_diff.values()):
        raise AssertionError(f"served {alias} float32 differs from the live system: {f32_diff}")
    record = {"export_s": export_s, "save_s": save_s, "load_s": load_s, "size_mib": sizes,
              "f32_max_abs_diff": f32_diff}
    log(f"export {alias} ({system.exp.name}, trace batch {SERVE_BATCH}) " + json.dumps(record))
    return record


def serving_phase(indep: SRSystem, smi: str):
    """Export both models, serve them from one daemon, drive it with 16
    clients, check every response and the window's K1 launches."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="deepsee_serving_")
    try:
        systems = {"indep": indep, "guided": seeded_system(SERVE_PRESETS["guided"])}
        dirs = {alias: os.path.join(root, alias) for alias in systems}
        exports = {alias: export_and_check(alias, system, dirs[alias])
                   for alias, system in systems.items()}

        per_batch = {f"{alias}/{name}": launches_per_call(system.cfg, int(name != "styled"), 1)
                     for alias, system in systems.items() for name in serve.PROGRAMS}
        log(f"serving: K1 launches per batch {json.dumps(per_batch)}")
        del systems["guided"]
        torch.cuda.empty_cache()

        srv = server_mod.ServingServer([f"{a}={d}" for a, d in dirs.items()], port=0,
                                       host="127.0.0.1", batch_window_ms=5.0, device=DEVICE)
        srv.start()
        try:
            requests = _serve_requests(srv.manifests)
            # warm-up: one request of each program, outside the window
            warm = {}
            for i, req in enumerate(requests):
                warm.setdefault(req[0], (i, req))
            _client(srv.port, list(warm.values()), {}, threading.Lock())
            programs = {name: fn for name, (fn, _) in srv.batcher.programs.items()}
            served = record_batches(srv)
            srv.batcher.reset_stats()
            mn.reset_launches()
            results, lock = {}, threading.Lock()
            shares = [[(i, requests[i]) for i in range(k, SERVE_REQUESTS, SERVE_CLIENTS)]
                      for k in range(SERVE_CLIENTS)]
            threads = [threading.Thread(target=_client, args=(srv.port, share, results, lock))
                       for share in shares]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            window_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = dict(mn.launches)
            stats = srv.batcher.stats_snapshot()
            prog_stats = srv.health()["programs"]
            if any(t.is_alive() for t in threads) or len(results) != SERVE_REQUESTS:
                raise AssertionError(f"serving: {len(results)} of {SERVE_REQUESTS} answered")
            bad = {i: r[1][:200] for i, r in results.items() if r[0] != 200}
            if bad or stats["errors"]:
                raise AssertionError(f"serving: {stats['errors']} errors, failed: {bad}")
            expected = dict.fromkeys(mn.launches, 0)
            for prog, ps in prog_stats.items():
                for mode, n in per_batch[prog].items():
                    expected[mode] += ps["batches"] * n
            log(f"serving launches in the window: {launches} (expected {expected} from "
                f"{json.dumps({p: ps['batches'] for p, ps in prog_stats.items()})} batches)")
            if launches != expected:
                raise AssertionError(f"serving: modnorm launches {launches} != {expected}")
            u8_diff, style_diff, regrouped, call_s = check_responses(programs, served,
                                                                     requests, results)
            lat = np.sort([r[3] for r in results.values()]) * 1e3
            record = {
                "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
                "trace_batch": SERVE_BATCH, "wire": "/v1/super_resolve_bin",
                "window_s": window_s, "requests_per_s": SERVE_REQUESTS / window_s,
                "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
                "batches": stats["batches"], "batch_fill": srv.health()["stats"]["batch_fill"],
                "batch_fill_per_program": {p: ps["batch_fill"] for p, ps in prog_stats.items()},
                "batches_per_program": {p: ps["batches"] for p, ps in prog_stats.items()},
                "errors": stats["errors"], "max_u8_diff_vs_direct": u8_diff,
                "max_style_diff_vs_direct": style_diff,
                "max_u8_diff_in_other_batches": regrouped,
                # the served batches called again one by one, host wall per
                # call (copies in, the program, the copy out), and the share
                # of the window the device thread needs for them
                "direct_call_ms": {p: float(np.median(v)) * 1e3 for p, v in call_s.items()},
                "device_thread_busy_share": sum(map(sum, call_s.values())) / window_s,
                "export": exports, "card": smi, "wall_s": time.perf_counter() - t_phase}
            log("serving " + json.dumps(record))
        finally:
            srv.stop()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def record_batches(srv):
    """Wrap the daemon's programs so that each served batch's arguments are
    kept: [(program, args)] in serving order."""
    served = []
    for name, (fn, cap) in list(srv.batcher.programs.items()):
        def logged(*args, fn=fn, name=name):
            out = fn(*args)
            served.append((name, args))
            return out
        srv.batcher.programs[name] = (logged, cap)
    return served


def _sample_key(args, row: int) -> bytes:
    return b"".join(np.ascontiguousarray(a[row]).tobytes() for a in args)


def check_responses(programs, served, requests, results):
    """Every response against the loaded program called directly on the
    batch the daemon formed for it, at its row: uint8 within
    MAX_SERVED_U8_DIFF (the same call gives the same bytes).  Beside it,
    informational: the same samples in other batches of 8 (request order,
    padded by repetition), where bf16 convs may round a sample differently
    at another position in the batch."""
    where = {}
    direct, call_s = [], {}
    for k, (program, args) in enumerate(served):
        t0 = time.perf_counter()
        direct.append(programs[program](*args))
        call_s.setdefault(program, []).append(time.perf_counter() - t0)
        for row in range(len(args[0])):
            where.setdefault((program, _sample_key(args, row)), (k, row))
    u8_max, style_max, regrouped_max = 0, 0.0, 0
    by_program = {}
    for i, (program, _, _, args) in enumerate(requests):
        by_program.setdefault(program, []).append(i)
        k, row = where[(program, _sample_key(args, 0))]
        _, body, style_n, _ = results[i]
        img_n = len(body) - style_n
        outs = direct[k]
        got = np.frombuffer(body[:img_n], np.uint8).reshape(outs[0][row].shape)
        u8_max = max(u8_max, int(np.abs(got.astype(int) - tensor2im(outs[0][row])).max()))
        if style_n:
            style = np.frombuffer(body[img_n:], "<f4").reshape(outs[1][row].shape)
            style_max = max(style_max, float(np.abs(style - outs[1][row]).max()))
    for program, idx in by_program.items():
        for c in range(0, len(idx), SERVE_BATCH):
            chunk = idx[c:c + SERVE_BATCH]
            pad = chunk + [chunk[-1]] * (SERVE_BATCH - len(chunk))
            outs = programs[program](*[np.concatenate([requests[i][3][j] for i in pad])
                                       for j in range(len(requests[pad[0]][3]))])
            for row, i in enumerate(chunk):
                body, style_n = results[i][1], results[i][2]
                got = np.frombuffer(body[:len(body) - style_n], np.uint8)
                want = tensor2im(outs[0][row]).reshape(-1)
                regrouped_max = max(regrouped_max,
                                    int(np.abs(got.astype(int) - want.astype(int)).max()))
    log(f"served responses vs the program called directly on their batches: max uint8 "
        f"diff {u8_max} (max {MAX_SERVED_U8_DIFF}), max style diff {style_max:.3e}; "
        f"in other batches of {SERVE_BATCH}: max uint8 diff {regrouped_max}")
    if u8_max > MAX_SERVED_U8_DIFF:
        raise AssertionError(f"served responses differ from the program by {u8_max} levels")
    return u8_max, style_max, regrouped_max, call_s


# -- training phase ------------------------------------------------------------

TRAIN_BATCH = 4                # the preset's batch_size
TRAIN_BATCH_LARGE = 16
# the float32 card step against the CPU: the main preset's widths, one block
# fewer (the CPU's step at 256^2 takes minutes)
TRAIN_F32_PRESET = "8x_independent_128x128"
# K1's launches per faithful independent step (G step, then D step with the
# regenerated fake), from the code: see `train_norms`
TRAIN_LAUNCHES = {"batch": 20, "backward_batch": 10, "instance_train": 32,
                  "backward_instance": 17}
TRAIN_LAUNCHES_REUSE = {"batch": 10, "backward_batch": 10, "instance_train": 22,
                        "backward_instance": 17}
TRAIN_MODES = ("batch", "instance_train", "backward_batch", "backward_instance")
# float32 step gradients, card (kernels, cuDNN, TF32 off) against the CPU
# (plain versions), relative L2 per network.  The H100 runs measured G
# 1.7e-3, E 5.0e-3, D 4.9e-4, the same in every run, and the CPU's own step
# with its weights nudged by one float32 ulp spreads G 3.7e-4, E 1.3e-3, D
# 4.9e-4 (PERF.md).  2x room.
MAX_F32_TRAIN_GRAD_REL = 0.01
# the CPU's own spread beside it: every G, E and D parameter scaled by
# (1 + n * 2^-23 * r), r ~ N(0, 1), for n float32 ulps
NUDGE_ULPS = (1, 8)
# bf16 step gradients against float32 ones at the same weights and inputs,
# relative L2 per network: set from the first H100 run, which measured G
# 0.023, E 0.152, D 0.118 (bf16 keeps ~3 digits), with ~2x room.
MAX_BF16_TRAIN_GRAD_REL = 0.3
TRAIN_STEP_REPS = 5
TRAIN_CLI_STEPS = 20


def disc_norms(cfg: ModelConfig, batch2: int):
    """The normed layers of the multiscale discriminator on a 2B batch:
    [(2B, C, H, W)] per scale (4x4 convs with padding 2; the input of each
    coarser scale avg-pooled 3x3 / 2 with padding 1)."""
    out, h = [], cfg.crop_size
    for scale in range(cfg.num_d):
        if scale:
            h = (h + 2 - 3) // 2 + 1
        hh, nf = h // 2 + 1, cfg.ndf          # model0, stride 2
        for n in range(1, cfg.n_layers_d):
            nf = min(nf * 2, 512)
            hh = hh // 2 + 1 if n < cfg.n_layers_d - 1 else hh + 1
            out.append((batch2, nf, hh, hh))
    return out


def train_norms(cfg: ModelConfig, batch: int, g_full: bool, regen: bool = True):
    """Every K1 launch of one training step of the independent model:
    [(stats, (B, C, H, W), with_mod, lrelu, forwards, backwards)].  The G
    step runs G, both trunks and D (on 2B) forward, and backward through
    G, the trunk its coin picked (`g_full`) and D; the D step regenerates
    the fake (G and both trunks, forward only; not with reuse_fake) and runs
    D forward and backward."""
    fwd = 2 if regen else 1
    rows = [("batch", shape, True, True, fwd * n, n)
            for _, shape, _, _, n in generator_norms(cfg, batch)]
    for full, trunk in ((True, full_trunk_norms), (False, mini_trunk_norms)):
        rows += [("instance", shape, False, lrelu, fwd, int(full == g_full))
                 for shape, lrelu in trunk(cfg, batch)]
    rows += [("instance", shape, False, True, 2, 2) for shape in disc_norms(cfg, 2 * batch)]
    return rows


def train_launches(norms):
    out = dict.fromkeys(TRAIN_MODES, 0)
    for stats, _, _, _, fwd, bwd in norms:
        out["batch" if stats == "batch" else "instance_train"] += fwd
        out["backward_" + stats] += bwd
    return out


def _train_bound_ms(backward: bool, shape, with_mod, lrelu, elt_bytes):
    """Least time: each input read once, each output written once (forward:
    x, mod -> out; backward: x, mod, gout -> grad_x, grad_mod), or the
    float32 operations per element, over the CUDA cores' rate."""
    b, c, h, w = shape
    n = b * c * h * w
    if backward:
        tensors = 3 + (4 if with_mod else 0)
        per_elt = 9 + (4 if with_mod else 0) + (1 if lrelu else 0)
    else:
        tensors = 2 + (2 if with_mod else 0)
        per_elt = 6 + (2 if with_mod else 0) + (1 if lrelu else 0)
    t_bytes, t_ops = n * tensors * elt_bytes / HBM_BYTES_PER_S, n * per_elt / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _train_within(got, want, dtype):
    """As tests/test_torch_kernels.py::_train_within: 1e-5 of max|want|
    (statistics and sums taken in other orders), plus 1 bf16 ulp of |want|."""
    want = want.float()
    slack = 1e-5 * float(want.abs().max())
    if dtype == torch.bfloat16:
        slack = slack + torch.finfo(torch.bfloat16).eps * want.abs()
    return bool(((got.float() - want).abs() <= slack).all())


def _library_train(stats, backward, x, gout, mean, rstd):
    """One PyTorch call for the same normalization, without the fused
    modulation and leaky ReLU: F.batch_norm(training=True) /
    F.instance_norm forward; aten.native_batch_norm_backward for the batch
    backward, and on the (1, B*C, H, W) view that F.instance_norm's
    backward uses for the instance one."""
    c = x.shape[1]
    if not backward:
        if stats == "batch":
            rm = torch.zeros(c, device=x.device)
            rv = torch.ones(c, device=x.device)
            return lambda: F.batch_norm(x, rm, rv, training=True, eps=1e-5)
        return lambda: F.instance_norm(x, eps=1e-5)
    mask = [True, False, False]
    if stats == "batch":
        return lambda: torch.ops.aten.native_batch_norm_backward(
            gout, x, None, None, None, mean, rstd, True, 1e-5, mask)
    b, _, h, w = x.shape
    x1 = x.contiguous().view(1, b * c, h, w)
    g1 = gout.contiguous().view(1, b * c, h, w)
    m1, r1 = mean.reshape(-1).contiguous(), rstd.reshape(-1).contiguous()
    return lambda: torch.ops.aten.native_batch_norm_backward(
        g1, x1, None, None, None, m1, r1, True, 1e-5, mask)


def train_kernel_phase(cfg: ModelConfig, batch: int, timed: bool = True):
    """Each training kernel against its plain version at every shape of the
    training step at `batch` (either coin), bf16 and float32: the forward
    (out, mean, rstd) and the backward (grad_x, grad_mod) on the plain
    version's statistics.  Where `timed`, bf16: device ms, plain ms, library
    ms and bound of each, forward and backward."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    shapes = {}
    for g_full in (True, False):
        for stats, shape, m, lrelu, _, _ in train_norms(cfg, batch, g_full):
            shapes[(stats, shape, m, lrelu)] = None
    rows = []
    for stats, shape, with_mod, lrelu in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x, mod, _, _ = _kernel_inputs(shape, with_mod, dtype, gen)
            gout = _kernel_inputs(shape, False, dtype, gen)[0]
            kw = dict(stats=stats, lrelu=lrelu)
            out, mean, rstd = mn.modnorm_train(x, mod, **kw)
            torch.cuda.synchronize()
            want, wmean, wrstd = mn.modnorm_train_plain(x, mod, **kw)
            gx, gmod = mn.modnorm_backward(x, mod, gout, wmean, wrstd, **kw)
            torch.cuda.synchronize()
            wgx, wgmod = mn.modnorm_backward_plain(x, mod, gout, wmean, wrstd, **kw)
            stat_err = max(float(((mean - wmean).abs() / (wmean.abs() + 1e-3)).max()),
                           float(((rstd - wrstd).abs() / wrstd.abs()).max()))
            ok = (_train_within(out, want, dtype) and stat_err <= 1e-4
                  and _train_within(gx, wgx, dtype)
                  and (gmod is None or _train_within(gmod, wgmod, dtype)))
            row = {"stats": stats, "shape": list(shape), "mod": with_mod, "lrelu": lrelu,
                   "dtype": str(dtype).replace("torch.", ""), "ok": ok,
                   "max_abs_err": float((out.float() - want.float()).abs().max()),
                   "stats_rel_err": stat_err,
                   "bwd_max_abs_err": float((gx.float() - wgx.float()).abs().max()),
                   "bwd_mod_max_abs_err": (0.0 if gmod is None else
                                           float((gmod.float() - wgmod.float()).abs().max())),
                   "max_abs_out": float(want.abs().max()),
                   "max_abs_grad_x": float(wgx.abs().max())}
            del out, want, gx, gmod, wgx, wgmod
            if timed and dtype == torch.bfloat16:
                set_bytes = x.numel() * x.element_size() * (5 if with_mod else 2)
                pool = [(x, mod, gout)] + [
                    _kernel_inputs(shape, with_mod, dtype, gen)[:2]
                    + (_kernel_inputs(shape, False, dtype, gen)[0],)
                    for _ in range(max(0, math.ceil(120e6 / set_bytes) - 1))]
                row["fwd_ms"] = _device_ms([lambda a=a, m=m: mn.modnorm_train(a, m, **kw)
                                            for a, m, _ in pool])
                row["fwd_plain_ms"] = _device_ms([
                    lambda a=a, m=m: mn.modnorm_train_plain(a, m, **kw) for a, m, _ in pool])
                row["fwd_library_ms"] = _device_ms([_library_train(stats, False, a, g, None, None)
                                                    for a, _, g in pool])
                row["bwd_ms"] = _device_ms([
                    lambda a=a, m=m, g=g: mn.modnorm_backward(a, m, g, wmean, wrstd, **kw)
                    for a, m, g in pool])
                row["bwd_plain_ms"] = _device_ms([
                    lambda a=a, m=m, g=g: mn.modnorm_backward_plain(a, m, g, wmean, wrstd, **kw)
                    for a, m, g in pool])
                row["bwd_library_ms"] = _device_ms([
                    _library_train(stats, True, a, g, wmean, wrstd) for a, _, g in pool])
                for key, backward in (("fwd", False), ("bwd", True)):
                    bound, by = _train_bound_ms(backward, shape, with_mod, lrelu,
                                                x.element_size())
                    row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bound, by
                    row[f"{key}_bound_share"] = bound / row[f"{key}_ms"]
                    row[f"{key}_plan"] = dataclasses.asdict(
                        _train_plan(key, stats, shape, with_mod, lrelu, dtype))
                    row[f"{key}_gb_per_s"] = _design_bytes(
                        key, stats, shape, with_mod, lrelu, dtype) / row[f"{key}_ms"] / 1e6
                del pool
            log("train kernel " + json.dumps(row))
            rows.append(row)
            del x, mod, gout, mean, rstd, wmean, wrstd
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"a training kernel disagrees with its plain version: {bad}")
    return rows


def _train_plan(key: str, stats: str, shape, with_mod: bool, lrelu: bool, dtype):
    """The launch plan of a training kernel: the batch forward's for the
    card's blocks per SM and SMs, the instance kernels', the batch
    backward's reduction."""
    if key == "fwd" and stats == "batch":
        return mn.batch_plan(shape, dtype, mn.batch_blocks_per_sm(dtype, with_mod, lrelu),
                             mn.card_sms(torch.device(DEVICE)))
    if key == "fwd":
        return mn.instance_plan(shape, dtype)
    if stats == "instance":
        return mn.instance_backward_plan(shape, dtype, with_mod)
    b, c, h, w = shape
    return mn.reduce_plan(b * h * w, c)


def _design_bytes(key: str, stats: str, shape, with_mod: bool, lrelu: bool, dtype) -> float:
    """Bytes a training kernel's design moves through device memory for one
    call (`key` "fwd" or "bwd"): each tensor it reads or writes once, and
    the reads it makes again by its plan (what L2 serves of them counts as
    moved)."""
    b, c, h, w = shape
    t = b * c * h * w * torch.finfo(dtype).bits // 8   # bytes of one x-sized tensor
    m = 2 if with_mod else 0
    plan = _train_plan(key, stats, shape, with_mod, lrelu, dtype)
    if key == "fwd":
        once = (2 + m) * t                             # x, mod in; out
        if stats == "instance":
            return once + (t if plan.variant == "streaming" else 0)
        p = b * h * w
        kept = sum(min(e - s, plan.resident_pixels) for s, e in mn.instance_chunks(p, plan.runs))
        return once + t * (p - kept) / p
    once = (3 + 2 * m) * t                             # x, gout, mod in; grad_x, grad_mod
    if stats == "batch" or plan.variant == "streaming":
        return once + (2 + m) * t                      # x, gout and mod once more
    return once


def train_kernel_times(rows, norms):
    """Per training step, each training kernel: launches, and the bf16
    device, plain, library and bound ms of the kernel phase's rows times the
    step's launches of each shape, summed."""
    out = {mode: {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bound_by": "bytes"} for mode in TRAIN_MODES}
    for stats, shape, with_mod, lrelu, fwd, bwd in norms:
        row = next(r for r in rows if "fwd_ms" in r and r["stats"] == stats
                   and tuple(r["shape"]) == shape and r["mod"] == with_mod
                   and r["lrelu"] == lrelu)
        for mode, key, n in (("batch" if stats == "batch" else "instance_train", "fwd", fwd),
                             ("backward_" + stats, "bwd", bwd)):
            acc = out[mode]
            acc["launches"] += n
            acc["ms"] += row[f"{key}_ms"] * n
            acc["plain_ms"] += row[f"{key}_plain_ms"] * n
            acc["library_ms"] += row[f"{key}_library_ms"] * n
            acc["bound_ms"] += row[f"{key}_bound_ms"] * n
    for acc in out.values():
        acc["bound_share"] = acc["bound_ms"] / acc["ms"] if acc["ms"] else None
    return out


def train_system(preset: str, batch: int, model=(), **train) -> SRSystem:
    """The preset's training system on the card with seeded random weights
    (as `seeded_system`) and seeded VGG features; `model` and `train`
    override configuration fields."""
    exp = get_preset(preset)
    exp = exp.replace(model=dataclasses.replace(exp.model, **dict(model)),
                      train=dataclasses.replace(exp.train, batch_size=batch, **train))
    system = SRSystem(exp, device=DEVICE)
    system.init(torch.Generator().manual_seed(SEED))
    randomize_weights(system.networks().values(), torch.Generator().manual_seed(SEED + 1))
    return system


class _RecordingSGD(torch.optim.SGD):
    """Plain SGD that keeps a copy of the gradients of its last step, by
    parameter."""

    def __init__(self, params, lr: float):
        super().__init__(params, lr=lr)
        self.grads = {}

    def step(self, closure=None):
        self.grads = {p: p.grad.detach().clone() for group in self.param_groups
                      for p in group["params"]}
        return super().step(closure)


def _state_of(system: SRSystem, lr: Optional[float] = None):
    """A train state of `system` (its weights as they are); with `lr`, plain
    SGD at that rate for both networks instead of the TTUR Adams, keeping
    each step's gradients (`_RecordingSGD`)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        state = create_train_state(system, init=False)
    if lr is not None:
        state.opt_g = _RecordingSGD(g_params(system), lr)
        state.opt_d = _RecordingSGD(system.discriminator.parameters(), lr)
    return state


def _one_step_grads(system: SRSystem, batch, coins):
    """Logs and the G, E and D gradients of one step of `system` with
    fixed coins and SGD at lr 0 (the D step's regeneration sees the same
    G)."""
    state = _state_of(system, 0.0)
    draw = train_steps.draw_coins
    train_steps.draw_coins = lambda system_, generator: coins
    try:
        logs = train_steps.make_train_step(system)(state, batch)
    finally:
        train_steps.draw_coins = draw
    grads = {net: {n: opt.grads[p] for n, p in module.named_parameters()}
             for net, module, opt in (("g", system.generator, state.opt_g),
                                      ("e", system.encoder, state.opt_g),
                                      ("d", system.discriminator, state.opt_d))}
    return {k: float(v) for k, v in logs.items()}, grads


def _grads_rel(got, want):
    """Relative L2 of each network's concatenated gradients, without the
    resblocks' conv_0 biases: a batch norm follows them, so their true
    gradient is 0 and both sides return float noise."""
    out = {}
    for net in want:
        keys = [k for k in want[net] if not k.endswith("conv_0.bias")]
        a = torch.cat([got[net][k].float().reshape(-1).cpu() for k in keys])
        b = torch.cat([want[net][k].float().reshape(-1).cpu() for k in keys])
        out[net] = float((a - b).norm() / b.norm())
    return out


def _nudge(system: SRSystem, ulps: int, generator: torch.Generator) -> None:
    """Scale every G, E and D parameter by (1 + ulps * 2^-23 * r),
    r ~ N(0, 1): a change at float32's rounding level."""
    with torch.no_grad():
        for net in (system.generator, system.encoder, system.discriminator):
            for p in net.parameters():
                p.mul_(1 + ulps * 2.0 ** -23 * torch.randn(p.shape, generator=generator))


def _worst_leaves(got, want, nudged, n: int = 4):
    """Per network, the `n` leaves that hold most of the squared difference
    got - want: that share, the leaf's relative L2 got vs want, and each
    nudged CPU step's (`nudged`: ulps -> gradients) relative L2 vs want on
    the same leaf."""
    out = {}
    for net in want:
        diff = {k: float((got[net][k].float().cpu() - want[net][k]).norm() ** 2)
                for k in want[net] if not k.endswith("conv_0.bias")}
        total = sum(diff.values()) or 1.0
        out[net] = {}
        for k in sorted(diff, key=lambda k: -diff[k])[:n]:
            norm = float(want[net][k].norm()) or math.inf  # a leaf without gradient: rel 0
            out[net][k] = {"share": diff[k] / total, "rel": math.sqrt(diff[k]) / norm}
            for ulps, g in nudged.items():
                out[net][k][f"nudged_{ulps}ulp_rel"] = float(
                    (g[net][k] - want[net][k]).norm()) / norm
    return out


def train_gradient_checks(batch_n: int):
    """(1) float32 step on the card against the CPU: TRAIN_F32_PRESET,
    batch 1, TF32 off, coins fixed (mini trunk, no style noise), noise
    injection off; losses, G/E/D gradients (relative L2), running
    statistics and spectral u/v after the step.  Beside it the CPU's own
    spread: the same step on the CPU with the weights nudged by 1 and 8
    float32 ulps (`_nudge`), against the CPU step, per network and on the
    leaves where the card differs most.  (2) bf16 gradients against float32 ones at the
    same weights, the main preset at batch_n."""
    coins = (False, True)
    t0 = time.perf_counter()
    card32 = train_system(TRAIN_F32_PRESET, 1, model=dict(add_noise=False,
                                                         compute_dtype="float32"))
    cpu32 = _like(card32, "float32", "cpu")
    nudged = {ulps: _like(card32, "float32", "cpu") for ulps in NUDGE_ULPS}
    for ulps, system in nudged.items():
        _nudge(system, ulps, torch.Generator().manual_seed(SEED + 7))
    one = make_batch(card32.cfg, 1)
    logs_card, g_card = _one_step_grads(card32, one, coins)
    t_cpu = time.perf_counter()
    logs_cpu, g_cpu = _one_step_grads(cpu32, one, coins)
    cpu_s = time.perf_counter() - t_cpu
    g_nudged = {ulps: _one_step_grads(system, one, coins)[1]
                for ulps, system in nudged.items()}
    rel = _grads_rel(g_card, g_cpu)
    nudged_rel = {ulps: _grads_rel(g, g_cpu) for ulps, g in g_nudged.items()}
    log("train float32 leaves " + json.dumps(_worst_leaves(g_card, g_cpu, g_nudged)))
    loss_rel = max(abs(logs_card[k] - logs_cpu[k]) / max(abs(logs_cpu[k]), 1e-6)
                   for k in logs_cpu)
    buf = 0.0
    for name, net in card32.networks().items():
        other = cpu32.networks()[name].state_dict()
        for key, value in net.state_dict().items():
            if key.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
                buf = max(buf, float((value.cpu() - other[key]).abs().max()))
    record = {"preset": TRAIN_F32_PRESET, "batch": 1, "grad_rel_l2": rel,
              "nudged_cpu_grad_rel_l2": nudged_rel, "loss_rel_err": loss_rel,
              "buffer_max_abs_diff": buf, "cpu_s": cpu_s,
              "logs_card": logs_card, "logs_cpu": logs_cpu}
    log("train float32 card vs CPU " + json.dumps(record))
    if not (max(rel.values()) <= MAX_F32_TRAIN_GRAD_REL and loss_rel <= 1e-4 and buf <= 1e-4):
        raise AssertionError(f"float32 training step on the card differs from the CPU: {record}")
    del card32, cpu32, nudged
    torch.cuda.empty_cache()

    bf16 = train_system(PRESET, batch_n, model=dict(add_noise=False))
    f32 = _like(bf16, "float32", DEVICE)
    batch = make_batch(bf16.cfg, batch_n)
    logs16, g16 = _one_step_grads(bf16, batch, coins)
    logs32, g32 = _one_step_grads(f32, batch, coins)
    rel16 = _grads_rel(g16, g32)
    record = {"preset": PRESET, "batch": batch_n, "grad_rel_l2": rel16,
              "logs_bf16": logs16, "logs_f32": logs32, "wall_s": time.perf_counter() - t0}
    log("train bf16 vs float32 " + json.dumps(record))
    if not max(rel16.values()) <= MAX_BF16_TRAIN_GRAD_REL:
        raise AssertionError(f"bf16 training gradients differ from float32: {record}")
    del bf16, f32
    torch.cuda.empty_cache()


def _step_events_ms(step, state, batch, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        step(state, batch)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_schedules(batch_n: int) -> None:
    """The faithful schedule against reuse_fake at batch_n from the same
    seeded weights, ms per step by CUDA events in turns (faithful, reuse,
    reuse, faithful), TRAIN_STEP_REPS steps each after one warm-up step."""
    runs = {}
    for reuse in (False, True):
        system = train_system(PRESET, batch_n, reuse_fake=reuse)
        runs[reuse] = (train_steps.make_train_step(system), _state_of(system))
    batch = make_batch(get_preset(PRESET).model, batch_n)
    times = {False: [], True: []}
    for reuse in (False, True, True, False):
        step, state = runs[reuse]
        step(state, batch)
        times[reuse].append(_step_events_ms(step, state, batch, TRAIN_STEP_REPS))
    f, r = sum(times[False]) / 2, sum(times[True]) / 2
    log(f"train schedules b{batch_n} " + json.dumps({
        "faithful_ms_per_step": times[False], "reuse_fake_ms_per_step": times[True],
        "reuse_fake_speedup": f / r}))
    del runs
    torch.cuda.empty_cache()


def drive_train(tag: str, batch_n: int, reuse_fake: bool = False, rows=None,
                profile: bool = True):
    """One schedule at full width, bf16 (seeded weights and batch): one step
    with the launch counts set to 0 just before and read just after, checked
    against the launches `train_norms` derives for the step's coins, finite
    losses; then ms per step and img/s by CUDA events after warm-up, peak
    memory, and one step profiled.  Returns the launches, the per-step
    kernel times (with `rows`, the kernel phase's) and the timing."""
    system = train_system(PRESET, batch_n, reuse_fake=reuse_fake)
    state = _state_of(system)
    step = train_steps.make_train_step(system)
    batch = make_batch(system.cfg, batch_n)
    step(state, batch)  # warm-up: cuDNN plans, the allocator
    drawn = []
    draw = train_steps.draw_coins
    train_steps.draw_coins = (lambda system_, generator:
                              drawn.append(draw(system_, generator)) or drawn[-1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mn.reset_launches()
    try:
        logs = step(state, batch)
        torch.cuda.synchronize()
    finally:
        train_steps.draw_coins = draw
    launches = {k: mn.launches[k] for k in TRAIN_MODES}
    layout = mn.layout_copies["backward"]
    others = {k: n for k, n in mn.launches.items() if k not in TRAIN_MODES and n}
    logs = {k: float(v) for k, v in logs.items()}
    norms = train_norms(system.cfg, batch_n, g_full=drawn[0][0], regen=not reuse_fake)
    expected = train_launches(norms)
    log(f"{tag} launches per step: {launches} (expected {expected}), other K1 launches "
        f"{others}, layout copies {layout}, coins {drawn}, losses {logs}")
    if launches != expected or others:
        raise AssertionError(f"{tag}: K1 launches {launches} {others} != {expected}")
    if not all(math.isfinite(v) for v in logs.values()):
        raise AssertionError(f"{tag}: a loss is not finite: {logs}")
    times = None
    if rows is not None:
        times = train_kernel_times(rows, norms)
        log(f"{tag} kernels per step " + json.dumps(times))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host0 = time.perf_counter()
    ms = _step_events_ms(step, state, batch, TRAIN_STEP_REPS)
    host_ms = (time.perf_counter() - host0) * 1e3 / TRAIN_STEP_REPS
    timing = {"batch": batch_n, "ms_per_step": ms, "img_per_s": batch_n / ms * 1e3,
              "host_ms_per_step": host_ms, "peak_mem_gib": peak,
              "layout_copies_per_step": layout}
    log(f"{tag} timing " + json.dumps(timing))
    if profile:
        profile_train(tag, system, state, step, batch, ms)
    del system, state, step
    torch.cuda.empty_cache()
    return launches, times, timing


TRAIN_CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("K1 backward", ("backward_partial", "backward_final", "backward_apply",
                     "instance_backward")),
    ("K1 forward", ("modnorm",)),
    ("conv backward (cuDNN)", ("dgrad", "wgrad")),
    ("conv forward (cuDNN)", ("fprop", "conv", "implicit")),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("matmul (bmm)", ("gemm", "gemv")),
    ("layout copies and transposes", ("nchwtonhwc", "nhwctonchw", "transpose", "copy")),
    ("pooling", ("pool",)),
    ("resize", ("upsample", "interpolate")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def profile_train(tag: str, system: SRSystem, state, step, batch, ms_per_step: float) -> None:
    """Device time of one step by category (torch.profiler), the VGG's and
    the optimizers' device time by record_function range, and the idle share
    = 1 - kernel time / the event-timed ms per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    vgg = system.vgg_features
    opt_steps = (state.opt_g.step, state.opt_d.step)

    def ranged(name, fn):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    system.vgg_features = ranged("vgg", vgg)
    state.opt_g.step = ranged("optimizer", opt_steps[0])
    state.opt_d.step = ranged("optimizer", opt_steps[1])
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        system.vgg_features = vgg
        state.opt_g.step, state.opt_d.step = opt_steps
    events = prof.key_averages()
    ranges = {e.key: e.device_time_total / 1e3 for e in events if e.key in ("vgg", "optimizer")}

    def annotation(e) -> bool:  # a range on the device timeline, not a kernel
        return (getattr(e, "is_user_annotation", False) or e.key in ranges
                or e.key.startswith("Optimizer."))

    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                      and not annotation(e)), key=lambda k: -k[1])
    total = sum(t for _, t, _ in kernels)
    categories: dict = {}
    for name, t, _ in kernels:
        cat = next((c for c, keys in TRAIN_CATEGORIES if any(k in name.lower() for k in keys)),
                   "other")
        categories[cat] = categories.get(cat, 0.0) + t
    log(f"{tag} profile " + json.dumps({
        "kernel_ms": total, "idle_share": 1.0 - total / ms_per_step,
        "categories_ms": dict(sorted(categories.items(), key=lambda kv: -kv[1])),
        "ranges_ms (device time launched inside)": ranges}))
    for name, t, count in kernels[:12]:
        log(f"{tag} profile kernel {t:9.3f} ms  x{count:<4d} {name[:110]}")


def trainer_phase(smi: str) -> None:
    """Trainer.run on seeded batches for a few steps with a save, a resume
    and one more step; the saved net_SR / net_E load into an inference
    SRSystem that generates a finite image.  Then the CLI,
    `python -m deepsee_torch.train --synthetic`, for TRAIN_CLI_STEPS steps
    in a process of its own."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="deepsee_train_")
    try:
        exp = get_preset(PRESET).replace(checkpoints_dir=root)
        exp = exp.replace(train=dataclasses.replace(exp.train, batch_size=TRAIN_BATCH))
        data = [make_batch(exp.model, TRAIN_BATCH)] * 3
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            first = Trainer(exp, device=DEVICE)
            first.run(data, max_steps=2)
            del first
            resumed = Trainer(exp, device=DEVICE, continue_train=True)
        if resumed.state.step != 2:
            raise AssertionError(f"trainer: resumed at step {resumed.state.step}, not 2")
        resumed.run(data, max_steps=3)
        if resumed.state.step != 3:
            raise AssertionError(f"trainer: stopped at step {resumed.state.step}")
        del resumed
        torch.cuda.empty_cache()
        run_dir = os.path.join(root, exp.name)
        files = sorted(os.listdir(run_dir))
        inference = SRSystem(exp.replace(is_train=False), device=DEVICE)
        load_reference_checkpoint(inference, run_dir)
        fake = run_path(inference, make_batch(exp.model, 2))
        if not bool(torch.isfinite(fake).all()):
            raise AssertionError("trainer: the trained weights generate a non-finite image")
        del inference
        cli = [sys.executable, "-m", "deepsee_torch.train", "--name", PRESET, "--synthetic",
               "--max_steps", str(TRAIN_CLI_STEPS), "--device", DEVICE, "--checkpoints_dir",
               os.path.join(root, "cli")]
        t_cli = time.perf_counter()
        run = subprocess.run(cli, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t_cli
        if run.returncode != 0 or f"trained {TRAIN_CLI_STEPS} steps on {DEVICE}" not in run.stdout:
            raise AssertionError(f"the training CLI failed: {run.stdout[-2000:]}"
                                 f"{run.stderr[-2000:]}")
        cli_files = sorted(os.listdir(os.path.join(root, "cli", PRESET)))
        log("trainer " + json.dumps({"files": files, "cli": " ".join(cli[1:]),
                                     "cli_s": cli_s, "cli_files": cli_files, "card": smi,
                                     "wall_s": time.perf_counter() - t0}))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def training_phase(smi: str):
    """Kernels (at the b4 and b16 shapes; timed at b4), the float32 and
    bf16 gradient checks, the three schedules
    (faithful b4 and b16, reuse_fake b4), faithful against reuse_fake at
    b16 in turns, the trainer and the CLI.  Returns
    the faithful b4 step's launches and per-step kernel times, and the
    kernel rows."""
    t0 = time.perf_counter()
    cfg = get_preset(PRESET).model
    for regen, want in ((True, TRAIN_LAUNCHES), (False, TRAIN_LAUNCHES_REUSE)):
        for g_full in (True, False):
            got = train_launches(train_norms(cfg, TRAIN_BATCH, g_full, regen))
            if got != want:
                raise AssertionError(f"the training step's norms give {got}, not {want}")
    rows = train_kernel_phase(cfg, TRAIN_BATCH)
    rows += train_kernel_phase(cfg, TRAIN_BATCH_LARGE, timed=False)
    log(f"train kernel phase: {time.perf_counter() - t0:.1f} s")
    train_gradient_checks(TRAIN_BATCH)
    launches, times, _ = drive_train("train b4", TRAIN_BATCH, rows=rows)
    drive_train("train b16", TRAIN_BATCH_LARGE)
    drive_train("train reuse_fake b4", TRAIN_BATCH, reuse_fake=True, profile=False)
    compare_schedules(TRAIN_BATCH_LARGE)
    trainer_phase(smi)
    log(f"training phase: {time.perf_counter() - t0:.1f} s")
    return launches, times, rows


# -- profile ---------------------------------------------------------------

KERNEL_CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("modnorm", ("modnorm",)),
    ("conv (cuDNN)", ("fprop", "conv", "implicit", "dgrad", "wgrad")),
    ("matmul (bmm)", ("gemm", "gemv")),
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("concat", ("catarray",)),
    ("resize", ("upsample", "interpolate")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def profile_path(tag: str, system: SRSystem, batch, ms_per_batch: float,
                 use_full: bool) -> None:
    """Device time of one call of a path by kernel and category
    (torch.profiler); the idle share is 1 - kernel time / ms_per_batch,
    the event-timed call without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_path(system, batch, use_full)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_path(system, batch, use_full)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    total = sum(ms for _, ms, _ in kernels)
    categories: dict = {}
    for name, ms, _ in kernels:
        cat = next((c for c, keys in KERNEL_CATEGORIES
                    if any(k in name.lower() for k in keys)), "other")
        categories[cat] = categories.get(cat, 0.0) + ms
    log(f"{tag} profile " + json.dumps({
        "kernel_ms": total, "idle_share": 1.0 - total / ms_per_batch,
        "categories_ms": dict(sorted(categories.items(), key=lambda kv: -kv[1]))}))
    for name, ms, count in kernels[:15]:
        log(f"{tag} profile kernel {ms:9.3f} ms  x{count:<4d} {name[:110]}")


# -- main ----------------------------------------------------------------------

def path_kernel_times(rows, norms, mode: str):
    """One mode of K1 per call of a path: the bf16 device ms, bound, plain
    and library ms of the kernel phase's row for each of the path's shapes,
    times its launches per call, summed."""
    out = {"launches": 0, "ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    bound_by = set()
    for m, shape, with_mod, lrelu, n in norms:
        if m != mode:
            continue
        row = next(r for r in rows if "ms" in r and r["mode"] == m and r["mod"] == with_mod
                   and r["lrelu"] == lrelu and tuple(r["shape"]) == shape)
        out["launches"] += n
        for key in ("ms", "bound_ms", "plain_ms", "library_ms"):
            out[key] += row[key] * n
        bound_by.add(row["bound_by"])
    out["bound_by"] = bound_by.pop() if len(bound_by) == 1 else "bytes"
    out["bound_share"] = out["bound_ms"] / out["ms"] if out["ms"] else None
    return out


# name in the kernels line -> (launch counter, the one library call timed beside it)
TRAIN_KERNEL_INFO = {
    "modnorm_batch": ("batch", "F.batch_norm (training=True; without the fused modulation "
                               "and leaky ReLU)"),
    "modnorm_instance_train": ("instance_train", "F.instance_norm (without the fused leaky "
                                                 "ReLU)"),
    "modnorm_backward_batch": ("backward_batch", "aten.native_batch_norm_backward (without "
                                                 "the modulation's and leaky ReLU's gradient)"),
    "modnorm_backward_instance": ("backward_instance", "aten.native_batch_norm_backward on "
                                  "the (1, B*C, H, W) view of F.instance_norm's backward"),
}


def kernels_line(rows, launches, norms, train=None):
    """Every kernel: the inference modes per main-path call; the training
    kernels per faithful training step (`train`: its launches, per-step
    times and the training kernel rows)."""
    out = []
    for name, (mode, library_call) in KERNEL_INFO.items():
        per_call = path_kernel_times(rows, norms, mode)
        out.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[mode],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["mode"] == mode),
            "ms": per_call["ms"], "plain_ms": per_call["plain_ms"],
            "bound_ms": per_call["bound_ms"], "bound_by": per_call["bound_by"],
            "library_ms": per_call["library_ms"], "library_call": library_call,
            "per": "one main-path call (sum over its launches), device time",
        })
    train_launches_, train_times, train_rows = train
    for name, (mode, library_call) in TRAIN_KERNEL_INFO.items():
        t = train_times[mode]
        if mode.startswith("backward"):
            errs = [max(r["bwd_max_abs_err"], r["bwd_mod_max_abs_err"]) for r in train_rows
                    if r["stats"] == mode.removeprefix("backward_")]
        else:
            errs = [r["max_abs_err"] for r in train_rows
                    if r["stats"] == ("batch" if mode == "batch" else "instance")]
        out.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": train_launches_[mode], "max_abs_err": max(errs),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": library_call,
            "per": f"one training step ({PRESET} b{TRAIN_BATCH}, faithful schedule; sum over "
                   "its launches), device time",
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_preset(PRESET).model

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = kernel_phase(cfg, BATCH)
    t0 = time.perf_counter()
    launches, system = path_phase(BATCH)
    log(f"main path phase: {time.perf_counter() - t0:.1f} s")
    for preset, batch_n in GUIDED_PATHS.items():
        t0 = time.perf_counter()
        guided_phase(preset, batch_n, rows)
        log(f"{preset} phase: {time.perf_counter() - t0:.1f} s")
    explorative_phase(system)
    serving_phase(system, smi)
    del system
    torch.cuda.empty_cache()
    train = training_phase(smi)

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    log(json.dumps(kernels_line(rows, launches, path_norms(cfg, BATCH, full_trunk=False),
                                train)))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
