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
6. Evaluation phase (`evaluation_phase`, the shape of scripts/bench_eval.py):
   deepsee_torch.eval's InferenceEvaluator on the main path's bf16 system
   with FID and LPIPS (seeded random metric networks), batch 16, 128
   synthetic samples: one warm-up sweep and three timed ones (img/s,
   eval_seconds), the device-only sweep over resident batches, the FID's
   host seconds and share, the idle share of a profiled sweep, one profiled
   batch's device ms by stage with K1's launches checked against the path's
   norms; the metric networks in TF32 against strict float32 (FID of the
   128 samples, LPIPS mean, Inception ms); two samples in float32 on the
   card against the plain CPU path (every metric, LPIPS, both pool3 sets)
   and the Inception network in float32 against float64 on the card.
7. Explorative phase: the 12 modes of deepsee_torch/inference/modes.py and
   baseline_upscale on the main path's system (bf16, B=4, n=5): shapes,
   finite values, the K1 launches each mode's own calls imply (one encode
   and one generator call, or fewer), the same torch.Generator seed twice
   gives the same output and another seed another one (inference_noise,
   inference_multi_modal); ms per mode by CUDA events after one warm-up.
8. Serving phase (as scripts/bench_server.py drives the JAX daemon):
   exports 8x_independent_256x256 and 8x_guided_256x256 (seeded weights,
   trace batch 8) with torch.export on the card, holds each program
   against the live system (bf16 PSNR; float32 with TF32 off), starts one
   ServingServer with both, and sends 128 mixed independent / styled /
   guided requests from 16 client threads over /v1/super_resolve_bin.
   Every response is held against the loaded program called directly on
   the batch the daemon formed for it; no request may fail; K1's launches in the window must be
   each program's batches times its launches per batch.  Prints
   requests/s, p50/p99 latency and batch fill per program.
9. int8 phase (`int8_phase`, the W8A8 serving path): kernels (a)-(d) of
   deepsee_torch/csrc/int8conv.cu against their plain versions at every
   quantized conv shape of the main path b32, of the 8x guided full trunk
   b32 (stride 2) and of the trace batch 8, plus a Cin of 72, a 1x1 conv
   and two ragged tilings (a 7x5 image, a stride-2 19x23 one), in bf16 and
   float32 (the maxima and scales bit for bit, x_q and k_q equal, the
   output within one ulp), each main-path and trunk shape timed by device
   time (kernels apart, the op, the bf16 cuDNN conv of the same shape,
   torch._int_mm at the GEMM's M x N x K, the plain version) beside its
   bound, with (d)'s tile plan and its host us per call; the main path under
   int8_inference() (int8 launches as the config reckons them, K1's
   unchanged, ms per batch, PSNR against bf16 and float32, int8_nosmooth,
   a profile), the float32 int8 path against the CPU's plain one (teacher-
   forced); the guided 8x path under int8 and its int8 export; the main
   model exported bf16 and int8 at trace batch 8, the int8 program against
   the live system, both served by one daemon under the aliases bf16 and
   int8 (32 mixed requests, every response against its program); the
   serve, demo and evaluate CLIs with their int8 flags, in processes.
10. Training phase (`training_phase`): each training kernel (batch
   statistics, instance with statistics out, both backwards) against its
   plain version at every shape of the b4 and b16 steps, bf16 and float32,
   timed at b4 with its launch plan and the GB/s of the bytes its design
   moves; a float32 step on the card against the CPU, beside the
   CPU's own spread under weights nudged by 1 and 8 float32 ulps; bf16
   step gradients against float32; the faithful b4 and b16 and reuse_fake
   b4 steps with K1's launches per step checked against `train_norms`,
   timed and profiled; faithful against reuse_fake at b16 in turns; the
   Trainer with a save and a resume; the training CLI for 20 steps with
   one in-training evaluation (fid_iter.txt and metrics_iter.txt).
11. The 32x 512^2 train step and remat (`train512_phase`; it runs first,
   right after the build, while the card holds nothing else, so that its
   memory limits are its own):
   32x_guided_512x512 at full width, bf16, faithful schedule, without remat
   and with each policy ("full", "convs"): ms per step (CUDA events over 3
   steps after a warm-up; at the profiled b8 points also one step alone
   through `profiling.timed`) and peak GiB (`profiling.device_memory_stats`)
   at b2, b4, b8 and the probes b16, b20, b24 (out of memory at a probe is
   the policy's limit), K1's launches per step against `train_norms` (with
   remat, one more forward launch per generator norm); the main preset at
   b16 per policy; a float32 32x b1 step with each policy against one
   without (cuDNN deterministic: buffers and generator states bit for bit,
   gradients within MAX_REMAT_GRAD_REL), which the recompute without its
   replay (a planted fault) must break.
12. Data phase (`data_phase`): the codec or Pillow route against the
   committed corpus, the loader, disk-fed steps and sweeps, the data CLIs.
13. Data-parallel phase (`dp_phase`): K1's batch modes split around the
   cross-rank collective (launch A, launch B; the backward's sums and
   pass) against their plain versions and the one-launch kernels at every
   batch shape of the b16 step and of the dp step, bf16 and float32, timed
   at the dp step's b4 per rank; two ranks on the one card over gloo
   (spawned processes), global b8, a warm-up and 3 faithful steps: float32
   (TF32 off) bit for bit alike across ranks and within MAX_DP_UPDATE_REL
   and MAX_DP_RUNNING_REL of one process at b8, which a planted fault
   (per-rank statistics) must break;
   bf16 ms per step, gloo's host ms, K1's launches per step; then the
   training CLI under torchrun with NCCL at world size 1.
14. Tensor-parallel phase (`tp_phase`): two model ranks spawned on the one
   card over gloo, PRESET at full width (every trunk conv column- or
   row-sharded, min_shard_ch 128), b2 on both: float32 (TF32 off) 2 Adam
   steps, the gathered states bit for bit alike and within
   MAX_TP_UPDATE_REL / MAX_TP_RUNNING_REL of one process, which a planted
   fault (each sharded conv's sigma from its own block) must break; bf16
   ms per step and rank, gloo's host ms, the collectives per step and
   their MiB, K1's launches and channel widths per step against one
   process's, layout copies, peak memory and the state's MiB per rank.
15. Spatial phase (`sp_phase`): two model ranks spawned on the one card
   over gloo, 32x_guided_512x512 at full width with every map cut into two
   horizontal stripes (halo exchanges, K1's statistics across the stripes,
   the networks whole on both ranks): float32 (TF32 off) one Adam step at
   b1, the states bit for bit alike and within MAX_SP_UPDATE_REL /
   MAX_SP_RUNNING_REL of one process, which each planted fault (zero halos;
   per-stripe statistics) must break; inference on stripes (the main path
   b8, the 32x guided path b2) against one process, float32 relative L2
   and bf16 PSNR; bf16 b2 ms per step and rank, gloo's host ms, the halo
   and statistics collectives per step and their MiB, K1's split launches
   per step against one process's one-launch ones, peak GiB per rank
   against one process's; then every K1 call across the stripes (the
   instance split's four launches, the batch split's) against its plain
   version in bf16 and float32 at the ranks' stripe shapes, timed in bf16.
   int8 on stripes (the "sp int8" line): the same two inference paths under
   int8_inference(), float32 and bf16, against one process's int8 fake
   (mean and max |error| within 5e-3 / 0.08, or twice one process's one-ulp
   spread), every quantized conv's scales and k_q on every rank bit for bit
   the plain quantization of its input gathered whole, K4's launches, MAX
   all-reduces and int8 halo bytes per call and rank against the counts
   reckoned from the config; K4 at every stripe shape of the main path's
   call, (d) on the stripes' slabs at pad_h 0 bit for bit its plain version,
   timed beside its bound and the bf16 cuDNN conv of the same slabs (the
   kernels line's `*_on_stripes` rows).  The "nospade" generator of the main
   preset at b8 on stripes against one process, float32 relative L2 (the
   "sp nospade" line).
   Shortened for it (PR 14's counts in the comments beside them): the remat
   probe at b20, the b16 disk-fed steps from batches decoded beforehand,
   the loader at 1 and 4 workers, the 1-ulp nudge of the card-vs-CPU step,
   and fewer timed repeats (TRAIN_STEP_REPS, TRAIN_CLI_STEPS,
   REMAT_STEP_REPS, EVAL_SWEEPS, DATA_TIMED, DP_CLI_STEPS, TP_BF16_STEPS).

Prints each phase's seconds on one line, the card's name and power limit,
one {"kernels": [...]} line (the inference kernels per main-path call, the
training kernels per faithful b4 step and their launches per
tensor-parallel and per spatial step and rank, the split kernels per
data-parallel step and rank, the instance mode's split across stripes per
spatial step and rank, the int8 kernels per int8 main-path call), and as
the last line {"ok": true, "device": {...}}.  Outside the
int8 phase no int8 kernel may launch.  Any
failure exits non-zero; without a CUDA device it exits non-zero at once and
prints no result.  float32 comparisons run with TF32 off
(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
False).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import http.client
import itertools
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
from deepsee_torch.config import MeshConfig, ModelConfig, get_preset
from deepsee_torch.data import DataLoader, SyntheticDataset, codec, create_dataset, to_device
from deepsee_torch.eval import evaluator as evaluator_mod
from deepsee_torch.eval import fid as fid_mod
from deepsee_torch.eval.evaluator import InferenceEvaluator, strict_float32
from deepsee_torch.inference import modes
from deepsee_torch.models import layers as layers_mod
from deepsee_torch.models import remat as remat_mod
from deepsee_torch.models.layers import int8_inference
from deepsee_torch.ops import _build
from deepsee_torch.ops import int8conv as ic
from deepsee_torch.ops import modnorm as mn
from deepsee_torch.ops.resize import resize2d
from deepsee_torch.system import SRSystem
from deepsee_torch.train import steps as train_steps
from deepsee_torch.train.loop import Trainer
from deepsee_torch.train.state import create_train_state, g_params
from deepsee_torch.utils import profiling
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
    dev = torch.device(DEVICE)
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
NUDGE_ULPS = (8,)   # (1, 8) until PR 14; the 1-ulp step dropped for the smoke's time
# bf16 step gradients against float32 ones at the same weights and inputs,
# relative L2 per network: set from the first H100 run, which measured G
# 0.023, E 0.152, D 0.118 (bf16 keeps ~3 digits), with ~2x room.
MAX_BF16_TRAIN_GRAD_REL = 0.3
TRAIN_STEP_REPS = 3                # 5 until PR 14
TRAIN_CLI_STEPS = 12                # 20 until PR 14; the evaluation still at sample 48


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


def train_norms(cfg: ModelConfig, batch: int, g_full: bool, regen: bool = True,
                remat: bool = False):
    """Every K1 launch of one training step:
    [(stats, (B, C, H, W), with_mod, lrelu, forwards, backwards)].  The G
    step runs G, the encoder's trunks and D (on 2B) forward, and backward
    through G, the trunk its coin picked (`g_full`; the guided model's
    encoder has the full trunk alone) and D; the D step regenerates the
    fake (G and the trunks, forward only; not with reuse_fake) and runs D
    forward and backward.  With `remat` the G step's backward runs every
    generator block's forward again: one more forward launch per generator
    norm (the D step's regeneration runs under torch.no_grad, without
    remat)."""
    fwd = 2 if regen else 1
    rows = [("batch", shape, True, True, (fwd + int(remat)) * n, n)
            for _, shape, _, _, n in generator_norms(cfg, batch)]
    guided = cfg.net_e == "fullstyle"
    for full, trunk in ((True, full_trunk_norms), (False, mini_trunk_norms)):
        if guided and not full:
            continue
        rows += [("instance", shape, False, lrelu, fwd, int(guided or full == g_full))
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


def train_shapes(cfg: ModelConfig, batch: int):
    """Every K1 training launch's (stats, shape, with_mod, lrelu) of the
    training step at `batch` (either coin), once each."""
    shapes = {}
    for g_full in (True, False):
        for stats, shape, m, lrelu, _, _ in train_norms(cfg, batch, g_full):
            shapes[(stats, shape, m, lrelu)] = None
    return list(shapes)


def train_kernel_phase(shapes, timed: bool = True):
    """Each training kernel against its plain version at every
    (stats, shape, with_mod, lrelu) of `shapes`, bf16 and float32: the
    forward (out, mean, rstd) and the backward (grad_x, grad_mod) on the
    plain version's statistics.  Where `timed`, bf16: device ms, plain ms,
    library ms and bound of each, forward and backward."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
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
        return mn.instance_plan(shape, dtype, mn.card_sms(torch.device(DEVICE)))
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
        if stats == "instance" and plan.variant == "grid":  # each run's tail read again
            hw, resident = h * w, plan.smem_bytes // (plan.tile * torch.finfo(dtype).bits // 8)
            kept = sum(min(e - s, resident) for s, e in mn.instance_chunks(hw, plan.cluster))
            return once + t * (hw - kept) / hw
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


def train_system(preset: str, batch: int, model=(), mesh: Optional[MeshConfig] = None,
                 **train) -> SRSystem:
    """The preset's training system on the card with seeded random weights
    (as `seeded_system`) and seeded VGG features; `model` and `train`
    override configuration fields, `mesh` the layout."""
    exp = get_preset(preset)
    exp = exp.replace(model=dataclasses.replace(exp.model, **dict(model)),
                      train=dataclasses.replace(exp.train, batch_size=batch, **train),
                      mesh=mesh or exp.mesh)
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


def _one_step(system: SRSystem, batch, coins):
    """Logs, the G, E and D gradients and the train state of one step of
    `system` with fixed coins and SGD at lr 0 (the D step's regeneration
    sees the same G)."""
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
    return {k: float(v) for k, v in logs.items()}, grads, state


def _one_step_grads(system: SRSystem, batch, coins):
    """Logs and the G, E and D gradients of `_one_step`."""
    return _one_step(system, batch, coins)[:2]


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
    """Scale every G, E and D parameter (D where the system has one) by
    (1 + ulps * 2^-23 * r), r ~ N(0, 1): a change at float32's rounding
    level."""
    with torch.no_grad():
        for net in (system.generator, system.encoder, system.discriminator):
            for p in (net.parameters() if net is not None else ()):
                p.mul_(1 + ulps * 2.0 ** -23 * torch.randn(p.shape, generator=generator)
                       .to(p.device))


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


def _counted_step(system: SRSystem, state, step, batch):
    """One step with K1's launch counts set to 0 just before and read just
    after, held against `train_norms` for the coins the step drew, the
    schedule and the generator's remat; its losses must be finite.
    Returns the launches, the norms, the coins and the losses."""
    drawn = []
    draw = train_steps.draw_coins
    train_steps.draw_coins = (lambda system_, generator:
                              drawn.append(draw(system_, generator)) or drawn[-1])
    torch.cuda.synchronize()
    mn.reset_launches()
    try:
        logs = step(state, batch)
        torch.cuda.synchronize()
    finally:
        train_steps.draw_coins = draw
    launches = {k: mn.launches[k] for k in TRAIN_MODES}
    others = {k: n for k, n in mn.launches.items() if k not in TRAIN_MODES and n}
    norms = train_norms(system.cfg, len(batch["label"]), g_full=drawn[0][0],
                        regen=not system.exp.train.reuse_fake, remat=system.generator.remat)
    expected = train_launches(norms)
    if launches != expected or others:
        raise AssertionError(f"K1 launches {launches} {others} != {expected} "
                             f"(remat {system.generator.remat})")
    logs = {k: float(v) for k, v in logs.items()}
    if not all(math.isfinite(v) for v in logs.values()):
        raise AssertionError(f"a loss is not finite: {logs}")
    return launches, norms, drawn, logs


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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, norms, drawn, logs = _counted_step(system, state, step, batch)
    layout = mn.layout_copies["backward"]
    log(f"{tag} launches per step: {launches} (as train_norms reckons them), layout copies "
        f"{layout}, coins {drawn}, losses {logs}")
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
        timing["idle_share"] = profile_train(tag, system, state, step, batch, ms)
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


def profile_train(tag: str, system: SRSystem, state, step, batch, ms_per_step: float) -> float:
    """Device time of one step by category (torch.profiler), the VGG's and
    the optimizers' device time by record_function range, and the idle share
    = 1 - kernel time / the event-timed ms per step, which it returns."""
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
    return 1.0 - total / ms_per_step


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
               os.path.join(root, "cli"), *TRAIN_CLI_EVAL]
        t_cli = time.perf_counter()
        run = subprocess.run(cli, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t_cli
        if run.returncode != 0 or f"trained {TRAIN_CLI_STEPS} steps on {DEVICE}" not in run.stdout:
            raise AssertionError(f"the training CLI failed: {run.stdout[-2000:]}"
                                 f"{run.stderr[-2000:]}")
        cli_files = sorted(os.listdir(os.path.join(root, "cli", PRESET)))
        history = {}
        for name in ("fid_iter.txt", "metrics_iter.txt"):
            path = os.path.join(root, "cli", PRESET, name)
            if not os.path.exists(path):
                raise AssertionError(f"the training CLI's evaluation wrote no {name}")
            with open(path) as f:
                history[name] = f.read().splitlines()
            if len(history[name]) != 1:
                raise AssertionError(f"the training CLI evaluated {len(history[name])} times")
        log("trainer " + json.dumps({"files": files, "cli": " ".join(cli[1:]),
                                     "cli_s": cli_s, "cli_files": cli_files,
                                     "cli_evaluation": history, "card": smi,
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
    rows = train_kernel_phase(train_shapes(cfg, TRAIN_BATCH))
    rows += train_kernel_phase(train_shapes(cfg, TRAIN_BATCH_LARGE), timed=False)
    log(f"train kernel phase: {time.perf_counter() - t0:.1f} s")
    train_gradient_checks(TRAIN_BATCH)
    launches, times, b4 = drive_train("train b4", TRAIN_BATCH, rows=rows)
    b16 = drive_train("train b16", TRAIN_BATCH_LARGE)[2]
    drive_train("train reuse_fake b4", TRAIN_BATCH, reuse_fake=True, profile=False)
    compare_schedules(TRAIN_BATCH_LARGE)
    trainer_phase(smi)
    log(f"training phase: {time.perf_counter() - t0:.1f} s")
    return (launches, times, rows), {TRAIN_BATCH: b4, TRAIN_BATCH_LARGE: b16}


# -- the 32x 512^2 train step and remat --------------------------------------

REMAT_POLICIES = (None, "full", "convs")   # None: no remat
REMAT_GRID = (2, 4, 8)                     # timed, every policy
REMAT_PROBES = (16, 24)                    # timed where they fit; out of memory is that
                                           # policy's limit (b20 dropped: PR 13 measured it)
REMAT_STEP_REPS = 2                        # 3 until PR 14
REMAT_PROFILED = 8                         # one step traced at this batch ...
REMAT_PROFILED_POLICIES = (None, "full")   # ... under these policies
# remat against no remat, float32 at the 32x preset's full width, batch 1,
# cuDNN deterministic: buffers and generator states bit for bit, each
# network's gradients (concatenated) within this relative L2
MAX_REMAT_GRAD_REL = 1e-6
REPLAYED = remat_mod.REPLAYED_BUFFERS


def _set_remat(system: SRSystem, policy: Optional[str]) -> None:
    system.generator.remat = policy is not None
    system.generator.remat_policy = policy or "full"


def _remat_timing(system: SRSystem, state, step, batch, reps: int,
                  profile_tag: Optional[str] = None) -> dict:
    """A warm-up step, one step with its K1 launches checked, then `reps`
    steps timed by CUDA events with the peak memory read around them
    (`profiling.device_memory_stats`); with `profile_tag`, one more step
    timed alone after a synchronize (`profiling.timed`) and one step
    profiled (`profile_train`)."""
    step(state, batch)
    launches = _counted_step(system, state, step, batch)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _step_events_ms(step, state, batch, reps)
    peak = profiling.device_memory_stats()[f"cuda:{torch.cuda.current_device()}"]
    out = {"ms_per_step": ms, "img_per_s": len(batch["label"]) / ms * 1e3,
           "peak_gib": peak["peak_bytes_in_use_gb"], "steps_timed": reps,
           "k1_launches": launches}
    if profile_tag is not None:
        # one step alone, the card idle before it (its start waits on the host)
        out["ms_one_step_synced"] = profiling.timed(step, state, batch, iters=1,
                                                    warmup=0)["median_s"] * 1e3
        out["idle_share"] = profile_train(profile_tag, system, state, step, batch, ms)
    return out


def remat_grid(preset: str, batches, probes, smi: str) -> dict:
    """Each policy at each of `batches` and `probes` (REMAT_STEP_REPS timed
    steps; torch.OutOfMemoryError at a probe, and only there, ends the
    policy's probes and is logged as its limit), from one seeded bf16
    training system whose generator's remat is switched between policies.
    Returns {(policy, batch): timing or None}."""
    system = train_system(preset, batches[0])
    state = _state_of(system)
    step = train_steps.make_train_step(system)
    guided = system.cfg.net_e == "fullstyle"
    out = {}
    for policy in REMAT_POLICIES:
        _set_remat(system, policy)
        name = policy or "off"
        for batch_n in batches + probes:
            batch = make_batch(system.cfg, batch_n, guided=guided)
            try:
                profiled = batch_n == REMAT_PROFILED and policy in REMAT_PROFILED_POLICIES
                out[name, batch_n] = _remat_timing(
                    system, state, step, batch, REMAT_STEP_REPS,
                    f"train {preset} remat {name} b{batch_n}" if profiled else None)
            except torch.OutOfMemoryError:
                if batch_n not in probes:
                    raise
                out[name, batch_n] = None
            finally:
                del batch
                gc.collect()
                torch.cuda.empty_cache()
            timing = out[name, batch_n]
            log(f"train {preset} remat {name} b{batch_n} " + (
                json.dumps(timing) if timing is not None else "out of memory (the policy's "
                "limit)") + f" [{smi}]")
            if timing is None:
                break
    del system, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _remat_readings(got, want) -> dict:
    """A float32 step with remat (`got`: logs, gradients, state, buffers)
    against one without (`want`)."""
    (logs, grads, state, buffers), (wlogs, wgrads, wstate, wbuffers) = got, want
    rel = {}
    for net in wgrads:
        a = torch.cat([grads[net][k].double().reshape(-1) for k in wgrads[net]])
        b = torch.cat([wgrads[net][k].double().reshape(-1) for k in wgrads[net]])
        rel[net] = float((a - b).norm() / b.norm())
    differing = [k for k in wbuffers if not torch.equal(buffers[k], wbuffers[k])]
    rng = all(torch.equal(a.get_state(), b.get_state()) for a, b in
              ((state.coin_rng, wstate.coin_rng), (state.noise_rng, wstate.noise_rng)))
    return {"grad_rel_l2": rel, "buffers_differing": len(differing),
            "buffers_checked": len(wbuffers), "first_differing": differing[:3],
            "generator_states_equal": rng,
            "max_log_diff": max(abs(logs[k] - wlogs[k]) for k in wlogs),
            "ok": (not differing and rng and max(rel.values()) <= MAX_REMAT_GRAD_REL)}


def remat_f32_check(smi: str) -> dict:
    """One float32 step of the 32x preset at full width, batch 1, TF32 off
    and cuDNN deterministic, without remat, with each policy, and with
    "full" and the replay taken out of the recompute (the planted fault):
    each policy must match the step without remat (buffers and the coin and
    noise generators' states bit for bit, gradients within
    MAX_REMAT_GRAD_REL), and the planted fault must not."""
    system = train_system(PRESET_512, 1, model=dict(compute_dtype="float32"))
    batch = make_batch(system.cfg, 1, guided=True)
    start = {name: {k: v.clone() for k, v in net.state_dict().items()}
             for name, net in system.networks().items()}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def run(policy, fault=False):
        for name, net in system.networks().items():
            net.load_state_dict(start[name])
        _set_remat(system, policy)
        recompute = remat_mod._Replay.recompute
        if fault:
            remat_mod._Replay.recompute = lambda self: contextlib.nullcontext()
        try:
            logs, grads, state = _one_step(system, batch, (True, False))
            torch.cuda.synchronize()
        finally:
            remat_mod._Replay.recompute = recompute
        buffers = {f"{name}.{k}": v.clone() for name, net in system.networks().items()
                   for k, v in net.state_dict().items() if k.endswith(REPLAYED)}
        return logs, grads, state, buffers

    try:
        t0 = time.perf_counter()
        want = run(None)
        out = {policy: _remat_readings(run(policy), want) for policy in ("full", "convs")}
        out["full, planted fault"] = _remat_readings(run("full", fault=True), want)
        out["wall_s"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
        del system
        torch.cuda.empty_cache()
    log(f"train remat float32 {PRESET_512} b1 " + json.dumps(out) + f" [{smi}]")
    if not (out["full"]["ok"] and out["convs"]["ok"]):
        raise AssertionError(f"a float32 step with remat differs from the step without: {out}")
    if out["full, planted fault"]["ok"]:
        raise AssertionError("the recompute without its replay passed the remat check")
    return out


def train512_phase(smi: str) -> dict:
    """The 32x 512^2 guided training step (PRESET_512 at full width, bf16,
    faithful schedule, seeded weights and guided batch) without remat and
    with each policy: ms per step and peak memory at REMAT_GRID, the probes
    at REMAT_PROBES, K1's launches per step against `train_norms` with
    remat; the main preset at TRAIN_BATCH_LARGE under each policy; the
    float32 remat check and its planted fault."""
    t0 = time.perf_counter()
    log("train 512 phase: card memory at its start " + json.dumps(profiling.device_memory_stats()))
    grid = remat_grid(PRESET_512, REMAT_GRID, REMAT_PROBES, smi)
    largest = {p or "off": max(b for (name, b), t in grid.items() if name == (p or "off")
                               and t is not None) for p in REMAT_POLICIES}
    at = largest["off"]
    cost = {name: grid[name, at]["ms_per_step"] / grid["off", at]["ms_per_step"]
            for name in ("full", "convs") if grid.get((name, at))}
    saved = {name: 1 - grid[name, at]["peak_gib"] / grid["off", at]["peak_gib"]
             for name in ("full", "convs") if grid.get((name, at))}
    summary = {"largest_batch": largest, "at_largest_off_batch": at,
               "ms_ratio_to_off": cost, "peak_saved_share": saved}
    log(f"train {PRESET_512} remat summary " + json.dumps(summary) + f" [{smi}]")
    main = remat_grid(PRESET, (TRAIN_BATCH_LARGE,), (), smi)
    check = remat_f32_check(smi)
    log(f"train 512 phase: {time.perf_counter() - t0:.1f} s")
    return {"grid": grid, "summary": summary, "main": main, "f32": check}


# -- evaluation ----------------------------------------------------------------

EVAL_BATCH = 16
EVAL_SAMPLES = 128
EVAL_SWEEPS = 2        # 3 until PR 14
# the training CLI's evaluation: in its 20 b4 steps (80 samples) the count of
# samples crosses a multiple of 48 once; 16 samples per evaluation
TRAIN_CLI_EVAL = ("--evaluation_freq", "48", "--num_evaluation_samples", "16")
# float32 card (TF32 off) vs the plain CPU path, 2 samples at full width.
# The generators differ by ~1e-5 (MAX_F32_CPU_DIFF's runs), which can move
# a pixel across a uint8 level (PSNR, SSIM): limits in dB and SSIM units.
MAX_EVAL_PSNR_DB_DIFF = 1e-3
MAX_EVAL_SSIM_DIFF = 1e-4       # SSIM and MS-SSIM
MAX_EVAL_RMSE_DIFF = 1e-5
MAX_EVAL_REL_L2 = 1e-4          # LPIPS and the pool3 activations, relative L2
# the Inception network in float32 (TF32 off) vs float64 on the card
MAX_INCEPTION_F64_REL_L2 = 1e-4
EVAL_STAGES = ("preprocess", "encode+generate", "metrics", "lpips", "inception x2")


def _rel_l2(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


@contextlib.contextmanager
def _tf32():
    """cuDNN and cuBLAS float32 in TF32 inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def eval_stage_profile(ev: InferenceEvaluator, device_batch) -> dict:
    """One batch through `ev.sweep` under torch.profiler, its stages in
    record_function ranges: device ms per stage (kernels launched inside)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, fn):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    system = ev.system
    saved = (system.preprocess, system.generate, evaluator_mod.batch_metrics, ev.lpips,
             evaluator_mod.fid_mod.inception_pool3)
    system.preprocess = ranged("preprocess", saved[0])
    system.generate = ranged("encode+generate", saved[1])
    evaluator_mod.batch_metrics = ranged("metrics", saved[2])
    ev.lpips = ranged("lpips", saved[3])
    evaluator_mod.fid_mod.inception_pool3 = ranged("inception x2", saved[4])
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev.sweep(device_batch)
            torch.cuda.synchronize()
    finally:
        del system.preprocess, system.generate
        evaluator_mod.batch_metrics, ev.lpips = saved[2], saved[3]
        evaluator_mod.fid_mod.inception_pool3 = saved[4]
    return {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
            if e.key in EVAL_STAGES}


def eval_stage_event_ms(ev: InferenceEvaluator, device_batch) -> dict:
    """The same stages of one batch, each timed alone by CUDA events on
    resident tensors (device ms per call)."""
    system = ev.system
    with torch.inference_mode():
        pre = system.preprocess(device_batch)
        fake, _ = system.generate(pre, use_full=False, no_noise=True)
        real = pre["image_hr"]
        out = {"preprocess": _event_ms(lambda: system.preprocess(device_batch)),
               "encode+generate": _event_ms(
                   lambda: system.generate(pre, use_full=False, no_noise=True)),
               "metrics": _event_ms(lambda: evaluator_mod.batch_metrics(fake, real))}
        with strict_float32():
            out["lpips"] = _event_ms(lambda: ev.lpips(fake, real))
            out["inception x2"] = _event_ms(lambda: (fid_mod.inception_pool3(ev.inception, fake),
                                                     fid_mod.inception_pool3(ev.inception, real)))
    return out


def profile_eval_sweep(ev: InferenceEvaluator, loader) -> float:
    """Device ms of every kernel of one end-to-end sweep (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.run(loader)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False))


def eval_card_vs_cpu(system: SRSystem, batch) -> dict:
    """Two samples at full width in float32 (TF32 off) through the sweep on
    the card and through the plain CPU path, the same weights (the metric
    networks' seeded fallbacks are drawn on the CPU); then the Inception
    network alone in float32 against float64 on the card."""
    two = {k: v[:2] for k, v in batch.items()}
    ev_card = InferenceEvaluator(_like(system, "float32", DEVICE), 2)
    t0 = time.perf_counter()
    ev_cpu = InferenceEvaluator(_like(system, "float32", "cpu"), 2)
    cpu = ev_cpu.sweep(to_device(two, "cpu"))
    cpu_s = time.perf_counter() - t0
    card = {k: v.cpu() for k, v in ev_card.sweep(to_device(two, DEVICE)).items()}
    out = {"cpu_s": cpu_s}
    for key, limit in (("psnr", MAX_EVAL_PSNR_DB_DIFF), ("ssim", MAX_EVAL_SSIM_DIFF),
                       ("ms_ssim", MAX_EVAL_SSIM_DIFF), ("rmse", MAX_EVAL_RMSE_DIFF)):
        both_nan = torch.isnan(card[key]) & torch.isnan(cpu[key])
        diff = torch.where(both_nan, torch.zeros_like(card[key]), (card[key] - cpu[key]).abs())
        out[f"{key}_max_abs_diff"] = float(diff.max())
        if not float(diff.max()) <= limit:
            raise AssertionError(f"eval card vs CPU: {key} differs by {float(diff.max())} "
                                 f"(card {card[key].tolist()}, CPU {cpu[key].tolist()})")
    for key in ("lpips", "act_fake", "act_real"):
        out[f"{key}_rel_l2"] = rel = _rel_l2(card[key], cpu[key])
        if not rel <= MAX_EVAL_REL_L2:
            raise AssertionError(f"eval card vs CPU: {key} relative L2 {rel}")
    real = to_device(two, DEVICE)["image_hr"].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    x = 2.0 * resize2d((real + 1.0) / 2.0, (299, 299), method="bilinear") - 1.0
    with torch.inference_mode(), strict_float32():
        y32 = ev_card.inception(x)
        y64 = copy.deepcopy(ev_card.inception).double()(x.double())
    out["inception_f32_vs_f64_rel_l2"] = rel = _rel_l2(y32, y64)
    if not rel <= MAX_INCEPTION_F64_REL_L2:
        raise AssertionError(f"Inception float32 vs float64 on the card: relative L2 {rel}")
    return out


def eval_tf32(ev: InferenceEvaluator, pairs) -> dict:
    """FID of the sweep's samples and the LPIPS mean with the metric networks
    in strict float32 (the evaluator's default) and in TF32, and the
    Inception's device ms per batch (both sets) each way."""
    out = {}
    acts = {}
    for mode, ctx in (("strict_float32", strict_float32), ("tf32", _tf32)):
        with torch.inference_mode(), ctx():
            af, ar, lp = [], [], []
            for fake, real in pairs:
                af.append(fid_mod.inception_pool3(ev.inception, fake))
                ar.append(fid_mod.inception_pool3(ev.inception, real))
                lp.append(ev.lpips(fake, real))
            fake, real = pairs[0]
            out[f"{mode}_inception_ms_per_batch"] = _event_ms(
                lambda: (fid_mod.inception_pool3(ev.inception, fake),
                         fid_mod.inception_pool3(ev.inception, real)), reps=5)
        acts[mode] = torch.cat(af), torch.cat(ar)
        out[f"{mode}_fid"] = fid_mod.fid_from_activations(acts[mode][0].cpu().numpy(),
                                                          acts[mode][1].cpu().numpy())
        out[f"{mode}_lpips_mean"] = float(torch.cat(lp).mean())
    out["pool3_tf32_vs_strict_rel_l2"] = _rel_l2(acts["tf32"][0], acts["strict_float32"][0])
    return out


def time_sweep(ev: InferenceEvaluator, loader):
    """`ev.run(loader)` once to warm up, then EVAL_SWEEPS times (host clock,
    `eval_seconds`), each checked; the loader's batches alone; the
    device-only sweep over them made resident first; a profiled sweep's
    kernel ms and the idle share = 1 - kernel ms / the median end-to-end
    sweep.  Returns (summary, host batches, device batches, the device
    sweep's outputs, the timed runs' results)."""
    warm = ev.run(loader)
    runs = [ev.run(loader) for _ in range(EVAL_SWEEPS)]
    eval_s = float(np.median([r["eval_seconds"] for r in runs]))
    for r in [warm] + runs:
        if r["n_samples"] != ev.num_samples or not all(
                np.isfinite(r[k]) for k in ("FID", "psnr/mean", "ssim/mean", "rmse/mean",
                                            "lpips/mean")):
            raise AssertionError(f"eval sweep: bad result {r}")
    t0 = time.perf_counter()
    host_batches = list(loader)
    loader_s = time.perf_counter() - t0
    device_batches = [to_device(b, DEVICE) for b in host_batches]

    def device_sweep():
        outs = [ev.sweep(b) for b in device_batches]
        torch.cuda.synchronize()
        return outs

    device_sweep()
    device_s = []
    for _ in range(EVAL_SWEEPS):
        t0 = time.perf_counter()
        outs = device_sweep()
        device_s.append(time.perf_counter() - t0)
    kernel_ms = profile_eval_sweep(ev, loader)
    summary = {
        "eval_seconds": [r["eval_seconds"] for r in runs], "eval_s_median": eval_s,
        "warmup_eval_seconds": warm["eval_seconds"], "img_per_s": ev.num_samples / eval_s,
        "loader_s (the host's batches alone)": loader_s, "device_sweep_s": device_s,
        "device_img_per_s": ev.num_samples / float(np.median(device_s)),
        "kernel_ms_per_sweep": kernel_ms, "idle_share": 1.0 - kernel_ms / (eval_s * 1e3)}
    return summary, host_batches, device_batches, outs, runs


def evaluation_phase(system: SRSystem, smi: str) -> dict:
    """The evaluation sweep in the shape of scripts/bench_eval.py, on the main
    path's bf16 system: InferenceEvaluator with FID and LPIPS (seeded random
    metric networks), batch EVAL_BATCH, EVAL_SAMPLES synthetic samples
    through the DataLoader (`time_sweep`: end to end, device-only, idle
    share); the FID's host seconds; one profiled batch's device ms by stage
    with K1's launches counted; card vs CPU; TF32 against strict float32.
    Returns the sweep's summary."""
    t_phase = time.perf_counter()
    cfg = system.cfg
    exp = system.exp.replace(train=dataclasses.replace(system.exp.train, batch_size=EVAL_BATCH))
    ev = InferenceEvaluator(system, EVAL_SAMPLES)
    loader = DataLoader(SyntheticDataset(exp, length=EVAL_SAMPLES), EVAL_BATCH, shuffle=False)
    sweep, host_batches, device_batches, outs, runs = time_sweep(ev, loader)
    af = torch.cat([o["act_fake"] for o in outs]).cpu().numpy()
    ar = torch.cat([o["act_real"] for o in outs]).cpu().numpy()
    t0 = time.perf_counter()
    fid = fid_mod.fid_from_activations(af, ar)
    fid_s = time.perf_counter() - t0

    mn.reset_launches()
    stages = eval_stage_profile(ev, device_batches[0])
    launches = dict(mn.launches)
    expected = expected_launches(path_norms(cfg, EVAL_BATCH, full_trunk=False))
    if launches != expected:
        raise AssertionError(f"eval sweep: modnorm launches per batch {launches} != {expected}")

    log("eval sweep " + json.dumps({
        "preset": PRESET, "batch": EVAL_BATCH, "num_samples": EVAL_SAMPLES, "card": smi,
        "fid_exact": ev.fid_exact, "lpips_exact": ev.lpips_exact, **sweep,
        "fid_s": fid_s, "fid_share": fid_s / sweep["eval_s_median"], "fid": runs[-1]["FID"],
        "fid_of_device_sweep": fid, "lpips_mean": runs[-1]["lpips/mean"],
        "psnr_mean": runs[-1]["psnr/mean"], "ssim_mean": runs[-1]["ssim/mean"],
        "ms_ssim_mean": runs[-1]["ms_ssim/mean"], "rmse_mean": runs[-1]["rmse/mean"]}))
    log("eval stages " + json.dumps({
        "profiled_batch_device_ms": stages,
        "event_ms_each_stage_alone": eval_stage_event_ms(ev, device_batches[0]),
        "launches": launches, "expected": expected, "card": smi}))
    with torch.inference_mode():
        pairs = [ev.run_batch(b) for b in device_batches]
    log("eval tf32 " + json.dumps({**eval_tf32(ev, pairs), "card": smi}))
    del pairs, device_batches, outs
    torch.cuda.empty_cache()
    log("eval card vs CPU " + json.dumps({**eval_card_vs_cpu(system, host_batches[0]),
                                          "card": smi}))
    log(f"evaluation phase: {time.perf_counter() - t_phase:.1f} s")
    return sweep


# -- the data path -------------------------------------------------------------

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                      "torch_corpus")
# dataset of the committed corpus -> (the preset whose transform expected.npz
# holds, the file stems)
CORPUS_LAYOUT = {"celebamaskhq": ("8x_independent_256x256", ("0", "1")),
                 "celeba": ("8x_independent_128x128", ("000001", "000002"))}
DATA_SAMPLES = 128           # the CelebAMask-HQ tree: copies of the corpus's 2 pairs
DATA_IDENTITY_GROUP = 4      # samples per identity in its identities CSV
DATA_LOADER_BATCH = 16
DATA_GUIDED = "8x_guided_256x256"
# disk-fed steps of Trainer.run: warm-up, timed by events, profiled
DATA_WARMUP, DATA_TIMED, DATA_PROFILED = 3, 5, 2   # 10 timed until PR 14
DATA_GUIDED_STEPS = 6
# disk-fed runs of the main preset: (batch, how the batches come, `disk_fed_train`)
# (PR 8's b16 from batches decoded beforehand is no longer run: the smoke's
# time goes to the spatial phase)
DATA_TRAIN_BATCHES = (TRAIN_BATCH, TRAIN_BATCH_LARGE)
DATA_CLI_STEPS = 2
DATA_CLI_EVAL_SAMPLES = 16


def decode_routes(smi: str) -> str:
    """Build the native codec (its seconds printed), then decode the
    committed corpus through every route this machine has (the codec;
    Pillow) under each preset's transform, flipped and not, and hold each
    against expected.npz: float32 pixels and labels equal, the largest
    uint8 level difference printed.  The codec may be missing only where
    its headers are (the compiler says so).  Returns the route the datasets
    take ("codec" or "pillow")."""
    from deepsee_torch.data import transforms
    from deepsee_torch.data.datasets import CelebADataset

    t0 = time.perf_counter()
    built = codec.available()
    build_s = time.perf_counter() - t0
    reason = codec.unavailable_reason()
    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = None
    log("data codec " + json.dumps({"built": built, "build_s": build_s, "pillow": pillow,
                                    "reason": reason and reason[-600:], "card": smi}))
    if not built and "h: No such file or directory" not in (reason or ""):
        raise AssertionError(f"the native codec did not build: {reason}")
    routes = ({"codec": "on"} if built else {}) | ({"pillow": "off"} if pillow else {})
    if not routes:
        raise AssertionError("no decode route: the codec did not build and Pillow is missing")
    with np.load(os.path.join(CORPUS, "expected.npz")) as f:
        expected = {k: f[k] for k in f.files}
    for route, mode in routes.items():
        worst, t0, decoded = {"image_levels": 0, "label_mismatches": 0}, time.perf_counter(), 0
        for dataset, (preset, stems) in CORPUS_LAYOUT.items():
            exp = get_preset(preset)
            data = dataclasses.replace(exp.data, native_codec=mode)
            label_mode = CelebADataset.label_preprocess_mode if dataset == "celeba" else None
            for stem, flip in ((s, f) for s in stems for f in (False, True)):
                params = transforms.TransformParams((0, 0), flip)
                x = transforms.load_image(os.path.join(CORPUS, dataset, "images", f"{stem}.jpg"),
                                          data, exp.model, params, True)
                y = transforms.load_label(os.path.join(CORPUS, dataset, "labels", f"{stem}.png"),
                                          data, exp.model, params, True, label_mode)
                u8 = expected[f"{dataset}/{stem}/image"]
                lab = expected[f"{dataset}/{stem}/label"]
                if flip:
                    u8, lab = u8[:, ::-1], lab[:, ::-1]
                levels = np.abs(np.rint((x.astype(np.float64) + 1.0) * 127.5) - u8).max()
                worst["image_levels"] = max(worst["image_levels"], int(levels))
                worst["label_mismatches"] += int((y != lab).sum())
                if not (np.array_equal(x, u8.astype(np.float32) / 255.0 * 2.0 - 1.0)
                        and np.array_equal(y, lab)):
                    raise AssertionError(f"data decode: route {route} differs from "
                                         f"expected.npz on {dataset}/{stem} flip={flip}: "
                                         f"{worst}")
                decoded += 1
        log("data decode " + json.dumps({"route": route, "pairs": decoded, **worst,
                                         "s": time.perf_counter() - t0, "card": smi}))
    return "codec" if built else "pillow"


def data_tree(root: str):
    """A CelebAMask-HQ tree of DATA_SAMPLES samples in `root`: the corpus's 2
    image / label pairs copied under stems 0..DATA_SAMPLES-1, and an
    identities CSV in groups of DATA_IDENTITY_GROUP.  Returns (image dir,
    label dir, identities file)."""
    images, labels = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(images)
    os.makedirs(labels)
    src = os.path.join(CORPUS, "celebamaskhq")
    for i in range(DATA_SAMPLES):
        shutil.copyfile(os.path.join(src, "images", f"{i % 2}.jpg"),
                        os.path.join(images, f"{i}.jpg"))
        shutil.copyfile(os.path.join(src, "labels", f"{i % 2}.png"),
                        os.path.join(labels, f"{i}.png"))
    ids = os.path.join(root, "identities.csv")
    with open(ids, "w") as f:
        f.write("hq_file_id,identity\n")
        f.writelines(f"{i},{i // DATA_IDENTITY_GROUP}\n" for i in range(DATA_SAMPLES))
    return images, labels, ids


def tree_experiment(preset: str, tree, batch_n: int, **kw):
    """The preset reading the tree at batch_n; it saves no per-epoch
    checkpoint (the steps around an epoch's end are timed)."""
    exp = get_preset(preset, **kw)
    return exp.replace(
        data=dataclasses.replace(exp.data, image_dir=tree[0], label_dir=tree[1],
                                 identities_file=tree[2]),
        train=dataclasses.replace(exp.train, batch_size=batch_n, save_epoch_freq=10 ** 9))


def loader_timing(tree, route: str, smi: str) -> None:
    """The loader alone over the tree (the preset's transform, 1024^2 JPEG
    -> 256^2 and 512^2 PNG -> 256^2), one shuffled epoch at batch
    DATA_LOADER_BATCH per worker count, after one epoch that warms the
    page cache: samples/s and wall ms per sample."""
    dataset = create_dataset(tree_experiment(PRESET, tree, DATA_LOADER_BATCH), phase="train")
    counts = sorted({2, 8, os.cpu_count() or 1})   # 1 and 4 workers: PR 8's runs
    for _ in DataLoader(dataset, DATA_LOADER_BATCH, num_workers=max(counts)):
        pass
    rows = []
    for n in counts:
        loader = DataLoader(dataset, DATA_LOADER_BATCH, num_workers=n, seed=SEED)
        t0 = time.perf_counter()
        seen = sum(len(b["path"]) for b in loader)
        dt = time.perf_counter() - t0
        if seen != DATA_SAMPLES:
            raise AssertionError(f"data loader: {seen} samples of {DATA_SAMPLES}")
        rows.append({"workers": n, "samples_per_s": seen / dt, "ms_per_sample": dt * 1e3 / seen})
    log("data loader " + json.dumps({"preset": PRESET, "batch": DATA_LOADER_BATCH,
                                     "samples": DATA_SAMPLES, "route": route,
                                     "cpu_count": os.cpu_count(), "rows": rows, "card": smi}))


def disk_fed_train(tag: str, preset: str, batch_n: int, tree, root: str, steps: int,
                   resident: Optional[dict] = None) -> dict:
    """Trainer.run from the tree for `steps` steps: K1's launches of step
    DATA_WARMUP - 1 (the independent model's against `train_norms`), ms per
    step by CUDA events over up to DATA_TIMED steps after the warm-up, then
    kernel ms per step over the steps left (profiled) and the idle share,
    beside the resident-batch step of the training phase (`resident`).  The
    batches come from `make_dataloader()` (shuffled, its decode threads, the
    prefetch of the next batch to the card on a copy stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_call = time.perf_counter()
    exp = tree_experiment(preset, tree, batch_n, checkpoints_dir=os.path.join(root, tag))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        trainer = Trainer(exp, device=DEVICE)
    step = trainer.step_gd
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    seen = {"logs": []}
    timed_to = min(DATA_WARMUP + DATA_TIMED, steps)

    def measured(state, batch):
        i = state.step
        if i == DATA_WARMUP - 1:
            torch.cuda.synchronize()
            mn.reset_launches()
        elif i == DATA_WARMUP:
            start.record()
        elif i == timed_to:
            end.synchronize()
            prof.start()
        logs = step(state, batch)
        if i == DATA_WARMUP - 1:
            torch.cuda.synchronize()
            seen["launches"] = {k: mn.launches[k] for k in TRAIN_MODES}
        if i == timed_to - 1:
            end.record()
        if i == steps - 1 and steps > timed_to:
            torch.cuda.synchronize()
            prof.stop()
        seen["logs"].append(logs)
        return logs

    trainer.step_gd = measured
    t0 = time.perf_counter()
    state = trainer.run(max_steps=steps)
    wall_s = time.perf_counter() - t0
    end.synchronize()
    ms = start.elapsed_time(end) / (timed_to - DATA_WARMUP)
    losses = {k: float(v) for k, v in seen["logs"][-1].items()}
    if state.step != steps or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{tag}: {state.step} steps, losses {losses}")
    out = {"preset": preset, "batch": batch_n, "feed": "loader", "steps": steps, "wall_s": wall_s,
           "ms_per_step": ms, "img_per_s": batch_n / ms * 1e3,
           "launches": seen["launches"], "losses": losses}
    if exp.model.model_variant == "independent":
        want = train_launches(train_norms(exp.model, batch_n, g_full=True))
        if seen["launches"] != want:
            raise AssertionError(f"{tag}: K1 launches per step {seen['launches']} != {want}")
        out["expected_launches"] = want
    if steps > timed_to:
        kernel_ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                        and not getattr(e, "is_user_annotation", False)) / (steps - timed_to)
        out.update({"kernel_ms_per_step": kernel_ms, "idle_share": 1.0 - kernel_ms / ms})
    if resident is not None:
        out["resident_batch (training phase)"] = {
            k: resident.get(k) for k in ("ms_per_step", "img_per_s", "idle_share")}
    del trainer, state, prof
    torch.cuda.empty_cache()
    out["call_s"] = time.perf_counter() - t_call
    return out


def disk_fed_sweep(tree, synthetic: dict, smi: str) -> None:
    """The evaluation sweep (`time_sweep`) at EVAL_BATCH over the tree's
    DATA_SAMPLES samples, read as python -m deepsee_torch.evaluate reads a
    test set (phase "test", file order, the loader's 4 decode workers), on
    the main path's bf16 system, beside the evaluation phase's synthetic
    sweep; K1's launches per batch."""
    system = seeded_system(PRESET)
    exp = tree_experiment(PRESET, tree, EVAL_BATCH, is_train=False)
    dataset = create_dataset(exp.replace(data=dataclasses.replace(exp.data, phase="test")),
                             phase="test")
    ev = InferenceEvaluator(system, DATA_SAMPLES)
    loader = DataLoader(dataset, EVAL_BATCH, shuffle=False, drop_last=True, num_workers=4)
    disk, _, device_batches, _, _ = time_sweep(ev, loader)
    mn.reset_launches()
    with torch.inference_mode():
        ev.sweep(device_batches[0])
    torch.cuda.synchronize()
    launches = dict(mn.launches)
    expected = expected_launches(path_norms(system.cfg, EVAL_BATCH, full_trunk=False))
    if launches != expected:
        raise AssertionError(f"data eval sweep: K1 launches per batch {launches} != {expected}")
    keys = ("img_per_s", "device_img_per_s", "idle_share", "eval_s_median",
            "loader_s (the host's batches alone)")
    log("data eval sweep " + json.dumps({
        "preset": PRESET, "batch": EVAL_BATCH, "samples": DATA_SAMPLES,
        "disk (4 workers)": disk,
        "synthetic (evaluation phase)": {k: synthetic[k] for k in keys},
        "launches_per_batch": launches, "expected": expected, "card": smi}))
    del system, ev, device_batches
    torch.cuda.empty_cache()


def data_clis(tree, root: str, smi: str) -> None:
    """python -m deepsee_torch.train from the tree for DATA_CLI_STEPS steps
    (its checkpoint files), then python -m deepsee_torch.evaluate on the
    tree with that checkpoint (the CSV's ID column: the file stems in
    order), each in a process of its own."""
    ckpt = os.path.join(root, "cli")
    train = [sys.executable, "-m", "deepsee_torch.train", "--name", PRESET, "--image_dir",
             tree[0], "--label_dir", tree[1], "--max_steps", str(DATA_CLI_STEPS), "--device",
             DEVICE, "--checkpoints_dir", ckpt]
    out = os.path.join(root, "eval_out")
    evaluate = [sys.executable, "-m", "deepsee_torch.evaluate", "--name", PRESET, "--image_dir",
                tree[0], "--label_dir", tree[1], "--checkpoints_dir", ckpt, "--batch_size",
                str(EVAL_BATCH), "--num_samples", str(DATA_CLI_EVAL_SAMPLES), "--out", out,
                "--device", DEVICE]
    times = {}
    for name, cmd in (("train", train), ("evaluate", evaluate)):
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        times[name] = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[2:4])} failed: {run.stdout[-2000:]}"
                                 f"{run.stderr[-2000:]}")
        if name == "train" and f"trained {DATA_CLI_STEPS} steps on {DEVICE}" not in run.stdout:
            raise AssertionError(f"the training CLI: {run.stdout[-2000:]}")
    files = sorted(os.listdir(os.path.join(ckpt, PRESET)))
    want = {"config.json", "iter.txt", "latest_net_SR.pth", "latest_net_E.pth",
            "latest_net_D.pth", "latest_train_state.pth"}
    if not want <= set(files):
        raise AssertionError(f"the training CLI wrote {files}")
    with open(os.path.join(out, "metrics.csv")) as f:
        ids = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    if ids != [str(i) for i in range(DATA_CLI_EVAL_SAMPLES)]:
        raise AssertionError(f"the evaluation CSV's IDs: {ids}")
    log("data clis " + json.dumps({"train": " ".join(train[1:]), "files": files,
                                   "evaluate": " ".join(evaluate[1:]), "csv_ids": len(ids),
                                   "seconds": times, "card": smi}))


def data_phase(smi: str, resident: dict, synthetic_sweep: dict) -> None:
    """The data path on the card (the `data_*` functions): the codec's build,
    the corpus through every decode route against expected.npz, the loader
    alone per worker count, disk-fed training (faithful b4 and b16 of the
    main preset, beside `resident`, the training phase's resident-batch
    steps; a few guided b4 steps), the
    disk-fed evaluation sweep (beside `synthetic_sweep`), and the two CLIs
    from the tree."""
    t0 = time.perf_counter()
    route = decode_routes(smi)
    root = tempfile.mkdtemp(prefix="deepsee_data_")
    try:
        tree = data_tree(os.path.join(root, "tree"))
        loader_timing(tree, route, smi)
        steps = DATA_WARMUP + DATA_TIMED + DATA_PROFILED
        for batch_n in DATA_TRAIN_BATCHES:
            log(f"data train b{batch_n} " + json.dumps({
                **disk_fed_train(f"b{batch_n}_loader", PRESET, batch_n, tree, root, steps,
                                 resident[batch_n]),
                "route": route, "card": smi}))
        log(f"data train guided b{TRAIN_BATCH} " + json.dumps({
            **disk_fed_train("guided", DATA_GUIDED, TRAIN_BATCH, tree, root, DATA_GUIDED_STEPS),
            "route": route, "card": smi}))
        disk_fed_sweep(tree, synthetic_sweep, smi)
        data_clis(tree, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"data phase: {time.perf_counter() - t0:.1f} s")


# -- profile ---------------------------------------------------------------

KERNEL_CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("modnorm", ("modnorm",)),
    ("int8 conv (K4)", ("igemm_kernel", "absmax_partials", "absmax_merge", "quantize_weight",
                        "quantize_activation")),
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
    # the 15 longest kernels, and K4's beyond them (their launches per call)
    k4 = dict(KERNEL_CATEGORIES)["int8 conv (K4)"]
    for i, (name, ms, count) in enumerate(kernels):
        if i < 15 or any(k in name.lower() for k in k4):
            log(f"{tag} profile kernel {ms:9.3f} ms  x{count:<4d} {name[:110]}")


# -- data-parallel phase -------------------------------------------------------

DP_WORLD = 2
DP_PER_RANK = TRAIN_BATCH      # rows per rank: the global batch is DP_WORLD x 4 = 8
DP_STEPS = 3
DP_CLI_STEPS = 2               # 3 until PR 14
# the split kernels against their plain versions at the b16 step's batch
# shapes and at the dp step's (b8 cut into DP_WORLD shards of b4); timed at
# the dp step's per-rank shapes (b4)
DP_SPLIT_BATCH = TRAIN_BATCH_LARGE
# float32 (TF32 off), two ranks of 4 rows against one process of 8 rows from
# the same weights, batch and draws, after a warm-up step and DP_STEPS Adam
# steps.  Read per network on the update those steps made (the change of the
# weights and spectral u/v: relative L2 of ranks - one process over one
# process - start), and per leaf on the generator's running statistics
# (each leaf's relative L2 over its own change; the largest leaf), where a
# wrong cross-rank merge shows directly.  Each rank's convolutions run at
# batch 4 where the one process runs batch 8, so cuDNN may pick other
# algorithms and sum in another order; Adam's first steps move a weight by
# about lr whatever the size of its gradient, so float32 noise in a small
# gradient becomes a full step: the one process's own spread under weights
# nudged by one float32 ulp is printed beside.  A planted fault, run beside
# (two ranks whose ParamFreeNorm takes each rank's own rows' statistics,
# i.e. the one-process kernel without the sync path), must break a limit.
# Each limit near the geometric mean of the sound and the faulty reading of
# the first H100 run of this check (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
# update G 0.102 / 0.423, E 0.031 / 0.105, D 0.116 / 0.256 (one-ulp nudge
# of one process: 0.095, 0.029, 0.111); running statistics, largest leaf,
# mean 2.4e-3 / 1.3e-2, var 1.4e-3 / 2.8e-2 (nudge 1.6e-3, 1.3e-3).
MAX_DP_UPDATE_REL = {"g": 0.2, "e": 0.055, "d": 0.17}
MAX_DP_RUNNING_REL = 6e-3
RUNNING = ("running_mean", "running_var")
SPLIT_INFO = {
    "modnorm_batch_split": ("fwd", ("batch_partials", "batch_apply"),
                            "torch.batch_norm_stats + torch.batch_norm_elemt (without the "
                            "fused modulation and leaky ReLU; moves 2 of the 4 tensors)"),
    "modnorm_backward_batch_split": ("bwd", ("backward_sums", "backward_apply"),
                                     "torch.batch_norm_backward_reduce + "
                                     "torch.batch_norm_backward_elemt (without the modulation's "
                                     "and leaky ReLU's gradient; moves 3 of the 7 tensors)"),
}


def _split_forward(xs, ms, lrelu=True):
    """Launch A per shard, the shards' rows added (the all-reduce of one
    process), launch B per shard: (outputs, mean, rstd, partials)."""
    world = len(xs)
    partials = sum(mn.modnorm_batch_partials(x, r, world) for r, x in enumerate(xs))
    outs = [mn.modnorm_batch_apply(x, m, partials, lrelu=lrelu) for x, m in zip(xs, ms)]
    return [o for o, _, _ in outs], outs[0][1], outs[0][2], partials


def split_kernel_checks(cfg: ModelConfig):
    """The split batch modes at every K1 batch shape of the b16 step and of
    the dp step (DP_WORLD x DP_PER_RANK rows), bf16 and float32, one batch
    cut into DP_WORLD shards in one process (so the shards of the dp step's
    batch take the dp step's own launch plans): launch A per shard against
    its plain version, launch B per shard against its plain version and
    against the one-launch kernel over the whole batch, the backward's sums
    (added over the shards) and pass against theirs and against the
    one-process backward.  Returns the rows."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    rows = []
    for dtype, global_batch in itertools.product((torch.bfloat16, torch.float32),
                                                 (DP_SPLIT_BATCH, DP_WORLD * DP_PER_RANK)):
        for _, shape, with_mod, lrelu, _ in generator_norms(cfg, global_batch):
            x, mod, _, _ = _kernel_inputs(shape, with_mod, dtype, gen)
            gout = _kernel_inputs(shape, False, dtype, gen)[0]
            xs, ms, gs = x.chunk(DP_WORLD), mod.chunk(DP_WORLD), gout.chunk(DP_WORLD)
            outs, mean, rstd, partials = _split_forward(xs, ms, lrelu)
            whole, wmean, wrstd = mn.modnorm_train(x, mod, stats="batch", lrelu=lrelu)
            torch.cuda.synchronize()
            want_parts = torch.stack([mn.modnorm_batch_partials_plain(s) for s in xs])
            part_err = float(((partials - want_parts).abs()
                              / (want_parts.abs() + 1e-3)).max())
            fwd_err, max_out, ok = 0.0, 0.0, part_err <= 1e-4
            for out, s, m in zip(outs, xs, ms):
                want = mn.modnorm_batch_apply_plain(s, m, partials, lrelu=lrelu)[0]
                fwd_err = max(fwd_err, float((out.float() - want.float()).abs().max()))
                max_out = max(max_out, float(want.float().abs().max()))
                ok = ok and _train_within(out, want, dtype)
                del want
            one = torch.cat(outs)
            one_err = float((one.float() - whole.float()).abs().max())
            ok = ok and _train_within(one, whole, dtype)
            stat_err = max(float(((mean - wmean).abs() / (wmean.abs() + 1e-3)).max()),
                           float(((rstd - wrstd).abs() / wrstd).max()))
            ok = ok and stat_err <= 1e-4
            del outs, one, whole
            sums = sum(mn.modnorm_backward_sums(s, m, g, mean, rstd, lrelu=lrelu)
                       for s, m, g in zip(xs, ms, gs))
            torch.cuda.synchronize()
            want_sums = sum(mn.modnorm_backward_sums_plain(s, m, g, mean, rstd, lrelu=lrelu)
                            for s, m, g in zip(xs, ms, gs))
            # the card test's tolerance: 1e-5 relative, and 1e-5 of max|sums|
            scale = float(want_sums.abs().max())
            sums_err = float((sums - want_sums).abs().max()) / scale
            ok = ok and bool(((sums - want_sums).abs()
                              <= 1e-5 * want_sums.abs() + 1e-5 * scale).all())
            count = shape[0] * shape[2] * shape[3]
            bwd_err = 0.0
            for s, m, g in zip(xs, ms, gs):
                gx, gmod = mn.modnorm_backward_apply(s, m, g, mean, rstd, sums, count,
                                                     lrelu=lrelu)
                wgx, wgmod = mn.modnorm_backward_apply_plain(s, m, g, mean, rstd, sums, count,
                                                             lrelu=lrelu)
                bwd_err = max(bwd_err, float((gx.float() - wgx.float()).abs().max()),
                              float((gmod.float() - wgmod.float()).abs().max()))
                ok = ok and _train_within(gx, wgx, dtype) and _train_within(gmod, wgmod, dtype)
                del gx, gmod, wgx, wgmod
            gx = torch.cat([mn.modnorm_backward_apply(s, m, g, mean, rstd, sums, count,
                                                      lrelu=lrelu)[0]
                            for s, m, g in zip(xs, ms, gs)])
            wgx = mn.modnorm_backward(x, mod, gout, mean, rstd, stats="batch", lrelu=lrelu)[0]
            ok = ok and _train_within(gx, wgx, dtype)
            row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                   "shards": DP_WORLD, "ok": ok, "partials_rel_err": part_err,
                   "fwd_max_abs_err": fwd_err, "vs_one_launch_max_abs_err": one_err,
                   "stats_rel_err": stat_err, "bwd_sums_rel_err": sums_err,
                   "bwd_max_abs_err": bwd_err,
                   "bwd_vs_one_process_max_abs_err":
                       float((gx.float() - wgx.float()).abs().max()),
                   "max_abs_out": max_out}
            log("dp split kernel " + json.dumps(row))
            rows.append(row)
            del x, mod, gout, xs, ms, gs, gx, wgx, partials, sums, want_sums
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"a split kernel disagrees with its plain version: {bad}")
    return rows


def _library_split(backward: bool, x, gout, mean, rstd):
    """One PyTorch call pair for the same normalization across ranks, without
    the modulation and leaky ReLU (SyncBatchNorm's kernels)."""
    if not backward:
        def fwd():
            m, inv = torch.batch_norm_stats(x, 1e-5)
            return torch.batch_norm_elemt(x, None, None, m, inv, 1e-5)
        return fwd
    count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.int32, device=x.device)

    def bwd():
        sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
            gout, x, mean, rstd, None, True, False, False)
        return torch.batch_norm_backward_elemt(gout, x, mean, rstd, None, sum_dy, sum_dy_xmu,
                                               count)
    return bwd


def split_kernel_times(cfg: ModelConfig):
    """The split forward (A + B) and backward (sums + pass) at the dp step's
    per-rank batch shapes, bf16, device ms per call (`_device_ms`, over
    inputs larger than the L2) beside the one-launch kernels, their plain
    versions and SyncBatchNorm's library calls, the bound of each, and the
    host us per call; per dp step, each shape times its launches, summed."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    dtype = torch.bfloat16
    per_step = {k: {"ms": 0.0, "one_process_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    "bound_ms": 0.0, "host_us": 0.0} for k in ("fwd", "bwd")}
    for stats, shape, with_mod, lrelu, fwd_n, bwd_n in train_norms(cfg, DP_PER_RANK, True):
        if stats != "batch":
            continue
        set_bytes = math.prod(shape) * 2 * 5
        pool = []
        for _ in range(max(1, math.ceil(120e6 / set_bytes))):
            x, mod, _, _ = _kernel_inputs(shape, with_mod, dtype, gen)
            pool.append((x, mod, _kernel_inputs(shape, False, dtype, gen)[0]))
        _, mean, rstd = mn.modnorm_train_plain(pool[0][0], pool[0][1], stats="batch",
                                               lrelu=lrelu)
        count = shape[0] * shape[2] * shape[3]
        sums = mn.modnorm_backward_sums_plain(pool[0][0], pool[0][1], pool[0][2], mean, rstd,
                                              lrelu=lrelu)

        def split_fwd(x, m):
            return mn.modnorm_batch_apply(x, m, mn.modnorm_batch_partials(x), lrelu=lrelu)

        def plain_fwd(x, m):
            return mn.modnorm_batch_apply_plain(x, m, mn.modnorm_batch_partials_plain(x)[None],
                                                lrelu=lrelu)

        def split_bwd(x, m, g):
            s = mn.modnorm_backward_sums(x, m, g, mean, rstd, lrelu=lrelu)
            return mn.modnorm_backward_apply(x, m, g, mean, rstd, s, count, lrelu=lrelu)

        def plain_bwd(x, m, g):
            s = mn.modnorm_backward_sums_plain(x, m, g, mean, rstd, lrelu=lrelu)
            return mn.modnorm_backward_apply_plain(x, m, g, mean, rstd, s, count, lrelu=lrelu)

        row = {"shape": list(shape), "fwd_launches_per_step": fwd_n,
               "bwd_launches_per_step": bwd_n}
        row["fwd_ms"] = _device_ms([lambda x=x, m=m: split_fwd(x, m) for x, m, _ in pool])
        row["fwd_one_process_ms"] = _device_ms([
            lambda x=x, m=m: mn.modnorm_train(x, m, stats="batch", lrelu=lrelu)
            for x, m, _ in pool])
        row["fwd_plain_ms"] = _device_ms([lambda x=x, m=m: plain_fwd(x, m) for x, m, _ in pool])
        row["fwd_library_ms"] = _device_ms([_library_split(False, x, g, mean, rstd)
                                            for x, _, g in pool])
        row["bwd_ms"] = _device_ms([lambda x=x, m=m, g=g: split_bwd(x, m, g)
                                    for x, m, g in pool])
        row["bwd_one_process_ms"] = _device_ms([
            lambda x=x, m=m, g=g: mn.modnorm_backward(x, m, g, mean, rstd, stats="batch",
                                                      lrelu=lrelu) for x, m, g in pool])
        row["bwd_plain_ms"] = _device_ms([lambda x=x, m=m, g=g: plain_bwd(x, m, g)
                                          for x, m, g in pool])
        row["bwd_library_ms"] = _device_ms([_library_split(True, x, g, mean, rstd)
                                            for x, _, g in pool])
        x, m, g = pool[0]
        row["fwd_host_us"] = _host_us(lambda: split_fwd(x, m))
        row["bwd_host_us"] = _host_us(lambda: split_bwd(x, m, g))
        for key, backward, n in (("fwd", False, fwd_n), ("bwd", True, bwd_n)):
            bound, by = _train_bound_ms(backward, shape, with_mod, lrelu, 2)
            row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bound, by
            row[f"{key}_bound_share"] = bound / row[f"{key}_ms"]
            acc = per_step[key]
            acc["ms"] += row[f"{key}_ms"] * n
            acc["one_process_ms"] += row[f"{key}_one_process_ms"] * n
            acc["plain_ms"] += row[f"{key}_plain_ms"] * n
            acc["library_ms"] += row[f"{key}_library_ms"] * n
            acc["bound_ms"] += bound * n
            acc["host_us"] += row[f"{key}_host_us"] * n
        row["stats_only_blocks_per_sm"] = mn.batch_blocks_per_sm(dtype, False, False, True)
        log("dp split timing " + json.dumps(row))
        del pool, sums
        torch.cuda.empty_cache()
    for acc in per_step.values():
        acc["bound_share"] = acc["bound_ms"] / acc["ms"]
        acc["bound_by"] = "bytes"
    log("dp split kernels per step (b4 per rank, bf16, device ms) " + json.dumps(per_step))
    return per_step


def _net_state(system):
    return {name: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
            for name, net in (("g", system.generator), ("e", system.encoder),
                              ("d", system.discriminator))}


def _dp_steps(compute_dtype: str, rows_of_global: bool, nudge_ulps: int = 0):
    """A warm-up step and DP_STEPS faithful steps of PRESET at full width
    from the seeded weights (Adam; nudged by `nudge_ulps` float32 ulps where
    given), each rank on its rows of the global batch of DP_WORLD x
    DP_PER_RANK (or, in one process, all of them, with `rows_of_global`
    False), launch counts set to 0 after the warm-up and read after the
    steps; ms per step by CUDA events, the host ms spent in all-reduce
    calls, the networks' state before the warm-up and after the steps."""
    from deepsee_torch.parallel import distributed

    world, rank = distributed.world_size(), distributed.rank()
    system = train_system(PRESET, DP_WORLD * DP_PER_RANK,
                          model=dict(compute_dtype=compute_dtype))
    if nudge_ulps:
        _nudge(system, nudge_ulps, torch.Generator().manual_seed(SEED + 7))
    state = _state_of(system)
    before = _net_state(system) if compute_dtype == "float32" else None
    step = train_steps.make_train_step(system)
    batch = make_batch(system.cfg, DP_WORLD * DP_PER_RANK)
    if rows_of_global:
        n = DP_WORLD * DP_PER_RANK // world
        batch = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    step(state, batch)  # warm-up: cuDNN plans, the allocator, the gloo buffers
    spent = [0.0]
    all_reduce = torch.distributed.all_reduce

    def timed_all_reduce(*a, **k):
        t0 = time.perf_counter()
        try:
            return all_reduce(*a, **k)
        finally:
            spent[0] += time.perf_counter() - t0

    torch.distributed.all_reduce = timed_all_reduce
    try:
        torch.cuda.synchronize()
        mn.reset_launches()
        host0 = time.perf_counter()
        ms = _step_events_ms(step, state, batch, DP_STEPS)
        host_ms = (time.perf_counter() - host0) * 1e3 / DP_STEPS
        launches = dict(mn.launches)
    finally:
        torch.distributed.all_reduce = all_reduce
    return {"rank": rank, "world": world, "ms_per_step": ms, "host_ms_per_step": host_ms,
            "all_reduce_host_ms_per_step": spent[0] * 1e3 / DP_STEPS,
            "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "before": before, "state": _net_state(system),
            "card": torch.cuda.get_device_name(0)}


def _per_rank_statistics(x, mod=None, *, eps=1e-5, lrelu=False, group=None):
    """The planted fault: ParamFreeNorm's statistics from this rank's rows
    alone (the one-process kernel where the split one belongs)."""
    return mn.modnorm_train(x, mod, stats="batch", eps=eps, lrelu=lrelu)


def dp_rank(rank: int, port: int, out_dir: str) -> None:
    """One of DP_WORLD ranks on the one card: gloo (NCCL takes one card per
    rank), cuda:0, the float32 comparisons with TF32 off: the float32 steps,
    the planted per-rank statistics' (`_per_rank_statistics`), then the bf16
    steps, into out_dir/rank<R>.pt."""
    from deepsee_torch.models import normalization
    from deepsee_torch.parallel import distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.init_distributed("gloo", device="cuda")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random-VGG warning
            result = {"float32": _dp_steps("float32", rows_of_global=True)}
            sync = normalization.modnorm_train_sync
            normalization.modnorm_train_sync = _per_rank_statistics
            try:
                result["float32_fault"] = _dp_steps("float32", rows_of_global=True)
            finally:
                normalization.modnorm_train_sync = sync
            torch.cuda.empty_cache()
            result["bfloat16"] = _dp_steps("bfloat16", rows_of_global=True)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _checksum(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for net in sorted(state):
        for key in sorted(state[net]):
            h.update(key.encode())
            h.update(state[net][key].contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _dp_readings(got, want, before):
    """`got` against one process's `want`, both from `before`: per network
    the relative L2 of the update (every entry but the running statistics:
    ||got - want|| / ||want - before||), and per kind of running statistic
    the largest leaf's ||got - want|| / ||want - before|| with its name."""
    update, running = {}, {kind: {"rel": 0.0, "leaf": None} for kind in RUNNING}
    for net in want:
        keys = sorted(k for k in want[net] if not k.endswith(RUNNING))
        a = torch.cat([got[net][k].double().reshape(-1) for k in keys])
        b = torch.cat([want[net][k].double().reshape(-1) for k in keys])
        b0 = torch.cat([before[net][k].double().reshape(-1) for k in keys])
        update[net] = float((a - b).norm() / (b - b0).norm())
        for k in want[net]:
            if k.endswith(RUNNING):
                rel = float((got[net][k].double() - want[net][k].double()).norm()
                            / (want[net][k].double() - before[net][k].double()).norm())
                kind = running[k.rsplit(".", 1)[1]]
                if rel > kind["rel"]:
                    kind["rel"], kind["leaf"] = rel, f"{net}.{k}"
    return {"update_rel": update, "running_rel": running}


def _dp_broken(readings, update_rel=None, running_rel=MAX_DP_RUNNING_REL) -> list:
    """The limits (by default the dp phase's) that `readings` break."""
    update_rel = update_rel or MAX_DP_UPDATE_REL
    broken = [f"{net} update {rel:.3e} > {update_rel[net]}"
              for net, rel in readings["update_rel"].items() if rel > update_rel[net]]
    broken += [f"{kind} {r['rel']:.3e} at {r['leaf']} > {running_rel}"
               for kind, r in readings["running_rel"].items() if r["rel"] > running_rel]
    return broken


def spawned_ranks(rank_fn, world: int, root: str, in_between=lambda: None):
    """`world` ranks of rank_fn(rank, port, root) on the one card
    (torch.multiprocessing, spawn) while this process calls `in_between()`
    (this process's cached blocks freed first); (the ranks' results from
    root/rank<R>.pt, in_between's result)."""
    import torch.multiprocessing as tmp

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ranks = tmp.start_processes(rank_fn, args=(_free_port(), root), nprocs=world, join=False,
                                start_method="spawn")
    mine = in_between()
    while not ranks.join():
        pass
    results = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
               for r in range(world)]
    log(f"{rank_fn.__name__}: {world} ranks in {time.perf_counter() - t0:.1f} s")
    return results, mine


def dp_expected_launches(cfg: ModelConfig):
    """K1's launches per dp step: the batch modes split (A and B per forward,
    sums and pass per backward), none of the one-process batch kernels; the
    instance modes as in one process."""
    norms = train_norms(cfg, DP_PER_RANK, True)
    per = train_launches(norms)
    return {"batch_partials": per["batch"], "batch_apply": per["batch"],
            "backward_sums": per["backward_batch"], "backward_apply": per["backward_batch"],
            "batch": 0, "backward_batch": 0}


def dp_cli(smi: str) -> dict:
    """python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    deepsee_torch.train --multihost --data_axis 1 --synthetic: NCCL at world
    size 1 on the card."""
    root = tempfile.mkdtemp(prefix="deepsee_dp_cli_")
    try:
        cli = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "deepsee_torch.train", "--multihost",
               "--data_axis", "1", "--synthetic", "--max_steps", str(DP_CLI_STEPS),
               "--checkpoints_dir", root]
        t0 = time.perf_counter()
        run = subprocess.run(cli, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = [ln for ln in run.stdout.splitlines() if "multihost:" in ln or "trained" in ln]
        record = {"cli": " ".join(cli[1:]), "exit": run.returncode, "wall_s": wall,
                  "lines": lines, "card": smi}
        log("dp nccl cli " + json.dumps(record))
        if (run.returncode != 0 or "backend nccl, device cuda:0" not in run.stdout
                or f"trained {DP_CLI_STEPS} steps on cuda:0" not in run.stdout):
            raise AssertionError(f"the NCCL world-1 CLI failed: {run.stdout[-3000:]}"
                                 f"{run.stderr[-3000:]}")
        return record
    finally:
        shutil.rmtree(root, ignore_errors=True)


def dp_phase(smi: str):
    """(1) The split kernels at the b16 and dp steps' shapes against their
    plain versions and the one-launch kernels; timed at b4 per rank. (2)
    DP_WORLD ranks on the one card over gloo, PRESET at full width, global
    batch DP_WORLD x DP_PER_RANK: float32 (TF32 off) bit for bit alike
    across ranks and against one process at the global batch, beside a
    planted fault that must fail that comparison; bf16 timed, with
    K1's launches per step. (3) The training CLI under torchrun with NCCL
    at world size 1.  Returns the kernels line's split entries' numbers."""
    t0 = time.perf_counter()
    cfg = get_preset(PRESET).model
    rows = split_kernel_checks(cfg)
    times = split_kernel_times(cfg)
    log(f"dp split kernels: {time.perf_counter() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="deepsee_dp_")
    try:
        # one process's b8 steps after the ranks: beside two b4 ranks and this
        # process's earlier phases they overflow the card's memory
        results, _ = spawned_ranks(dp_rank, DP_WORLD, root)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            one = _dp_steps("float32", rows_of_global=False)
            nudged = _dp_steps("float32", rows_of_global=False, nudge_ulps=1)["state"]
        ranks = [r["float32"] for r in results]
        sums = [_checksum(r["state"]) for r in ranks]
        same = all(torch.equal(ranks[0]["state"][n][k], r["state"][n][k])
                   for r in ranks[1:] for n in ranks[0]["state"] for k in ranks[0]["state"][n])
        faulty = results[0]["float32_fault"]
        sound = _dp_readings(ranks[0]["state"], one["state"], one["before"])
        fault = _dp_readings(faulty["state"], one["state"], one["before"])
        record = {"preset": PRESET, "ranks": DP_WORLD, "rows_per_rank": DP_PER_RANK,
                  "steps": DP_STEPS, "checksums": sums, "bit_identical": same,
                  "vs_one_process": sound,
                  "one_process_nudged_1ulp": _dp_readings(nudged, one["state"], one["before"]),
                  "planted_fault_per_rank_statistics": fault,
                  "limits": {"update_rel": MAX_DP_UPDATE_REL, "running_rel": MAX_DP_RUNNING_REL},
                  "one_process_ms_per_step": one["ms_per_step"],
                  "rank_ms_per_step": [r["ms_per_step"] for r in ranks],
                  "peak_mem_gib": [r["peak_mem_gib"] for r in ranks] + [one["peak_mem_gib"]]}
        log("dp float32 " + json.dumps(record))
        del one, nudged, faulty
        torch.cuda.empty_cache()
        if not same or len(set(sums)) != 1:
            raise AssertionError(f"the ranks' states differ after {DP_STEPS} steps: {sums}")
        if _dp_broken(sound):
            raise AssertionError(f"two ranks differ from one process: {_dp_broken(sound)}")
        if not _dp_broken(fault):
            raise AssertionError("the planted per-rank statistics pass the limits: the check "
                                 f"cannot see a wrong merge ({fault})")
        bf16 = [r["bfloat16"] for r in results]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = dp_expected_launches(cfg)
    per_step = {k: bf16[0]["launches"][k] / DP_STEPS for k in want}
    timing = {"ranks": DP_WORLD, "rows_per_rank": DP_PER_RANK,
              "ms_per_step": [r["ms_per_step"] for r in bf16],
              "host_ms_per_step": [r["host_ms_per_step"] for r in bf16],
              "gloo_all_reduce_host_ms_per_step": [r["all_reduce_host_ms_per_step"]
                                                   for r in bf16],
              "k1_launches_per_step": per_step, "expected": want,
              "peak_mem_gib": [r["peak_mem_gib"] for r in bf16], "card": smi,
              "note": "gloo copies every collective through host memory: these times are no "
                      "yardstick for NCCL across cards"}
    log("dp bf16 " + json.dumps(timing))
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"dp K1 launches per step {per_step} != {want}")
    if any(r["launches"] != bf16[0]["launches"] for r in bf16):
        raise AssertionError("the ranks launched K1 differently")
    cli = dp_cli(smi)
    log(f"dp phase: {time.perf_counter() - t0:.1f} s")
    errs = {"fwd": max(max(r["fwd_max_abs_err"], r["vs_one_launch_max_abs_err"]) for r in rows),
            "bwd": max(max(r["bwd_max_abs_err"], r["bwd_vs_one_process_max_abs_err"])
                       for r in rows)}
    launches = {name: sum(bf16[0]["launches"][k] for k in keys) // DP_STEPS
                for name, (_, keys, _) in SPLIT_INFO.items()}
    return {"times": times, "errs": errs, "launches": launches, "cli": cli}


# -- tensor-parallel phase --------------------------------------------------------

TP_WORLD = 2                   # model_axis 2, data_axis 1: both ranks hold the global batch
TP_BATCH = 2
TP_F32_STEPS = 2
TP_BF16_STEPS = 2              # 3 until PR 14
# float32 (TF32 off): the two ranks' gathered state after TP_F32_STEPS faithful
# Adam steps from the seeded weights, against one process at b2 from the same
# weights, batch and draws, read as the dp phase reads its ranks
# (`_dp_readings`: per network the relative L2 of the update, per kind of
# running statistic the largest leaf).  A rank sums each conv's partial
# outputs in another order than one process's cuDNN conv, so Adam turns float32
# noise in small gradients into whole steps as in the dp phase; the one
# process's own spread under a one-ulp nudge is printed beside.  The planted
# fault (`_local_sigma`: each sharded conv's sigma from its own block of W
# alone) must break a limit.  Each limit near the geometric mean of the sound
# and the faulty reading of the first H100 run of this check (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md): update G 0.071 / 1.336, E 0.046 / 0.440, D 0.134 /
# 0.932 (one-ulp nudge of one process: 0.068, 0.046, 0.143); running
# statistics, largest leaf, 2.7e-4 / 0.82 (mean), 6.19 (var).
MAX_TP_UPDATE_REL = {"g": 0.3, "e": 0.14, "d": 0.35}
MAX_TP_RUNNING_REL = 0.015
# float32 (TF32 off), before any optimizer: the G, E and D gradients of one
# step of the two ranks (`_tp_grads`: SGD at lr 0, so the D step's
# regeneration sees the same G; the coins TP_COINS), gathered, against one
# process's, leaf by leaf (`_grad_readings`: per network the largest
# relative L2 of a leaf).  Here only summation order parts them, where the
# Adam update above turns it into whole steps; the one process's own spread
# under a one-ulp nudge is printed beside.  The second planted fault
# (`_alphas_unsummed`: SEAN's alphas without the copy that sums their
# gradient over the model group, so after the ranks' mean of the replicated
# gradients it is half of one process's) must break it; Adam's first step,
# which moves each parameter by about lr times the sign of its gradient,
# cannot see it.  First H100 run of this check (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md), sound / one-ulp nudge of one process / planted fault: G 0.0287
# (an alpha) / 0.0256 (an alpha) / 0.506 (an alpha), E 4.5e-3 / 5.2e-3 / -,
# D 6.2e-4 / 2.2e-3 / -: the ranks part from one process about as far as a
# one-ulp nudge moves it, most on SEAN's alphas, whose gradients are sums
# that mostly cancel.  G's limit near the
# geometric mean of its sound and faulty reading; E's and D's about four
# times the larger of their sound and nudged readings (the fault is in G).
MAX_TP_GRAD_REL = {"g": 0.12, "e": 0.02, "d": 0.01}
TP_COINS = (True, False)       # the full trunk, the style noise on
# the tp line's K1 rows: the training modes, per step and rank
TP_K1_MODES = ("batch", "instance_train", "backward_batch", "backward_instance")


def _alphas_unsummed():
    """The second planted fault: models/normalization.py's view of
    parallel/tensor.py with `copy` the identity.  Its one call of copy there
    is on SEAN's alphas, which each model rank uses on its channel blocks
    alone: their gradient is then this rank's part, not the group's sum."""
    import types

    from deepsee_torch.parallel import tensor as tp

    return types.SimpleNamespace(**dict(vars(tp), copy=lambda x: x))


@contextlib.contextmanager
def _planted(fault: Optional[str]):
    """The planted fault `fault` ("sigma": `_local_sigma`; "alpha":
    `_alphas_unsummed`; None: none) in place while the block runs."""
    from deepsee_torch.models import normalization

    saved = layers_mod._sigma, normalization.tp
    if fault == "sigma":
        layers_mod._sigma = _local_sigma
    elif fault == "alpha":
        normalization.tp = _alphas_unsummed()
    elif fault is not None:
        raise ValueError(f"no planted fault {fault!r}")
    try:
        yield
    finally:
        layers_mod._sigma, normalization.tp = saved


def _local_sigma(w_mat, u, v, mode):
    """The planted fault: sigma from this rank's block of W alone, without
    the sum over the model group."""
    from deepsee_torch.parallel import tensor as tp

    if mode == tp.COLUMN:
        return torch.dot(tp.local_slice(u, 0), w_mat @ v)
    if mode == tp.ROW:
        return torch.dot(u, w_mat @ tp.local_slice(v, 0))
    return torch.dot(u, w_mat @ v)


def _gathered_state(system):
    from deepsee_torch.parallel import shard

    return {name: {k: v.detach().cpu().clone() for k, v in shard.gather_state_dict(net).items()}
            for name, net in (("g", system.generator), ("e", system.encoder),
                              ("d", system.discriminator))}


def _state_bytes(state) -> dict:
    """This rank's bytes of G, E and D parameters and of both Adams' moments."""
    params = [p for net in (state.system.generator, state.system.encoder,
                            state.system.discriminator) for p in net.parameters()]
    moments = [v for opt in (state.opt_g, state.opt_d) for entry in opt.state.values()
               for k, v in entry.items() if k in ("exp_avg", "exp_avg_sq")]
    return {"params_mib": sum(p.numel() * p.element_size() for p in params) / 2 ** 20,
            "adam_moments_mib": sum(m.numel() * m.element_size() for m in moments) / 2 ** 20}


@contextlib.contextmanager
def _k1_widths(widths: dict, shapes: Optional[set] = None):
    """Count K1's training forward calls by (mode, channels) into `widths`;
    with `shapes`, add each one-launch call's (stats, shape, with_mod,
    lrelu) to it (its backward runs at the same)."""
    from deepsee_torch.models import normalization

    patched = [(normalization, "modnorm_train"), (layers_mod, "modnorm_train"),
               (normalization, "modnorm_train_sync")]
    saved = [getattr(mod, name) for mod, name in patched]

    def counting(fn, split):
        def call(x, mod=None, **kw):
            key = f"{'split' if split else kw.get('stats')}@{x.shape[1]}"
            widths[key] = widths.get(key, 0) + 1
            if shapes is not None and not split:
                shapes.add((kw["stats"], tuple(x.shape), mod is not None,
                            bool(kw.get("lrelu", False))))
            return fn(x, mod, **kw)
        return call

    for (mod, name), fn in zip(patched, saved):
        setattr(mod, name, counting(fn, name.endswith("sync")))
    try:
        yield
    finally:
        for (mod, name), fn in zip(patched, saved):
            setattr(mod, name, fn)


def _tp_steps(compute_dtype: str, steps: int, *, timed: bool = False,
              fault: Optional[str] = None, nudge_ulps: int = 0) -> dict:
    """PRESET at full width, b2, laid out over this process's world
    (model_axis = world) or in one process: `steps` faithful steps from the
    seeded weights (with `timed`, after a warm-up step, timed).
    The gathered state before and after (float32), and for `timed` runs ms
    per step by CUDA events, gloo's host ms, the collectives, K1's launches
    and widths, layout copies, peak memory and the state's bytes.  `fault`:
    the planted fault of that name (`_planted`)."""
    from deepsee_torch.parallel import distributed
    from deepsee_torch.parallel import tensor as tp

    world = distributed.world_size()
    mesh = MeshConfig(model_axis=world)
    system = train_system(PRESET, TP_BATCH, model=dict(compute_dtype=compute_dtype), mesh=mesh)
    if nudge_ulps:
        _nudge(system, nudge_ulps, torch.Generator().manual_seed(SEED + 7))
    state = _state_of(system)
    before = _gathered_state(system) if compute_dtype == "float32" else None
    step = train_steps.make_train_step(system)
    batch = make_batch(system.cfg, TP_BATCH)
    out = {"rank": distributed.rank(), "world": world, "card": torch.cuda.get_device_name(0)}
    with _planted(fault):
        if not timed:
            for _ in range(steps):
                step(state, batch)
            out["state"] = _gathered_state(system)
            out["before"] = before
            return out
        step(state, batch)  # warm-up: cuDNN plans, the allocator, the gloo buffers
        spent = [0.0]
        collectives = {name: getattr(torch.distributed, name)
                       for name in ("all_reduce", "all_gather")}

        def timing(fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[0] += time.perf_counter() - t0
            return call

        for name, fn in collectives.items():
            setattr(torch.distributed, name, timing(fn))
        widths: dict = {}
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mn.reset_launches()
            mn.layout_copies["backward"] = 0
            tp.reset_counts()
            with _k1_widths(widths):
                ms = _step_events_ms(step, state, batch, steps)
        finally:
            for name, fn in collectives.items():
                setattr(torch.distributed, name, fn)
        out.update({
            "ms_per_step": ms, "gloo_host_ms_per_step": spent[0] * 1e3 / steps,
            "collectives_per_step": {k: {"calls": v["calls"] / steps,
                                         "mib": v["bytes"] / steps / 2 ** 20}
                                     for k, v in tp.counts.items()},
            "k1_launches_per_step": {k: mn.launches[k] / steps for k in TP_K1_MODES},
            "k1_forward_widths_per_step": {k: v / steps for k, v in sorted(widths.items())},
            "layout_copies_per_step": {"channel_slices": tp.layout_copies["slice"] / steps,
                                       "k1_backward": mn.layout_copies["backward"] / steps},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "state": _state_bytes(state)})
        return out


def _tp_grads(fault: Optional[str] = None, nudge_ulps: int = 0) -> dict:
    """The G, E and D gradients (on the CPU) of one float32 step of PRESET
    at b2 from the seeded weights, laid out over this process's world
    (model_axis = world) or in one process: `_one_step` (SGD at lr 0,
    TP_COINS), the sharded ones gathered; with `fault` planted, or the
    weights nudged by `nudge_ulps`."""
    from deepsee_torch.parallel import distributed, shard

    mesh = MeshConfig(model_axis=distributed.world_size())
    system = train_system(PRESET, TP_BATCH, model=dict(compute_dtype="float32"), mesh=mesh)
    if nudge_ulps:
        _nudge(system, nudge_ulps, torch.Generator().manual_seed(SEED + 7))
    with _planted(fault):
        _, _, state = _one_step(system, make_batch(system.cfg, TP_BATCH), TP_COINS)
    return {net: {n: shard.gathered(p, opt.grads[p]).cpu() for n, p in module.named_parameters()}
            for net, module, opt in (("g", system.generator, state.opt_g),
                                     ("e", system.encoder, state.opt_g),
                                     ("d", system.discriminator, state.opt_d))}


def _grad_readings(got, want, part: str = "") -> dict:
    """Per network the leaf (of those whose name holds `part`) whose
    gradient in `got` lies farthest from `want`'s (relative L2, the
    resblocks' conv_0 biases left out: a batch norm follows them, so their
    true gradient is 0) and that reading."""
    out = {}
    for net in want:
        rel = {k: float((got[net][k].double() - want[net][k].double()).norm()
                        / want[net][k].double().norm().clamp_min(1e-30))
               for k in want[net] if part in k and not k.endswith("conv_0.bias")}
        if rel:
            leaf = max(rel, key=rel.get)
            out[net] = {"rel": rel[leaf], "leaf": leaf}
    return out


# int8 inference under tensor parallelism: PRESET at full width in eval mode,
# float32 (TF32 off), one main-path call at TP_INT8_BATCH on the model ranks
# against one process.  Every sharded conv's scales and k_q are held bit for
# bit, on its rank, against the plain quantization of the model group's
# gathered input and weight: that is the check that sees a wrong scale.  The
# fake is compared with one process's at the JAX package's mesh test's
# limits (tests/test_int8_inference.py:191-243), but the ranks' inputs part
# from one process's in the last bits (K1 on channel blocks sums in another
# order, the row convs add dequantized partials), and a one-ulp change moves
# int8 levels: on the H100 the sound run read 4.75e-3 mean / 0.039 max, one
# process under a one-ulp nudge of its weights 5.70e-3 / 0.036 (PERF.md).
# So the fake's limit is the larger of the JAX test's and TP_INT8_NOISE
# times the nudge's spread of this run; whether it is within the JAX test's
# is printed.
TP_INT8_BATCH = 2
TP_INT8_MIN_CH = 64            # int8_inference()'s default
MAX_TP_INT8_MEAN_ABS = 5e-3
MAX_TP_INT8_MAX_ABS = 0.08
TP_INT8_NOISE = 2.0
TP_INT8_KERNELS = {  # name in the kernels line -> (launch counter, the launch's role)
    "int8_quantize_weight_column_maxima": ("weight_column_maxima", "(b)'s first launch for a "
                                           "column block: this rank's column maxima"),
    "int8_quantize_weight_row_maxima": ("weight_row_maxima", "(b)'s first launch for a row "
                                        "block: s_c, this rank's row maxima and max|x'|"),
    "int8_quantize_weight_scales": ("weight_scales", "(b)'s second launch under a shard: s_c, "
                                    "s_k, s_x and k_q from the model group's maxima"),
}
# the one PyTorch call that computes the column maxima launch's function
TP_COLUMN_MAXIMA_LIBRARY = "torch.linalg.vector_norm(w, inf, dim=(0, 2, 3))"


def _whole_layer_bits(x, weight, role: str, smooth: bool, got: dict) -> dict:
    """Whether one rank's s_c, s_x, s_k and k_q (OIHW) of a sharded conv
    are, bit for bit, its block of the plain quantization of the whole
    layer: the model group's input and weight gathered (x's channel blocks
    for a row block)."""
    from deepsee_torch.parallel import distributed

    group, n, r = distributed.model_group(), distributed.model_world(), distributed.model_rank()

    def gathered(t, dim):
        parts = [torch.empty_like(t.contiguous()) for _ in range(n)]
        torch.distributed.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)

    if role == "column":
        q = ic.quantize_plain(x, gathered(weight, 0), smooth)
        cut = slice(r * weight.shape[0], (r + 1) * weight.shape[0])
        want = {"s_c": q.s_c, "s_x": q.s_x, "s_k": q.s_k[cut], "k_q": q.k_q[cut]}
    else:
        whole_x = gathered(x, 1).contiguous(memory_format=torch.channels_last)
        q = ic.quantize_plain(whole_x, gathered(weight, 1), smooth)
        cut = slice(r * weight.shape[1], (r + 1) * weight.shape[1])
        want = {"s_c": q.s_c[cut], "s_x": q.s_x, "s_k": q.s_k, "k_q": q.k_q[:, cut]}
    return {k: bool(torch.equal(got[k], v.cpu())) for k, v in want.items()}


@contextlib.contextmanager
def _int8_recorded(calls: list):
    """Every quantized conv's quantization while open, in call order, on the
    CPU: {"role": "column" / "row" for a tensor-parallel block, else None,
    "s_c", "s_x", "s_k", "k_q" (OIHW)}, from the wrappers of (c) and (d)
    (their plain versions where DEVICE is the CPU); a sharded conv's also
    "whole_layer" (`_whole_layer_bits`)."""
    cuda = DEVICE != "cpu"
    names = ("quantize_activation", "int8_conv_igemm") if cuda else (
        "quantize_activation_plain", "igemm_plain")
    saved = [ic.int8_conv_sharded] + [getattr(ic, n) for n in names]
    role = [None]  # a sharded call's role

    def sharded(x, weight, bias, stride, padding, smooth, shard_role, *args):
        role[0] = shard_role
        try:
            y = saved[0](x, weight, bias, stride, padding, smooth, shard_role, *args)
        finally:
            role[0] = None
        n = len(calls)
        bits = _whole_layer_bits(x, weight, shard_role, smooth, calls[-1])
        del calls[n:]  # the plain quantization's own, where DEVICE is the CPU
        calls[-1]["whole_layer"] = bits
        return y

    def activation(x, s_c, *args):
        out = saved[1](x, s_c, *args)
        s_x = args[0] if cuda else out[0]
        calls.append({"role": role[0], "s_c": s_c.cpu(), "s_x": s_x.cpu()})
        return out

    def igemm(x_q, k_q, s_x, s_k, *args):
        cin = calls[-1]["s_c"].numel()
        calls[-1].update(s_k=s_k.cpu(), k_q=(k_q[..., :cin].permute(0, 3, 1, 2) if cuda
                                             else k_q).cpu().contiguous())
        return saved[2](x_q, k_q, s_x, s_k, *args)

    ic.int8_conv_sharded = layers_mod.int8_conv_sharded = sharded
    setattr(ic, names[0], activation)
    setattr(ic, names[1], igemm)
    try:
        yield
    finally:
        ic.int8_conv_sharded = layers_mod.int8_conv_sharded = saved[0]
        for name, fn in zip(names, saved[1:]):
            setattr(ic, name, fn)


def _tp_int8(nudge_ulps: int = 0) -> dict:
    """One float32 int8 main-path call of PRESET at full width, seeded
    weights (nudged by `nudge_ulps`), laid out over this process's world
    (model_axis = world) or in one process: the fake (CPU), every quantized
    conv's quantization (`_int8_recorded`; a sharded conv's against the
    whole layer's), K4's launches and the MAX all-reduces."""
    from deepsee_torch.parallel import distributed, shard
    from deepsee_torch.parallel import tensor as tp

    world = distributed.world_size()
    exp = get_preset(PRESET).replace(is_train=False)
    exp = exp.replace(model=dataclasses.replace(exp.model, compute_dtype="float32"),
                      mesh=MeshConfig(model_axis=world))
    system = SRSystem(exp, device=DEVICE)
    system.init(torch.Generator().manual_seed(SEED))
    randomize_weights(system.networks().values(), torch.Generator().manual_seed(SEED + 1))
    if nudge_ulps:
        _nudge(system, nudge_ulps, torch.Generator().manual_seed(SEED + 7))
    if world > 1:
        distributed.set_model_axis(world)
        shard.shard_system(system, exp.mesh)
    batch = make_batch(system.cfg, TP_INT8_BATCH)
    calls: list = []
    ic.reset_launches()
    tp.reset_counts()
    with int8_inference(min_ch=TP_INT8_MIN_CH), _int8_recorded(calls):
        fake = run_path(system, batch)
    torch.cuda.synchronize()
    out = {"fake": fake.float().cpu(), "calls": calls, "launches": dict(ic.launches),
           "max_calls": tp.counts["max"]["calls"], "max_bytes": tp.counts["max"]["bytes"]}
    ic.reset_launches()
    del system
    torch.cuda.empty_cache()
    return out


def tp_int8_roles(cfg: ModelConfig, world: int) -> dict:
    """{"column": n, "row": n, None: n}: the convs of one main-path call that
    int8_inference(TP_INT8_MIN_CH) quantizes (the mini encoder's and every
    generator block's, the whole layer's cin and cout >= TP_INT8_MIN_CH),
    each in the role `shard.shard_plan` gives its weight at `world` model
    ranks and MIN_SHARD_CH."""
    from deepsee_torch.models.normalization import _Modulated
    from deepsee_torch.parallel import shard

    exp = get_preset(PRESET).replace(is_train=False)
    with torch.device("meta"):
        system = SRSystem(exp, device="meta")
    roles = {"column": 0, "row": 0, None: 0}
    for net in (system.encoder, system.generator):
        plan = shard.shard_plan(net, world, shard.MIN_SHARD_CH)
        for name, m in net.named_modules():
            if name.startswith("encoder_full"):
                continue  # the full trunk runs with use_full
            if isinstance(m, layers_mod.Conv2d):
                key = f"{name}.{'weight_orig' if m.spectral else 'weight'}"
            elif isinstance(m, _Modulated):  # its modulation conv, the shard of its gamma
                gamma = "mlp_gamma" if hasattr(m, "mlp_gamma") else "mlp_style_gamma"
                key = f"{name}.{gamma}.weight"
            else:
                continue
            weight = dict(net.named_parameters())[key]
            if min(weight.shape[:2]) >= TP_INT8_MIN_CH and weight.dim() == 4:
                roles[plan[key]] += 1
    return roles


def tp_int8_launches(roles: dict) -> dict:
    """K4's launches per call of one model rank: (a), (c), (d) per quantized
    conv, the one-launch (b) per replicated one, the two launches of the
    split (b) per column or row block (smoothing)."""
    n = sum(roles.values())
    return int8_launches(n) | {"quantize_weight": roles[None],
                               "weight_column_maxima": roles["column"],
                               "weight_row_maxima": roles["row"],
                               "weight_scales": roles["column"] + roles["row"]}


def tp_rank(rank: int, port: int, out_dir: str) -> None:
    """One of TP_WORLD model ranks on the one card over gloo (NCCL takes one
    card per rank), TF32 off: the float32 gradients, sound and with the
    planted alpha fault, the float32 steps, the planted sigma fault's, then
    the bf16 timed steps, into out_dir/rank<R>.pt, with the
    (stats, shape, with_mod, lrelu) of every K1 training call they made."""
    from deepsee_torch.parallel import distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(TP_WORLD), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.init_distributed("gloo", device="cuda")
    try:
        shapes: set = set()
        with warnings.catch_warnings(), _k1_widths({}, shapes):
            warnings.simplefilter("ignore")  # the random-VGG warning
            result = {"grads": _tp_grads(), "grads_fault": _tp_grads(fault="alpha")}
            result["float32"] = _tp_steps("float32", TP_F32_STEPS)
            result["float32_fault"] = _tp_steps("float32", TP_F32_STEPS, fault="sigma")
            torch.cuda.empty_cache()
            result["bfloat16"] = _tp_steps("bfloat16", TP_BF16_STEPS, timed=True)
        result["k1_shapes"] = sorted(shapes)
        result["int8"] = _tp_int8()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.reset_layout()
        torch.distributed.destroy_process_group()


def tp_int8_check(ranks, one: dict, nudged: dict, smi: str) -> dict:
    """The model ranks' int8 call (`_tp_int8`) against one process's: the
    fakes bit for bit alike, within the larger of MAX_TP_INT8_MEAN_ABS /
    _MAX_ABS and TP_INT8_NOISE times one process's own spread under a
    one-ulp nudge (`nudged`) of one process's; every sharded conv's s_c,
    s_x, s_k and k_q on every rank bit for bit its block of the whole
    layer's plain quantization (and how many of them, the ranks' blocks put
    together, equal one process's: printed); K4's launches per call and
    rank against `tp_int8_launches` of the plan's roles, one process's
    against `int8_per_call` (one launch of (b) per conv); a MAX all-reduce
    per sharded conv.  The "tp int8" line."""
    got = [r["int8"] for r in ranks]
    fakes = [g["fake"] for g in got]
    if any(not torch.equal(f, fakes[0]) for f in fakes):
        raise AssertionError("the model ranks' int8 fakes differ")
    if fakes[0].shape != one["fake"].shape or not bool(torch.isfinite(fakes[0]).all()):
        raise AssertionError(f"tp int8: shape {tuple(fakes[0].shape)} or values not finite")
    err = (fakes[0] - one["fake"]).abs()
    spread = (nudged["fake"] - one["fake"]).abs()
    limits = {"mean_abs": max(MAX_TP_INT8_MEAN_ABS, TP_INT8_NOISE * float(spread.mean())),
              "max_abs": max(MAX_TP_INT8_MAX_ABS, TP_INT8_NOISE * float(spread.max()))}
    roles = tp_int8_roles(get_preset(PRESET).model, TP_WORLD)
    want_launches = tp_int8_launches(roles)
    one_want = int8_per_call(int8_conv_shapes(get_preset(PRESET).model, TP_INT8_BATCH,
                                              full_trunk=False, min_ch=TP_INT8_MIN_CH))
    sharded = {"column": {"convs": 0, "whole_layer": 0, "one_process_equal": 0, "wrong": []},
               "row": {"convs": 0, "whole_layer": 0, "one_process_equal": 0, "wrong": []}}
    for i, call in enumerate(got[0]["calls"]):
        role = call["role"]
        if role is None:
            continue
        blocks = [g["calls"][i] for g in got]
        acc = sharded[role]
        acc["convs"] += 1
        whole = all(all(b["whole_layer"].values()) for b in blocks)
        acc["whole_layer"] += whole
        if not whole:
            acc["wrong"].append({"call": i, "ranks": [b["whole_layer"] for b in blocks]})
        if role == "column":
            pieces = {"s_c": blocks[0]["s_c"], "s_x": blocks[0]["s_x"],
                      "s_k": torch.cat([b["s_k"] for b in blocks]),
                      "k_q": torch.cat([b["k_q"] for b in blocks])}
        else:
            pieces = {"s_c": torch.cat([b["s_c"] for b in blocks]), "s_x": blocks[0]["s_x"],
                      "s_k": blocks[0]["s_k"], "k_q": torch.cat([b["k_q"] for b in blocks], 1)}
        acc["one_process_equal"] += all(torch.equal(v, one["calls"][i][k])
                                        for k, v in pieces.items())
    n_sharded = roles["column"] + roles["row"]
    record = {"preset": PRESET, "model_ranks": TP_WORLD, "batch": TP_INT8_BATCH,
              "dtype": "float32", "fake_mean_abs_err": float(err.mean()),
              "fake_max_abs_err": float(err.max()),
              "one_process_nudged_1ulp": {"mean_abs": float(spread.mean()),
                                          "max_abs": float(spread.max())},
              "limits": limits,
              "within_jax_mesh_test_limits": (float(err.mean()) < MAX_TP_INT8_MEAN_ABS
                                              and float(err.max()) < MAX_TP_INT8_MAX_ABS),
              "sharded_convs": sharded, "roles_per_call": {str(k): v for k, v in roles.items()},
              "launches_per_call_and_rank": got[0]["launches"],
              "expected_launches": want_launches,
              "one_process_launches": one["launches"], "one_process_expected": one_want,
              "max_collectives_per_call": got[0]["max_calls"],
              "max_kib_per_call": got[0]["max_bytes"] / 1024, "expected_max_collectives": n_sharded,
              "card": smi}
    log("tp int8 " + json.dumps(record))
    if float(err.mean()) >= limits["mean_abs"] or float(err.max()) >= limits["max_abs"]:
        raise AssertionError(f"tp int8: the fake parts from one process's: {record}")
    if any(acc["wrong"] for acc in sharded.values()) or \
            [sharded[r]["convs"] for r in ("column", "row")] != [roles["column"], roles["row"]]:
        raise AssertionError(f"tp int8: the sharded scales are not the whole layer's: {sharded}")
    if any(g["launches"] != want_launches for g in got) or one["launches"] != one_want:
        raise AssertionError(f"tp int8: launches {[g['launches'] for g in got]} / one process "
                             f"{one['launches']}, expected {want_launches} / {one_want}")
    if any(g["max_calls"] != n_sharded for g in got):
        raise AssertionError(f"tp int8: {got[0]['max_calls']} MAX all-reduces, expected "
                             f"{n_sharded}")
    return record


def _tp_weight_blocks(calls):
    """{(role, (cout, cin, kh, kw) of the rank's block): count per call} of
    the split (b) launches of one rank's recorded int8 call."""
    out: dict = {}
    for c in calls:
        if c["role"] is None:
            continue
        key = (c["role"], tuple(c["k_q"].shape))
        out[key] = out.get(key, 0) + 1
    return out


def _tp_weight_bounds(role: str, wshape):
    """(ms, bound_by) of each split (b) launch at a block of `wshape`: each
    input read once and each output written once over the HBM rate, or its
    float32 operations over the CUDA-core rate."""
    cout, cin, kh, kw = wshape
    nw, kq = cout * cin * kh * kw, cout * kh * kw * ic.padded_channels(cin)

    def bound(nbytes, ops):
        t = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / F32_FLOPS_PER_S}
        by = max(t, key=t.get)
        return t[by] * 1e3, by

    if role == "column":
        return {"weight_column_maxima": bound(4 * nw + 4 * cin, 2 * nw),
                "weight_scales": bound(4 * nw + 16 * cin + kq + 4 * (cout + 1), 6 * nw)}
    return {"weight_row_maxima": bound(4 * nw + 12 * cin + 4 * (cout + 1), 4 * nw),
            "weight_scales": bound(4 * nw + 4 * cin + 4 * (cout + 1) + kq + 4 * (cout + 1),
                                   5 * nw)}


def tp_int8_kernel_rows(ranks, smi: str) -> dict:
    """The split (b) at every block shape of the ranks' int8 call: both
    launches on two blocks of a seeded weight (the MAX all-reduce as the
    elementwise maximum of the two blocks' first launches) bit for bit
    their plain versions, then each launch's device ms at the block, its
    plain version's ms, its bound, and for the column maxima the library
    call's ms (TP_COLUMN_MAXIMA_LIBRARY; none for the others).  Per call and
    rank: the sums over the call's launches."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    dev = torch.device(DEVICE)
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "launches": 0,
                  "library_ms": 0.0 if k == "weight_column_maxima" else None,
                  "bound_by": set()} for k, _ in TP_INT8_KERNELS.values()}
    rows = []
    for (role, wshape), count in sorted(_tp_weight_blocks(ranks[0]["int8"]["calls"]).items()):
        cout, cin, kh, kw = wshape
        whole = (2 * cout, cin, kh, kw) if role == "column" else (cout, 2 * cin, kh, kw)
        weight = torch.randn(whole, generator=gen, device=dev) * 0.05
        xcin = whole[1]
        x = (torch.randn((TP_INT8_BATCH, xcin, 16, 16), generator=gen, device=dev)
             * torch.logspace(-1.5, 0.5, xcin, device=dev)[:, None, None])
        ws = [w.contiguous() for w in weight.chunk(2, 0 if role == "column" else 1)]
        xs = [x, x] if role == "column" else list(x.chunk(2, 1))
        maxima = [ic.absmax_channels_plain(t) for t in xs]
        if role == "column":
            first = [ic.weight_column_maxima(w) for w in ws]
            want_first = [ic.weight_column_maxima_plain(w) for w in ws]
            top = torch.maximum(*first)
            second = [ic.quantize_weight_columns(w, *m, top) for w, m in zip(ws, maxima)]
            want_second = [ic.quantize_weight_columns_plain(w, *m, top)
                           for w, m in zip(ws, maxima)]
            fns = {"weight_column_maxima": (
                       lambda: ic.weight_column_maxima(ws[0]),
                       lambda: ic.weight_column_maxima_plain(ws[0]),
                       lambda: torch.linalg.vector_norm(ws[0], float("inf"), dim=(0, 2, 3))),
                   "weight_scales": (lambda: ic.quantize_weight_columns(ws[0], *maxima[0], top),
                                     lambda: ic.quantize_weight_columns_plain(ws[0], *maxima[0],
                                                                              top), None)}
        else:
            first = [ic.weight_row_maxima(w, *m, True) for w, m in zip(ws, maxima)]
            want_first = [ic.weight_row_maxima_plain(w, *m, True) for w, m in zip(ws, maxima)]
            top = torch.maximum(first[0][1], first[1][1])
            second = [ic.quantize_weight_rows(w, f[0], top) for w, f in zip(ws, first)]
            want_second = [ic.quantize_weight_rows_plain(w, f[0], top)
                           for w, f in zip(ws, first)]
            s_c0 = first[0][0]
            fns = {"weight_row_maxima": (
                       lambda: ic.weight_row_maxima(ws[0], *maxima[0], True),
                       lambda: ic.weight_row_maxima_plain(ws[0], *maxima[0], True), None),
                   "weight_scales": (lambda: ic.quantize_weight_rows(ws[0], s_c0, top),
                                     lambda: ic.quantize_weight_rows_plain(ws[0], s_c0, top),
                                     None)}
        torch.cuda.synchronize()

        def same(got, want):
            if isinstance(got, torch.Tensor):
                if got.dim() == 4 and got.dtype == torch.int8:  # k_q: (Cout, kh, kw, Cp)
                    return bool(torch.equal(got[..., :want.shape[1]].permute(0, 3, 1, 2), want))
                return bool(torch.equal(got, want))
            return all(same(g, w) for g, w in zip(got, want))

        ok = all(same(g, w) for g, w in zip(first + second, want_first + want_second))
        bounds = _tp_weight_bounds(role, wshape)
        times = {}
        for key, (kernel, plain, library) in fns.items():
            times[key] = {"ms": _device_ms([kernel], target_ms=SP_TIMING_MS),
                          "plain_ms": _event_ms(plain, reps=3),
                          "bound_ms": bounds[key][0], "bound_by": bounds[key][1]}
            if library is not None:
                times[key]["library_ms"] = _device_ms([library], target_ms=SP_TIMING_MS)
            acc = totals[key]
            acc["launches"] += count
            acc["bound_by"].add(bounds[key][1])
            for k in ("ms", "plain_ms", "bound_ms") + (("library_ms",) if library else ()):
                acc[k] += times[key][k] * count
        row = {"role": role, "block": list(wshape), "per_call": count, "bit_for_bit": ok,
               "times": times, "card": smi}
        log("tp int8 kernel " + json.dumps(row))
        if not ok:
            raise AssertionError(f"the split (b) differs from its plain version: {row}")
        rows.append(row)
        del weight, x, ws, xs, first, second
    for acc in totals.values():
        acc["bound_by"] = "bytes" if acc["bound_by"] != {"operations"} else "operations"
    ic.reset_launches()
    torch.cuda.empty_cache()
    return {"totals": totals, "rows": len(rows)}


def tp_phase(smi: str) -> dict:
    """Tensor parallelism on the one card: TP_WORLD spawned model ranks over
    gloo, PRESET at full width (the 512-wide trunk, min_shard_ch 128, every
    trunk conv sharded), global b2 on both ranks.  Float32 (TF32 off): the
    ranks' gathered states bit for bit alike and within MAX_TP_UPDATE_REL /
    MAX_TP_RUNNING_REL of one process, which the planted sigma fault must
    break; before that, the first step's gradients bit for bit alike and
    within MAX_TP_GRAD_REL of one process's, leaf by leaf, which the planted
    alpha fault must break (the one process runs here while the ranks run).
    Then every K1 training call the ranks made, (stats, shape, with_mod,
    lrelu), held against its plain version (`train_kernel_phase`).  bf16:
    the "tp" line.  Returns the K1 launches per step and rank for the
    kernels line."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="deepsee_tp_")

    def one_process():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ({"sound": _tp_grads(), "nudged": _tp_grads(nudge_ulps=1)},
                    _tp_steps("float32", TP_F32_STEPS),
                    _tp_steps("float32", TP_F32_STEPS, nudge_ulps=1)["state"],
                    (_tp_int8(), _tp_int8(nudge_ulps=1)))

    try:
        ranks, (one_grads, one, nudged, one_int8) = spawned_ranks(tp_rank, TP_WORLD, root,
                                                                  one_process)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    grad_sums = [_checksum(r["grads"]) for r in ranks]
    want = one_grads["sound"]
    grads = {"preset": PRESET, "model_ranks": TP_WORLD, "batch": TP_BATCH, "coins": TP_COINS,
             "checksums": grad_sums, "vs_one_process": _grad_readings(ranks[0]["grads"], want),
             "alphas_vs_one_process": _grad_readings(ranks[0]["grads"], want, "alpha_"),
             "one_process_nudged_1ulp": _grad_readings(one_grads["nudged"], want),
             "alphas_one_process_nudged_1ulp": _grad_readings(one_grads["nudged"], want,
                                                              "alpha_"),
             "planted_fault_alphas_unsummed": _grad_readings(ranks[0]["grads_fault"], want),
             "limits": MAX_TP_GRAD_REL, "card": smi}
    log("tp float32 gradients " + json.dumps(grads))
    if len(set(grad_sums)) != 1:
        raise AssertionError(f"the ranks' gathered gradients differ: {grad_sums}")
    broken = [f"{net} {r['leaf']} {r['rel']:.3e} > {MAX_TP_GRAD_REL[net]}"
              for net, r in grads["vs_one_process"].items() if r["rel"] > MAX_TP_GRAD_REL[net]]
    if broken:
        raise AssertionError(f"two model ranks' gradients differ from one process's: {broken}")
    if all(r["rel"] <= MAX_TP_GRAD_REL[net]
           for net, r in grads["planted_fault_alphas_unsummed"].items()):
        raise AssertionError("the planted unsummed alphas pass the gradient limits: the check "
                             f"cannot see them ({grads['planted_fault_alphas_unsummed']})")
    del one_grads, want
    sums = [_checksum(r["float32"]["state"]) for r in ranks]
    sound = _dp_readings(ranks[0]["float32"]["state"], one["state"], one["before"])
    fault = _dp_readings(ranks[0]["float32_fault"]["state"], one["state"], one["before"])
    limits = {"update_rel": MAX_TP_UPDATE_REL, "running_rel": MAX_TP_RUNNING_REL}
    record = {"preset": PRESET, "model_ranks": TP_WORLD, "batch": TP_BATCH,
              "steps": TP_F32_STEPS, "checksums": sums, "vs_one_process": sound,
              "one_process_nudged_1ulp": _dp_readings(nudged, one["state"], one["before"]),
              "planted_fault_local_sigma": fault, "limits": limits, "card": smi}
    log("tp float32 " + json.dumps(record))
    if len(set(sums)) != 1:
        raise AssertionError(f"the ranks' gathered states differ after {TP_F32_STEPS} steps: "
                             f"{sums}")
    broken = _dp_broken(sound, **limits)
    if broken:
        raise AssertionError(f"two model ranks differ from one process: {broken}")
    if not _dp_broken(fault, **limits):
        raise AssertionError(f"the planted local sigma passes the limits: the check cannot see "
                             f"it ({fault})")
    del one, nudged
    torch.cuda.empty_cache()
    shapes = [tuple(s) for s in ranks[0]["k1_shapes"]]
    if not shapes or any(r["k1_shapes"] != ranks[0]["k1_shapes"] for r in ranks):
        raise AssertionError("the model ranks made no K1 training call, or other ones")
    checked = train_kernel_phase(shapes, timed=False)
    log("tp K1 shapes checked " + json.dumps(
        {"shapes": [list(s) for s in shapes], "rows": len(checked),
         "max_abs_err": max(r["max_abs_err"] for r in checked),
         "bwd_max_abs_err": max(r["bwd_max_abs_err"] for r in checked)}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one16 = _tp_steps("bfloat16", TP_BF16_STEPS, timed=True)
    bf16 = [r["bfloat16"] for r in ranks]
    want = one16["k1_launches_per_step"]  # the same seed, so the same coins
    timing = {"preset": PRESET, "model_ranks": TP_WORLD, "batch": TP_BATCH,
              "ms_per_step": [r["ms_per_step"] for r in bf16],
              "one_process_ms_per_step": one16["ms_per_step"],
              "gloo_host_ms_per_step": [r["gloo_host_ms_per_step"] for r in bf16],
              "collectives_per_step": bf16[0]["collectives_per_step"],
              "k1_launches_per_step": bf16[0]["k1_launches_per_step"],
              "one_process_k1_launches_per_step": want,
              "k1_forward_widths_per_step": bf16[0]["k1_forward_widths_per_step"],
              "one_process_k1_forward_widths_per_step": one16["k1_forward_widths_per_step"],
              "layout_copies_per_step": bf16[0]["layout_copies_per_step"],
              "peak_mem_gib": [r["peak_mem_gib"] for r in bf16],
              "one_process_peak_mem_gib": one16["peak_mem_gib"],
              "state_per_rank": bf16[0]["state"], "one_process_state": one16["state"],
              "card": smi,
              "note": "two ranks share the one H100 and gloo copies every collective through "
                      "host memory: no yardstick for NCCL across cards"}
    log("tp " + json.dumps(timing))
    if any(r["k1_launches_per_step"] != bf16[0]["k1_launches_per_step"] for r in bf16):
        raise AssertionError("the model ranks launched K1 differently")
    if bf16[0]["k1_launches_per_step"] != want or not all(want.values()):
        raise AssertionError(f"tp K1 launches per step {bf16[0]['k1_launches_per_step']} != "
                             f"one process's {want}")
    if any(int(key.split("@")[1]) * TP_WORLD not in
           {int(k.split("@")[1]) for k in one16["k1_forward_widths_per_step"]}
           for key in bf16[0]["k1_forward_widths_per_step"] if key.startswith("batch")):
        raise AssertionError("a batch-statistics K1 call of the ranks is not on a channel "
                             "block of the one process's")
    int8 = tp_int8_check(ranks, *one_int8, smi)
    int8_kernels = tp_int8_kernel_rows(ranks, smi)
    log(f"tp phase: {time.perf_counter() - t0:.1f} s")
    return {"k1": {k: int(v) for k, v in bf16[0]["k1_launches_per_step"].items()},
            "int8_launches": int8["launches_per_call_and_rank"], "int8": int8_kernels}


# -- spatial-sharding phase ---------------------------------------------------------

SP_WORLD = 2                   # model_axis 2, spatial: each rank a horizontal stripe of every map
SP_PRESET = PRESET_512         # where feature maps, not weights, fill the card
SP_F32_BATCH = 1
SP_BF16_BATCH = 2
SP_BF16_STEPS = 2
SP_INFER = {PRESET: 8, PRESET_512: 2}    # inference paths at these batches
SP_FAULTS = ("zero_halo", "stripe_stats")
SP_TIMING_MS = 10.0            # each timed CUDA graph of `sp_stage_times` lasts about this
# float32 (TF32 off): the two ranks' states after one faithful Adam step of
# SP_PRESET at b1 from the seeded weights, against one process from the same
# weights, batch and draws (`_dp_readings`: per network the relative L2 of the
# update, per kind of running statistic the largest leaf).  Each rank's convs
# read halo rows and sum in their own order, K1's statistics merge two
# stripes' partials, and Adam's first step moves a weight by about lr whatever
# the size of its gradient: the one process's own spread under a one-ulp
# nudge is printed beside.  The planted faults (`_sp_planted`: each rank
# padding its own stripe's edges with zeros; K1's statistics per stripe) must
# break a limit.  G's and E's limits, and the running statistics', near the
# geometric mean of the sound and the faultier reading of the first H100 run of
# this check (NVIDIA H100 80GB HBM3, 700 W; PERF.md): update G 0.046 / 0.835
# (zero halos) / 0.947 (per-stripe statistics), E 0.025 / 0.832 / 1.296, D
# 0.179 / 0.912 / 1.194 (one-ulp nudge of one process: 0.044, 0.025, 0.251);
# running statistics, largest leaf, 1.5e-4 / 0.034 / 0.120 (nudge 1.3e-4).
# D's sound reading lies within its nudge spread, which reaches 0.25: its limit
# twice that.
MAX_SP_UPDATE_REL = {"g": 0.2, "e": 0.15, "d": 0.5}
MAX_SP_RUNNING_REL = 2e-3
# inference, stripes against one process: float32 (TF32 off) relative L2 of
# the image, bf16 PSNR against one process's bf16 image
MAX_SP_INFER_F32_REL = 1e-4
MIN_SP_INFER_PSNR_DB = MIN_BF16_PSNR_DB
# the K1 kernels of the spatial step and their launch counters; the one
# library call computing the same function, where there is one
SP_STAGES = {
    "instance": (("partials", "instance_partials"), ("apply", "instance_apply"),
                 ("sums", "instance_backward_sums"), ("pass", "instance_backward_apply")),
    "batch": (("partials", "batch_partials"), ("apply", "batch_apply"),
              ("sums", "backward_sums"), ("pass", "backward_apply")),
}
SP_KERNELS = {
    "modnorm_instance_partials": ("instance", "partials",
                                  "torch.var_mean(x, dim=(2, 3), correction=0) (mean and "
                                  "variance, not the centred M2 rows)"),
    "modnorm_instance_apply": ("instance", "apply", None),
    "modnorm_instance_backward_sums": ("instance", "sums", None),
    "modnorm_instance_backward_apply": ("instance", "pass", None),
}
# the one-process launch counter each split counter stands for
SP_ONE_PROCESS = {"instance_partials": "instance_train", "instance_apply": "instance_train",
                  "instance_backward_sums": "backward_instance",
                  "instance_backward_apply": "backward_instance",
                  "batch_partials": "batch", "batch_apply": "batch",
                  "backward_sums": "backward_batch", "backward_apply": "backward_batch"}


@contextlib.contextmanager
def _sp_planted(fault: Optional[str]):
    """The planted fault `fault` ("zero_halo": the halo exchange returns
    zeros, so each rank pads its own stripe's edges; "stripe_stats": K1's
    all-reduces do nothing, so each stripe normalizes by its own statistics;
    None: none) in place while the block runs."""
    from deepsee_torch.parallel import distributed, spatial

    saved = spatial._all_gather, spatial._stats_reduce
    gather = spatial._all_gather
    if fault == "zero_halo":
        spatial._all_gather = lambda kind, t: (
            [torch.zeros_like(t)] * distributed.model_world() if kind.startswith("halo")
            else gather(kind, t))
    elif fault == "stripe_stats":
        spatial._stats_reduce = lambda kind, group: (lambda t: None)
    elif fault is not None:
        raise ValueError(f"no planted fault {fault!r}")
    try:
        yield
    finally:
        spatial._all_gather, spatial._stats_reduce = saved


@contextlib.contextmanager
def _sp_k1_calls(calls: list):
    """Record each of K1's calls across the stripes into `calls`: (kind,
    shape, with_mod, lrelu, count, backward), backward where the call
    records a graph."""
    from deepsee_torch.parallel import spatial

    inst, batch = spatial.instance_modnorm, spatial.batch_modnorm

    def record(kind, x, mod, lrelu, count):
        calls.append((kind, tuple(x.shape), mod is not None, bool(lrelu), count,
                      torch.is_grad_enabled() and x.requires_grad))

    def instance(x, mod=None, *, eps=1e-5, lrelu=False, rows=None):
        height = rows.height if rows is not None else spatial.global_height(x.shape[2])
        record("instance", x, mod, lrelu, height * x.shape[3])
        return inst(x, mod, eps=eps, lrelu=lrelu, rows=rows)

    def batch_norm(x, mod=None, *, eps=1e-5, lrelu=False):
        record("batch", x, mod, lrelu, SP_WORLD * x.shape[0] * x.shape[2] * x.shape[3])
        return batch(x, mod, eps=eps, lrelu=lrelu)

    spatial.instance_modnorm, spatial.batch_modnorm = instance, batch_norm
    try:
        yield
    finally:
        spatial.instance_modnorm, spatial.batch_modnorm = inst, batch


def _sp_steps(compute_dtype: str, batch_n: int, steps: int, *, timed: bool = False,
              fault: Optional[str] = None, nudge_ulps: int = 0) -> dict:
    """SP_PRESET at full width, laid out over this process's world
    (model_axis = world, spatial) or in one process: `steps` faithful Adam
    steps from the seeded weights on `batch_n` rows (with `timed`, after a
    warm-up step, timed, with K1's calls recorded).  The networks' state
    before and after (float32), and for `timed` runs ms per step by CUDA
    events, gloo's host ms, the collectives, K1's launches and calls, and
    peak memory.  `fault`: the planted fault of that name (`_sp_planted`)."""
    from deepsee_torch.parallel import distributed, spatial

    world = distributed.world_size()
    mesh = MeshConfig(model_axis=world, partition="spatial")
    system = train_system(SP_PRESET, batch_n, model=dict(compute_dtype=compute_dtype), mesh=mesh)
    if nudge_ulps:
        _nudge(system, nudge_ulps, torch.Generator().manual_seed(SEED + 7))
    state = _state_of(system)
    before = _net_state(system) if compute_dtype == "float32" else None
    step = train_steps.make_train_step(system)
    batch = make_batch(system.cfg, batch_n, guided=True)
    out = {"rank": distributed.rank(), "world": world, "card": torch.cuda.get_device_name(0)}
    with _sp_planted(fault):
        if not timed:
            for _ in range(steps):
                step(state, batch)
            out.update(state=_net_state(system), before=before)
            return out
        step(state, batch)  # warm-up: cuDNN plans, the allocator, the gloo buffers
        spent = [0.0]
        collectives = {name: getattr(torch.distributed, name)
                       for name in ("all_reduce", "all_gather")}

        def timing(fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[0] += time.perf_counter() - t0
            return call

        for name, fn in collectives.items():
            setattr(torch.distributed, name, timing(fn))
        calls: list = []
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mn.reset_launches()
            spatial.reset_counts()
            with _sp_k1_calls(calls):
                ms = _step_events_ms(step, state, batch, steps)
            launches = dict(mn.launches)
        finally:
            for name, fn in collectives.items():
                setattr(torch.distributed, name, fn)
        out.update({
            "ms_per_step": ms, "gloo_host_ms_per_step": spent[0] * 1e3 / steps,
            "collectives_per_step": {k: {"calls": v["calls"] / steps,
                                         "mib": v["bytes"] / steps / 2 ** 20}
                                     for k, v in spatial.counts.items()},
            "k1_launches_per_step": {k: v / steps for k, v in launches.items() if v},
            "k1_calls": calls[:len(calls) // steps],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        return out


def _sp_infer() -> dict:
    """Each SP_INFER preset's inference path (preprocess -> mini or full
    trunk encode -> generate, no noise) on its seeded rows, in float32 and
    bf16, on this rank's stripes where the world is laid out spatially:
    (preset, dtype) -> the whole fake, on the CPU."""
    from deepsee_torch.parallel import distributed, spatial

    spatial.use_mesh(MeshConfig(model_axis=distributed.world_size(), partition="spatial"))
    out = {}
    for preset, batch_n in SP_INFER.items():
        seeded = seeded_system(preset)
        for dtype in ("float32", "bfloat16"):
            system = _like(seeded, dtype, DEVICE)
            guided = system.cfg.guiding_style_image
            batch = spatial.shard_rows(make_batch(system.cfg, batch_n, guided=guided))
            fake = run_path(system, batch, use_full=guided)
            out[(preset, dtype)] = spatial.gather_rows(fake, dim=1).float().cpu()
            del system
        del seeded
        torch.cuda.empty_cache()
    return out


def sp_rank(rank: int, port: int, out_dir: str) -> None:
    """One of SP_WORLD model ranks on the one card over gloo, TF32 off: the
    float32 step, each planted fault's, the inference paths in float32 and
    bf16, bf16 and int8 (`_sp_int8`), the "nospade" generator, then (once
    the parent's runs are done: out_dir/go) the bf16 timed steps, into
    out_dir/rank<R>.pt."""
    from deepsee_torch.parallel import distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SP_WORLD), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.init_distributed("gloo", device="cuda")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random-VGG warning
            result = {"float32": _sp_steps("float32", SP_F32_BATCH, 1)}
            for fault in SP_FAULTS:
                result[fault] = _sp_steps("float32", SP_F32_BATCH, 1, fault=fault)
            result["infer"] = _sp_infer()
            result["int8"] = _sp_int8()
            result["nospade"] = _sp_nospade()
            torch.cuda.empty_cache()
            while not os.path.exists(os.path.join(out_dir, "go")):
                time.sleep(0.2)
            result["bfloat16"] = _sp_steps("bfloat16", SP_BF16_BATCH, SP_BF16_STEPS,
                                           timed=True)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.reset_layout()
        torch.distributed.destroy_process_group()


def _sp_inputs(shape, with_mod: bool, dtype, gen):
    x, mod, _, _ = _kernel_inputs(shape, with_mod, dtype, gen)
    return x, mod, _kernel_inputs(shape, False, dtype, gen)[0]


def _sp_plain(kind: str):
    """The split's plain functions of `kind` ("instance" or "batch")."""
    if kind == "instance":
        return (mn.modnorm_instance_partials_plain, mn.modnorm_instance_apply_plain,
                mn.modnorm_instance_backward_sums_plain, mn.modnorm_instance_backward_apply_plain)
    return (mn.modnorm_batch_partials_plain, mn.modnorm_batch_apply_plain,
            mn.modnorm_backward_sums_plain, mn.modnorm_backward_apply_plain)


def _sp_kernels(kind: str):
    if kind == "instance":
        return (mn.modnorm_instance_partials, mn.modnorm_instance_apply,
                mn.modnorm_instance_backward_sums, mn.modnorm_instance_backward_apply)
    return (mn.modnorm_batch_partials, mn.modnorm_batch_apply, mn.modnorm_backward_sums,
            mn.modnorm_backward_apply)


def sp_kernel_check(kind: str, shapes, with_mod: bool, lrelu: bool, count: int, dtype,
                    gen) -> dict:
    """One call of K1's split `kind` at the ranks' stripe `shapes` (one per
    rank), in one process: each launch against its plain version on the
    same inputs, the rows' sum standing for the all-reduce."""
    part_k, apply_k, sums_k, pass_k = _sp_kernels(kind)
    part_p, apply_p, sums_p, pass_p = _sp_plain(kind)
    ins = [_sp_inputs(s, with_mod, dtype, gen) for s in shapes]
    world = len(shapes)
    partials = sum(part_k(x, r, world) for r, (x, _, _) in enumerate(ins))
    torch.cuda.synchronize()
    want_parts = torch.stack([part_p(x) for x, _, _ in ins])
    part_err = float(((partials - want_parts).abs() / (want_parts.abs() + 1e-3)).max())
    ok = part_err <= 1e-4
    fwd_err = bwd_err = 0.0
    mean = rstd = None
    for x, m, _ in ins:
        out, mean, rstd = apply_k(x, m, partials, lrelu=lrelu)
        want = apply_p(x, m, partials, lrelu=lrelu)[0]
        fwd_err = max(fwd_err, float((out.float() - want.float()).abs().max()))
        ok = ok and _train_within(out, want, dtype)
    sums = sum(sums_k(x, m, g, mean, rstd, lrelu=lrelu) for x, m, g in ins)
    torch.cuda.synchronize()
    want_sums = sum(sums_p(x, m, g, mean, rstd, lrelu=lrelu) for x, m, g in ins)
    scale = float(want_sums.abs().max())
    ok = ok and bool(((sums - want_sums).abs() <= 1e-5 * want_sums.abs() + 1e-5 * scale).all())
    for x, m, g in ins:
        gx, gmod = pass_k(x, m, g, mean, rstd, sums, count, lrelu=lrelu)
        wgx, wgmod = pass_p(x, m, g, mean, rstd, sums, count, lrelu=lrelu)
        bwd_err = max(bwd_err, float((gx.float() - wgx.float()).abs().max()))
        ok = ok and _train_within(gx, wgx, dtype)
        if with_mod:
            bwd_err = max(bwd_err, float((gmod.float() - wgmod.float()).abs().max()))
            ok = ok and _train_within(gmod, wgmod, dtype)
    return {"kind": kind, "shapes": [list(s) for s in shapes], "mod": with_mod, "lrelu": lrelu,
            "dtype": str(dtype).replace("torch.", ""), "ok": ok, "partials_rel_err": part_err,
            "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err,
            "sums_rel_err": float((sums - want_sums).abs().max()) / max(scale, 1e-30)}


def _sp_stage_bound_ms(kind: str, stage: str, shape, with_mod: bool, lrelu: bool,
                       elt_bytes: int):
    """Least time of one stage: each input read once, each output written
    once (x, mod, gout, grad_x, grad_mod; the statistics' rows, a few KB, and
    the float32 operations per element over the CUDA-core rate; the larger."""
    b, c, h, w = shape
    n = b * c * h * w
    mod = 2 if with_mod else 0
    tensors, per_elt = {"partials": (1, 3), "apply": (2 + mod, 4 + mod + lrelu),
                        "sums": (2 + mod, 7 + mod + lrelu),
                        "pass": (3 + 2 * mod, 8 + mod + lrelu)}[stage]
    sets = b * c if kind == "instance" else c
    t_bytes = (n * tensors * elt_bytes + 4 * 4 * sets) / HBM_BYTES_PER_S
    t_ops = n * per_elt / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _sp_library(kind: str, stage: str, x, g, mean, rstd):
    """One PyTorch call computing the stage's function, or None: the
    instance partials' per-(sample, channel) moments (torch.var_mean), the
    batch split's SyncBatchNorm kernels."""
    if kind == "instance":
        return (lambda: torch.var_mean(x, dim=(2, 3), correction=0)) if stage == "partials" \
            else None
    if stage == "partials":
        return lambda: torch.batch_norm_stats(x, 1e-5)
    if stage == "apply":
        m, inv = torch.batch_norm_stats(x, 1e-5)
        return lambda: torch.batch_norm_elemt(x, None, None, m, inv, 1e-5)
    if stage == "sums":
        return lambda: torch.batch_norm_backward_reduce(g, x, mean, rstd, None, True, False,
                                                        False)
    sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(g, x, mean, rstd, None, True,
                                                                False, False)
    count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.int32, device=x.device)
    return lambda: torch.batch_norm_backward_elemt(g, x, mean, rstd, None, sum_dy, sum_dy_xmu,
                                                   count)


def sp_stage_times(kind: str, shape, with_mod: bool, lrelu: bool, count: int, gen) -> dict:
    """bf16 device ms per call of each stage at one rank's `shape` (over a
    pool of inputs larger than the L2), beside its plain version, its bound
    and the library call where there is one."""
    dtype = torch.bfloat16
    part_k, apply_k, sums_k, pass_k = _sp_kernels(kind)
    part_p, apply_p, sums_p, pass_p = _sp_plain(kind)
    set_bytes = math.prod(shape) * 2 * (5 if with_mod else 3)
    pool = [_sp_inputs(shape, with_mod, dtype, gen)
            for _ in range(max(1, math.ceil(120e6 / set_bytes)))]
    x0, m0, g0 = pool[0]
    part = part_k(x0, 0, 1)
    _, mean, rstd = apply_k(x0, m0, part, lrelu=lrelu)
    sums = sums_k(x0, m0, g0, mean, rstd, lrelu=lrelu)
    fns = {
        "partials": (lambda x, m, g: part_k(x, 0, 1), lambda x, m, g: part_p(x)),
        "apply": (lambda x, m, g: apply_k(x, m, part, lrelu=lrelu),
                  lambda x, m, g: apply_p(x, m, part, lrelu=lrelu)),
        "sums": (lambda x, m, g: sums_k(x, m, g, mean, rstd, lrelu=lrelu),
                 lambda x, m, g: sums_p(x, m, g, mean, rstd, lrelu=lrelu)),
        "pass": (lambda x, m, g: pass_k(x, m, g, mean, rstd, sums, count, lrelu=lrelu),
                 lambda x, m, g: pass_p(x, m, g, mean, rstd, sums, count, lrelu=lrelu)),
    }
    out = {}
    for stage, (kernel, plain) in fns.items():
        bound, by = _sp_stage_bound_ms(kind, stage, shape, with_mod, lrelu, 2)
        lib = [_sp_library(kind, stage, x, g, mean, rstd) for x, _, g in pool]
        out[stage] = {
            "ms": _device_ms([functools.partial(kernel, x, m, g) for x, m, g in pool],
                             target_ms=SP_TIMING_MS),
            "plain_ms": _device_ms([functools.partial(plain, x, m, g) for x, m, g in pool],
                                   target_ms=SP_TIMING_MS),
            "bound_ms": bound, "bound_by": by,
            "library_ms": (_device_ms(lib, target_ms=SP_TIMING_MS) if lib[0] is not None
                           else None)}
    del pool
    torch.cuda.empty_cache()
    return out


def sp_kernel_phase(ranks) -> dict:
    """Every K1 call across the stripes that the ranks' timed bf16 steps
    made, (kind, the two ranks' stripe shapes, mod, lrelu, count), held
    against the plain versions in bf16 and float32, and timed in bf16 at
    rank 0's shape; per spatial step of rank 0, each stage's device ms,
    plain ms, bound and library ms summed over its launches.  Returns the
    per-kind, per-stage totals and the largest error."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    calls = list(zip(*[r["bfloat16"]["k1_calls"] for r in ranks]))
    if not calls or any(len({(c[0], c[2], c[3], c[4], c[5]) for c in call}) != 1
                        for call in calls):
        raise AssertionError("the ranks made no K1 call across their stripes, or other ones")
    distinct = {}
    for call in calls:
        kind, _, with_mod, lrelu, count, backward = call[0]
        key = (kind, tuple(c[1] for c in call), with_mod, lrelu, count)
        fwd_n, bwd_n = distinct.get(key, (0, 0))
        distinct[key] = (fwd_n + 1, bwd_n + int(backward))
    totals = {kind: {stage: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                             "launches": 0, "library": True, "bound_by": set()}
                     for stage, _ in SP_STAGES[kind]} for kind in SP_STAGES}
    errs = {kind: 0.0 for kind in SP_STAGES}
    rows = []
    for (kind, shapes, with_mod, lrelu, count), (fwd_n, bwd_n) in distinct.items():
        checks = [sp_kernel_check(kind, shapes, with_mod, lrelu, count, dtype, gen)
                  for dtype in (torch.bfloat16, torch.float32)]
        bad = [c for c in checks if not c["ok"]]
        if bad:
            raise AssertionError(f"a K1 split kernel disagrees with its plain version: {bad}")
        errs[kind] = max([errs[kind]] + [max(c["fwd_max_abs_err"], c["bwd_max_abs_err"])
                                         for c in checks])
        times = sp_stage_times(kind, shapes[0], with_mod, lrelu, count, gen)
        row = {"kind": kind, "shapes": [list(s) for s in shapes], "mod": with_mod,
               "lrelu": lrelu, "fwd_per_step": fwd_n, "bwd_per_step": bwd_n,
               "checks": checks, "times": times}
        log("sp K1 kernel " + json.dumps(row))
        rows.append(row)
        for stage, _ in SP_STAGES[kind]:
            n = fwd_n if stage in ("partials", "apply") else bwd_n
            acc, t = totals[kind][stage], times[stage]
            acc["launches"] += n
            for key in ("ms", "plain_ms", "bound_ms"):
                acc[key] += t[key] * n
            if t["library_ms"] is None:
                acc["library"] = False
            else:
                acc["library_ms"] += t["library_ms"] * n
            acc["bound_by"].add(t["bound_by"])
    for kind in totals:
        for acc in totals[kind].values():
            acc["bound_by"] = "bytes" if acc["bound_by"] != {"operations"} else "operations"
            if not acc.pop("library"):
                acc["library_ms"] = None
    log("sp K1 kernels per spatial step of one rank (bf16, device ms) " + json.dumps(totals))
    return {"totals": totals, "errs": errs, "rows": len(rows)}


# -- int8 inference and the "nospade" generator on stripes (sp_phase) ---------------

SP_INT8_DTYPES = ("float32", "bfloat16")
# the striped int8 fake against one process's: the JAX package's mesh test's
# tolerances (tests/test_int8_inference.py:191-243), or SP_INT8_NOISE times one
# process's own spread under a one-ulp nudge of the float32 weights where that
# is larger (the rule of the "tp int8" line).  The bf16 path takes its
# preset's float32 spread: a level that moves across a rounding edge of the
# per-tensor s_x moves the output by the same amount in either dtype, and
# bf16's own rounding steps are coarser, so the float32 spread is the smaller
# one.  On the seeded weights of the first card run (NVIDIA H100 80GB HBM3,
# 700 W) the stripes read 5.5e-3 / 6.4e-3 mean off one process (float32 /
# bf16) where one process's one-ulp spread reads 6.0e-3.
MAX_SP_INT8_MEAN_ABS = 5e-3
MAX_SP_INT8_MAX_ABS = 0.08
SP_INT8_NOISE = 2.0
# the path whose stripe shapes K4 is checked and timed at, in bf16
SP_INT8_TIMED = PRESET
SP_NOSPADE_BATCH = 8


@contextlib.contextmanager
def _sp_int8_recorded(calls: list):
    """Every quantized conv of the path while open, in call order, from the
    wrappers of (b), (c) and (d): the shapes of its input stripe ("x"), of
    (d)'s x_q slab ("slab", Cp channels), of the weight, the stride and
    (d)'s (pad_h, pad_w); the halo collectives between (c) and (d) (the
    int8 halo: calls, bytes); and, where maps are striped, whether its s_c,
    s_k, s_x and k_q are bit for bit the plain quantization of the conv's
    input gathered whole over the model group ("scales")."""
    from deepsee_torch.parallel import spatial

    saved = ic.quantize_weight, ic.quantize_activation, ic.int8_conv_igemm

    def weight(w, mx_raw, mx, smooth):
        out = saved[0](w, mx_raw, mx, smooth)
        calls.append({"w": list(w.shape), "smooth": smooth, "_weight": w, "_got": out})
        return out

    def activation(x, s_c, s_x):
        call = calls[-1]
        w, got = call.pop("_weight"), call.pop("_got")
        call["x"] = list(x.shape)
        if spatial.active():
            q = ic.quantize_plain(spatial.gather_rows(x), w, call["smooth"])
            k_q = got[3]
            if k_q.device.type == "cuda":   # (Cout, kh, kw, Cp) -> OIHW
                k_q = k_q[..., :x.shape[1]].permute(0, 3, 1, 2)
            call["scales"] = {k: bool(torch.equal(a, b)) for k, a, b in
                              (("s_c", got[0], q.s_c), ("s_k", got[1], q.s_k),
                               ("s_x", got[2], q.s_x), ("k_q", k_q, q.k_q))}
            del q
        call["_halo"] = (spatial.counts["halo"]["calls"], spatial.counts["halo"]["bytes"])
        return saved[1](x, s_c, s_x)

    def igemm(x_q, k_q, s_x, s_k, bias, stride, padding, out_dtype):
        call = calls[-1]
        c0, b0 = call.pop("_halo")
        call.update(slab=list(x_q.shape), stride=stride, pad=list(ic.pads(padding)),
                    halo_calls=spatial.counts["halo"]["calls"] - c0,
                    halo_bytes=spatial.counts["halo"]["bytes"] - b0)
        return saved[2](x_q, k_q, s_x, s_k, bias, stride, padding, out_dtype)

    ic.quantize_weight, ic.quantize_activation, ic.int8_conv_igemm = weight, activation, igemm
    try:
        yield
    finally:
        ic.quantize_weight, ic.quantize_activation, ic.int8_conv_igemm = saved


def _sp_int8(nudge_ulps: int = 0) -> dict:
    """Each SP_INFER preset's inference path under int8_inference() (min_ch
    64, SmoothQuant) with the striped bf16 inference's seeded weights
    (nudged by `nudge_ulps` float32 ulps: float32 alone then), in float32
    and bf16, on this rank's stripes where the world is laid out spatially:
    (preset, dtype) -> the whole fake (CPU), K4's launches, the call's MAX
    all-reduces and halos (calls, bytes) and its quantized convs
    (`_sp_int8_recorded`)."""
    from deepsee_torch.parallel import distributed, spatial

    spatial.use_mesh(MeshConfig(model_axis=distributed.world_size(), partition="spatial"))
    out = {}
    for preset, batch_n in SP_INFER.items():
        seeded = seeded_system(preset)
        if nudge_ulps:
            _nudge(seeded, nudge_ulps, torch.Generator().manual_seed(SEED + 7))
        for dtype in ("float32",) if nudge_ulps else SP_INT8_DTYPES:
            system = _like(seeded, dtype, DEVICE)
            guided = system.cfg.guiding_style_image
            batch = spatial.shard_rows(make_batch(system.cfg, batch_n, guided=guided))
            calls: list = []
            ic.reset_launches()
            spatial.reset_counts()
            with int8_inference(), _sp_int8_recorded(calls):
                fake = run_path(system, batch, use_full=guided)
            torch.cuda.synchronize()
            out[(preset, dtype)] = {
                "fake": spatial.gather_rows(fake, dim=1).float().cpu(),
                "launches": dict(ic.launches), "calls": calls,
                "collectives": {k: dict(spatial.counts[k]) for k in ("max", "halo")}}
            ic.reset_launches()
            del system, fake
        del seeded
        torch.cuda.empty_cache()
    return out


def _sp_nospade() -> dict:
    """PRESET's "nospade" generator (Pix2PixResnetBlock blocks: reflection
    padding, instance norms), float32 in eval mode with seeded weights, on
    the seeded batch's LR image and semantics at SP_NOSPADE_BATCH, on this
    rank's stripes where the world is laid out spatially: the whole fake
    (CPU), K1's launches and the halos of the call."""
    from deepsee_torch.models.generator import DeepSEEGenerator
    from deepsee_torch.parallel import distributed, spatial

    spatial.use_mesh(MeshConfig(model_axis=distributed.world_size(), partition="spatial"))
    exp = get_preset(PRESET).replace(is_train=False)
    exp = exp.replace(model=dataclasses.replace(exp.model, compute_dtype="float32"))
    system = SRSystem(exp, device=DEVICE)
    net = DeepSEEGenerator(exp.model, variant="nospade").to(DEVICE).eval()
    generator = torch.Generator().manual_seed(SEED)
    for m in net.modules():
        if hasattr(m, "init_params"):
            m.init_params(generator)
    randomize_weights([net], torch.Generator().manual_seed(SEED + 1))
    system.generator, system.encoder = net, None  # the generator alone: no style
    pre = system.preprocess(spatial.shard_rows(make_batch(exp.model, SP_NOSPADE_BATCH)))
    mn.reset_launches()
    spatial.reset_counts()
    fake, _ = system.generate(pre)
    torch.cuda.synchronize()
    out = {"fake": spatial.gather_rows(fake, dim=1).float().cpu(),
           "launches": {k: v for k, v in mn.launches.items() if v},
           "halo": dict(spatial.counts["halo"])}
    mn.reset_launches()
    del system, net, pre, fake
    torch.cuda.empty_cache()
    return out


def sp_int8_expected(cfg: ModelConfig, batch_n: int, full_trunk: bool, world: int) -> dict:
    """One call of the path under int8_inference() reckoned from the config
    (`int8_conv_shapes`): its quantized convs, K4's launches per call and
    rank, one MAX all-reduce of (mx_raw, mx) (2 Cin float32) per conv, and
    the int8 halos per call and rank: each conv's all-gather of every
    rank's edge rows (its window's top and bottom rows under the owner
    rule, `spatial._halo_plan` on even stripes) of Cp int8 channels."""
    shapes = int8_conv_shapes(cfg, batch_n, full_trunk)
    return dict(_sp_int8_reckoned([(x, w, s, p, n) for x, w, s, p, n in shapes], world),
                launches=int8_per_call(shapes))


def _sp_int8_reckoned(convs, world: int) -> dict:
    """convs: (x (B, Cin, H, W) of the whole map, weight shape, stride,
    padding, count)."""
    from deepsee_torch.parallel import spatial

    halo_calls = halo_bytes = 0
    for (b, cin, h, w), (_, _, k, _), stride, pad, count in convs:
        _, top, bottom, _, _ = spatial._halo_plan(spatial.Rows.even(h, world).bounds, k, stride,
                                                 pad)
        if (k, stride, pad) != (1, 1, 0) and (top or bottom):
            halo_calls += count
            halo_bytes += count * world * b * (top + bottom) * w * ic.padded_channels(cin)
    return {"convs": sum(c[-1] for c in convs), "max_calls": sum(c[-1] for c in convs),
            "max_bytes": sum(2 * c[0][1] * 4 * c[-1] for c in convs),
            "int8_halo_calls": halo_calls, "int8_halo_bytes": halo_bytes}


def sp_int8_check(ranks, one: dict, nudged: dict, smi: str) -> dict:
    """The "sp int8" line, per (preset, dtype) of `_sp_int8`: the model
    ranks' fakes bit for bit alike, against one process's int8 fake (mean
    and max |error| within MAX_SP_INT8_MEAN_ABS / _MAX_ABS or SP_INT8_NOISE
    times one process's float32 one-ulp spread, where larger); every
    quantized conv's s_c, s_k, s_x and k_q on every rank bit for bit the
    whole map's plain quantization of its gathered input; K4's launches per
    call and rank equal one process's; one MAX all-reduce per quantized
    conv and the int8 halos as reckoned from the recorded shapes, and for
    PRESET the launches, MAX all-reduces and int8 halos as reckoned from the
    config (`sp_int8_expected`)."""
    readings, failures = {}, []
    for (preset, dtype), want in one.items():
        tag = f"{preset} b{SP_INFER[preset]} {dtype}"
        got = [r["int8"][(preset, dtype)] for r in ranks]
        fake = got[0]["fake"]
        if any(not torch.equal(g["fake"], fake) for g in got):
            raise AssertionError(f"sp int8 {tag}: the model ranks' fakes differ")
        if fake.shape != want["fake"].shape or not bool(torch.isfinite(fake).all()):
            raise AssertionError(f"sp int8 {tag}: shape {tuple(fake.shape)} or values not finite")
        err = (fake - want["fake"]).abs()
        s = (nudged[(preset, "float32")]["fake"] - one[(preset, "float32")]["fake"]).abs()
        spread = {"mean_abs": float(s.mean()), "max_abs": float(s.max())}
        limits = {k: max(v, SP_INT8_NOISE * spread[k]) for k, v in
                  (("mean_abs", MAX_SP_INT8_MEAN_ABS), ("max_abs", MAX_SP_INT8_MAX_ABS))}
        calls = got[0]["calls"]
        wrong = [{"rank": r, "call": i, "scales": c.get("scales")} for r, g in enumerate(got)
                 for i, c in enumerate(g["calls"]) if not all(c.get("scales", {0: False}).values())]
        recorded = _sp_int8_reckoned([((c["x"][0], c["x"][1], c["x"][2] * SP_WORLD, c["x"][3]),
                                       c["w"], c["stride"], c["pad"][1], 1) for c in calls],
                                     SP_WORLD)
        cfg = get_preset(preset).model
        config = (sp_int8_expected(cfg, SP_INFER[preset], False, SP_WORLD) if preset == PRESET
                  else None)  # `int8_conv_shapes` reckons the 8x paths
        measured = {"max_calls": got[0]["collectives"]["max"]["calls"],
                    "max_bytes": got[0]["collectives"]["max"]["bytes"],
                    "int8_halo_calls": sum(c["halo_calls"] for c in calls),
                    "int8_halo_bytes": sum(c["halo_bytes"] for c in calls)}
        rec = {"mean_abs_err": float(err.mean()), "max_abs_err": float(err.max()),
               "psnr_db_vs_one_process": psnr_db(fake, want["fake"]),
               "one_process_float32_nudged_1ulp": spread, "limits": limits,
               "within_jax_mesh_test_limits": (float(err.mean()) < MAX_SP_INT8_MEAN_ABS
                                               and float(err.max()) < MAX_SP_INT8_MAX_ABS),
               "convs_per_call": len(calls),
               "scales_whole_map_bit_for_bit": len(calls) * len(got) - len(wrong),
               "scales_checked": len(calls) * len(got), "wrong": wrong[:4],
               "k4_launches_per_call_and_rank": got[0]["launches"],
               "one_process_launches": want["launches"],
               "collectives_per_call_and_rank": measured,
               "all_halos_per_call_and_rank": got[0]["collectives"]["halo"],
               "reckoned_from_recorded_shapes": recorded,
               "reckoned_from_config": config}
        readings[tag] = rec
        if float(err.mean()) >= limits["mean_abs"] or float(err.max()) >= limits["max_abs"]:
            failures.append(f"{tag}: the fake parts from one process's int8 fake")
        if wrong or not calls:
            failures.append(f"{tag}: {len(wrong)} convs' scales are not the whole map's")
        if any(g["launches"] != want["launches"] for g in got) or \
                got[0]["launches"]["igemm"] != len(calls):
            failures.append(f"{tag}: K4 launches {got[0]['launches']} != one process's "
                            f"{want['launches']}")
        if any(measured[k] != recorded[k] for k in measured):
            failures.append(f"{tag}: collectives {measured} != reckoned {recorded}")
        if config and (config["launches"] != got[0]["launches"]
                       or any(measured[k] != config[k] for k in measured)):
            failures.append(f"{tag}: launches / collectives not as the config reckons them "
                            f"({config})")
    log("sp int8 " + json.dumps(dict(readings, card=smi)))
    if failures:
        raise AssertionError(f"sp int8: {failures}")
    return readings


def sp_nospade_check(ranks, one: dict, smi: str) -> dict:
    """The "sp nospade" line: the model ranks' nospade fakes bit for bit
    alike and within MAX_SP_INFER_F32_REL (relative L2) of one process's;
    K1's instance split launched where one process launches the instance
    mode, as many times."""
    fakes = [r["nospade"]["fake"] for r in ranks]
    if any(not torch.equal(f, fakes[0]) for f in fakes):
        raise AssertionError("sp nospade: the model ranks' fakes differ")
    if fakes[0].shape != one["fake"].shape or not bool(torch.isfinite(fakes[0]).all()):
        raise AssertionError(f"sp nospade: shape {tuple(fakes[0].shape)} or values not finite")
    launches = ranks[0]["nospade"]["launches"]
    n = one["launches"].get("instance", 0)
    rec = {"preset": PRESET, "variant": "nospade", "model_ranks": SP_WORLD,
           "batch": SP_NOSPADE_BATCH, "dtype": "float32",
           "rel_l2": _rel_l2(fakes[0], one["fake"]), "limit": MAX_SP_INFER_F32_REL,
           "fake_std": float(one["fake"].std()),
           "k1_launches_per_call_and_rank": launches, "one_process_k1_launches": one["launches"],
           "halos_per_call_and_rank": ranks[0]["nospade"]["halo"], "card": smi}
    log("sp nospade " + json.dumps(rec))
    if not rec["rel_l2"] <= MAX_SP_INFER_F32_REL or not rec["fake_std"] > 0.05:
        raise AssertionError(f"sp nospade: parts from one process or is flat: {rec}")
    if not n or launches != {"instance_partials": n, "instance_apply": n}:
        raise AssertionError(f"sp nospade: K1 launches {launches} do not stand for one "
                             f"process's {one['launches']}")
    return rec


def _slab_igemm_check(slab, wshape, stride, pad, dtype, gen) -> dict:
    """(d) on a stripe's slab at (pad_h, pad_w) = `pad` (pad_h 0: the halo
    rows hold H's padding), on the plain quantization's x_q and k_q: bit for
    bit `igemm_plain`'s output."""
    x, w, bias = _int8_inputs(slab, wshape, dtype, gen)
    q = ic.quantize_plain(x, w, True)
    del x
    cin, cp = slab[1], ic.padded_channels(slab[1])
    x_q = torch.zeros((slab[0], cp) + tuple(slab[2:]), dtype=torch.int8, device=q.x_q.device)
    x_q[:, :cin] = q.x_q
    x_q = x_q.contiguous(memory_format=torch.channels_last)
    k_q = torch.zeros((wshape[0],) + tuple(wshape[2:]) + (cp,), dtype=torch.int8,
                      device=x_q.device)
    k_q[..., :cin] = q.k_q.permute(0, 2, 3, 1)
    y = ic.int8_conv_igemm(x_q, k_q, q.s_x, q.s_k, bias, stride, pad, dtype)
    ref = ic.igemm_plain(q.x_q, q.k_q, q.s_x, q.s_k, bias, stride, pad, dtype)
    torch.cuda.synchronize()
    row = {"slab": list(slab), "w": list(wshape), "stride": stride, "pad": list(pad),
           "dtype": str(dtype)[6:], "bit_for_bit": bool(torch.equal(y, ref)),
           "max_abs_err": float((y.float() - ref.float()).abs().max())}
    del q, x_q, k_q, y, ref
    if not row["bit_for_bit"]:
        raise AssertionError(f"(d) on a stripe's slab differs from its plain version: {row}")
    return row


def sp_int8_times(xshape, slab, wshape, stride, pad, gen) -> dict:
    """Device ms of (a)-(c) at a stripe's shape and of (d) on its slab at
    `pad` (bf16), of the bf16 cuDNN conv that the striped bf16 path runs on
    the same slab, of one library call for (a); the plain versions' ms."""
    dtype = torch.bfloat16
    x0, w, bias = _int8_inputs(xshape, wshape, dtype, gen)
    extra = min(3, (120 << 20) // (math.prod(slab) * 2))
    pool = [x0] + [_int8_inputs(xshape, wshape, dtype, gen)[0] for _ in range(extra)]
    slabs = [_int8_inputs(slab, wshape, dtype, gen)[0] for _ in range(extra + 1)]
    mx_raw, mx = ic.absmax_channels(x0)
    s_c, s_k, s_x, k_q = ic.quantize_weight(w, mx_raw, mx, True)
    qslabs = [ic.quantize_activation(s, s_c, s_x) for s in slabs]
    wb, bb = w.to(dtype), bias.to(dtype)
    ms = functools.partial(_device_ms, target_ms=SP_TIMING_MS)
    t = {"absmax": ms([lambda x=x: ic.absmax_channels(x) for x in pool]),
         "quantize_weight": ms([lambda: ic.quantize_weight(w, mx_raw, mx, True)]),
         "quantize_activation": ms([lambda x=x: ic.quantize_activation(x, s_c, s_x)
                                    for x in pool]),
         "igemm": ms([lambda xq=xq: ic.int8_conv_igemm(xq, k_q, s_x, s_k, bias, stride, pad,
                                                       dtype) for xq in qslabs]),
         "bf16_cudnn": ms([lambda s=s: F.conv2d(s, wb, bb, stride=stride, padding=pad)
                           for s in slabs]),
         "absmax_library": ms([lambda x=x: torch.linalg.vector_norm(x, float("inf"),
                                                                    dim=(0, 2, 3))
                               for x in pool])}
    q = ic.quantize_plain(x0, w, True)
    qs = ic.quantize_plain(slabs[0], w, True)
    t["plain"] = {
        "absmax": _event_ms(lambda: ic.absmax_channels_plain(x0), reps=1),
        "quantize_weight": _event_ms(lambda: ic.quantize_weight_plain(
            w, ic.smooth_scales_plain(w, mx, True)), reps=1),
        "quantize_activation": _event_ms(lambda: ic.quantize_activation_plain(x0, q.s_c),
                                         reps=1),
        "igemm": _event_ms(lambda: ic.igemm_plain(qs.x_q, qs.k_q, qs.s_x, qs.s_k, bias, stride,
                                                  pad, dtype), reps=1)}
    del pool, slabs, qslabs, q, qs
    torch.cuda.empty_cache()
    return t


def sp_int8_kernel_rows(ranks, smi: str) -> dict:
    """K4 at every stripe shape of rank 0's bf16 striped int8 call of
    SP_INT8_TIMED: (a)-(d) against their plain versions at the stripe
    (`int8_check`, bf16), (d) on the stripe's slab at pad_h 0 bit for bit
    its plain version (bf16, float32), each kernel timed there (`sp_int8_
    times`) beside its bound and the bf16 cuDNN conv of the same slab.
    Per call and rank: the sums over the call's launches."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    record = ranks[0]["int8"][(SP_INT8_TIMED, "bfloat16")]
    distinct: dict = {}
    for c in record["calls"]:
        key = (tuple(c["x"]), tuple(c["slab"]), tuple(c["w"]), c["stride"], tuple(c["pad"]))
        distinct[key] = distinct.get(key, 0) + 1
    totals = {s: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "launches": 0,
                  "library_ms": 0.0 if s == "absmax" else None,
                  "bound_by": {"bytes": 0.0, "operations": 0.0}} for s in INT8_STAGES}
    errs = dict.fromkeys(INT8_STAGES, 0.0)
    cudnn_ms = 0.0
    for (xshape, slab_q, wshape, stride, pad), n in sorted(distinct.items()):
        slab = (slab_q[0], xshape[1]) + slab_q[2:]   # the float slab: the stripe's channels
        check = int8_check(xshape, wshape, stride, pad[1], torch.bfloat16, True, gen)
        slab_rows = [_slab_igemm_check(slab, wshape, stride, pad, d, gen)
                     for d in (torch.bfloat16, torch.float32)]
        errs["absmax"] = max(errs["absmax"], check["absmax_max_abs_err"])
        errs["quantize_weight"] = max(errs["quantize_weight"], check["scale_max_abs_err"])
        errs["igemm"] = max([errs["igemm"]] + [r["max_abs_err"] for r in slab_rows])
        t = sp_int8_times(xshape, slab, wshape, stride, pad, gen)
        bounds = _int8_bounds(xshape, wshape, stride, pad, 2)
        bounds["igemm"] = _int8_bounds(slab, wshape, stride, pad, 2)["igemm"]
        for stage in INT8_STAGES:
            acc = totals[stage]
            acc["launches"] += n
            acc["ms"] += t[stage] * n
            acc["plain_ms"] += t["plain"][stage] * n
            acc["bound_ms"] += bounds[stage][0] * n
            acc["bound_by"][bounds[stage][1]] += bounds[stage][0] * n
        totals["absmax"]["library_ms"] += t["absmax_library"] * n
        cudnn_ms += t["bf16_cudnn"] * n
        log("sp int8 kernel " + json.dumps({
            "x_stripe": list(xshape), "slab": list(slab), "w": list(wshape), "stride": stride,
            "pad": list(pad), "per_call": n, "ms": {s: t[s] for s in INT8_STAGES},
            "bound_ms": {s: bounds[s][0] for s in INT8_STAGES},
            "bound_share": {s: bounds[s][0] / t[s] for s in INT8_STAGES},
            "plain_ms": t["plain"],
            "bf16_cudnn_ms (library, bf16, not the same function)": t["bf16_cudnn"],
            "igemm_plan": igemm_plan_text(slab, wshape, stride, pad),
            "slab_checks": slab_rows, "card": smi}))
    for acc in totals.values():  # the kind that bounds most of the time
        acc["bound_by"] = max(acc["bound_by"], key=acc["bound_by"].get)
    ic.reset_launches()
    torch.cuda.empty_cache()
    out = {"totals": totals, "errs": errs, "bf16_cudnn_ms": cudnn_ms, "shapes": len(distinct),
           "launches": {k: record["launches"][v] for k, (v, _) in INT8_KERNELS.items()},
           "all_launches": record["launches"]}
    log("sp int8 kernels per striped call of one rank (bf16, device ms) " + json.dumps(
        dict(out, card=smi)))
    return out


def sp_phase(smi: str) -> dict:
    """Spatial sharding on the one card: SP_WORLD spawned model ranks over
    gloo, SP_PRESET at full width with every map cut into two horizontal
    stripes and the networks whole on both ranks.  Float32 (TF32 off), one
    Adam step at b1: the ranks' states bit for bit alike and within
    MAX_SP_UPDATE_REL / MAX_SP_RUNNING_REL of one process, which each planted
    fault must break.  Inference on stripes (PRESET b8, SP_PRESET b2) against
    one process: float32 relative L2, bf16 PSNR; the same paths under
    int8_inference() (the "sp int8" line, `sp_int8_check`) and PRESET's
    "nospade" generator (the "sp nospade" line, `sp_nospade_check`).  bf16
    b2: the "sp" line (ms per step and rank, gloo's host ms, the collectives
    per step and their MiB, K1's launches per step against one process's,
    peak GiB per rank against one process's).  Then every K1 call across
    the stripes held against its plain version and timed
    (`sp_kernel_phase`), and K4 at the striped int8 call's stripe shapes
    (`sp_int8_kernel_rows`).  Returns the kernels line's numbers."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="deepsee_sp_")

    def one_process():
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                one = _sp_steps("float32", SP_F32_BATCH, 1)
                nudged = _sp_steps("float32", SP_F32_BATCH, 1, nudge_ulps=1)["state"]
                infer = _sp_infer()
                int8 = (_sp_int8(), _sp_int8(nudge_ulps=1))
                nospade = _sp_nospade()
            torch.cuda.empty_cache()
            return one, nudged, infer, int8, nospade
        finally:
            with open(os.path.join(root, "go"), "w"):
                pass

    try:
        ranks, (one, nudged, infer, one_int8, one_nospade) = spawned_ranks(
            sp_rank, SP_WORLD, root, one_process)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    limits = {"update_rel": MAX_SP_UPDATE_REL, "running_rel": MAX_SP_RUNNING_REL}
    sums = [_checksum(r["float32"]["state"]) for r in ranks]
    sound = _dp_readings(ranks[0]["float32"]["state"], one["state"], one["before"])
    faults = {f: _dp_readings(ranks[0][f]["state"], one["state"], one["before"])
              for f in SP_FAULTS}
    record = {"preset": SP_PRESET, "model_ranks": SP_WORLD, "batch": SP_F32_BATCH, "steps": 1,
              "checksums": sums, "vs_one_process": sound,
              "one_process_nudged_1ulp": _dp_readings(nudged, one["state"], one["before"]),
              "planted_faults": faults, "limits": limits, "card": smi}
    log("sp float32 " + json.dumps(record))
    if len(set(sums)) != 1:
        raise AssertionError(f"the spatial ranks' states differ after one step: {sums}")
    broken = _dp_broken(sound, **limits)
    if broken:
        raise AssertionError(f"two spatial ranks differ from one process: {broken}")
    for fault, readings in faults.items():
        if not _dp_broken(readings, **limits):
            raise AssertionError(f"the planted fault {fault} passes the limits: the check "
                                 f"cannot see it ({readings})")
    del one, nudged
    inference = {}
    for (preset, dtype), want in infer.items():
        got = [r["infer"][(preset, dtype)] for r in ranks]
        if any(not torch.equal(g, got[0]) for g in got):
            raise AssertionError(f"the spatial ranks' {preset} {dtype} images differ")
        if not bool(torch.isfinite(got[0]).all()) or got[0].shape != want.shape:
            raise AssertionError(f"spatial {preset} {dtype}: shape {tuple(got[0].shape)} or "
                                 "values not finite")
        inference[f"{preset} b{SP_INFER[preset]} {dtype}"] = (
            {"rel_l2": _rel_l2(got[0], want)} if dtype == "float32"
            else {"psnr_db_vs_one_process": psnr_db(got[0], want)})
    log("sp inference " + json.dumps(dict(inference, limits={
        "float32_rel_l2": MAX_SP_INFER_F32_REL, "bf16_psnr_db": MIN_SP_INFER_PSNR_DB},
        card=smi)))
    for tag, r in inference.items():
        if r.get("rel_l2", 0.0) > MAX_SP_INFER_F32_REL or \
                r.get("psnr_db_vs_one_process", math.inf) < MIN_SP_INFER_PSNR_DB:
            raise AssertionError(f"spatial inference {tag} parts from one process: {r}")
    del infer
    sp_int8_check(ranks, *one_int8, smi)
    sp_nospade_check(ranks, one_nospade, smi)
    del one_int8, one_nospade
    torch.cuda.empty_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one16 = _sp_steps("bfloat16", SP_BF16_BATCH, SP_BF16_STEPS, timed=True)
    bf16 = [r["bfloat16"] for r in ranks]
    got_launches = bf16[0]["k1_launches_per_step"]
    want = one16["k1_launches_per_step"]
    expected = {k: want.get(v, 0) for k, v in SP_ONE_PROCESS.items()}
    timing = {"preset": SP_PRESET, "model_ranks": SP_WORLD, "batch": SP_BF16_BATCH,
              "ms_per_step": [r["ms_per_step"] for r in bf16],
              "one_process_ms_per_step": one16["ms_per_step"],
              "gloo_host_ms_per_step": [r["gloo_host_ms_per_step"] for r in bf16],
              "collectives_per_step": bf16[0]["collectives_per_step"],
              "k1_launches_per_step": got_launches,
              "one_process_k1_launches_per_step": want,
              "peak_mem_gib": [r["peak_mem_gib"] for r in bf16],
              "one_process_peak_mem_gib": one16["peak_mem_gib"], "card": smi,
              "note": "two ranks share the one H100 and gloo copies every collective through "
                      "host memory: no yardstick for NCCL across cards"}
    log("sp " + json.dumps(timing))
    if any(r["k1_launches_per_step"] != got_launches for r in bf16):
        raise AssertionError("the spatial ranks launched K1 differently")
    if {k: got_launches.get(k, 0) for k in SP_ONE_PROCESS} != expected or \
            not all(expected.values()):
        raise AssertionError(f"spatial K1 launches per step {got_launches} do not stand for one "
                             f"process's {want}")
    if any(got_launches.get(k) for k in SP_ONE_PROCESS.values()):
        raise AssertionError(f"a one-process K1 mode ran on the stripes: {got_launches}")
    kernels = sp_kernel_phase(ranks)
    int8_kernels = sp_int8_kernel_rows(ranks, smi)
    log(f"sp phase: {time.perf_counter() - t0:.1f} s")
    return dict(kernels, launches=got_launches, int8=int8_kernels)


# -- int8 phase ------------------------------------------------------------------

INT8_OPS_PER_S = 1979e12     # H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)
INT8_SOURCE = "deepsee_torch/csrc/int8conv.cu"
INT8_SITE = "deepsee_tpu/models/layers.py:81"
INT8_SITE_NOTE = ("_int8_conv, an XLA s8 conv (not Pallas); its callers layers.py:167-172, "
                  "normalization.py:58-71 and :130-137")
# name in the kernels line -> (launch counter, the one library call that computes the same
# function, or None)
INT8_KERNELS = {
    "int8_absmax_channels": ("absmax", "torch.linalg.vector_norm(x, inf, dim=(0, 2, 3)) "
                                       "(without the 1e-8 clamp)"),
    "int8_quantize_weight": ("quantize_weight", None),
    "int8_quantize_activation": ("quantize_activation", None),
    "int8_conv_igemm": ("igemm", None),
}
INT8_STAGES = ("absmax", "quantize_weight", "quantize_activation", "igemm")
# shapes beside the paths': a Cin that 32 does not divide, a 1x1 conv (conv_s);
# ragged tiles: a 7x5 image in one 16x8 rectangle with Cout 20, a stride-2 conv
# of a 19x23 image
INT8_EXTRA_SHAPES = [((3, 72, 19, 23), (40, 72, 3, 3), 1, 1),
                     ((8, 512, 64, 64), (256, 512, 1, 1), 1, 0),
                     ((2, 64, 7, 5), (20, 64, 3, 3), 1, 1),
                     ((3, 128, 19, 23), (256, 128, 3, 3), 2, 1)]
INT8_LIBRARY_GEMM = ("torch._int_mm (cuBLASLt s8 x s8 -> s32) at the conv's M x N x K on random s8 "
                     "operands, batch-sliced and scaled by the slices: library GEMM, same M x N x "
                     "K, not the same function: no im2col, no dequantization")
INT_MM_SLICE_BYTES = 1 << 30   # each operand and the s32 product of one slice
INT8_SERVE_REQUESTS = 32
# The float32 int8 path on the card against the CPU's plain int8 path, one
# sample.  Run free, the two differ by about the int8 error itself: their
# float32 activations differ by summation order (cuDNN for the unquantized
# convs, K1 against its plain version), a value that sits on a rounding edge
# lands one int8 level away on one side, and every later layer then differs
# by about a quantization step (printed, not held).  So the card runs
# teacher-forced: each of its int8 convs takes the CPU's input and float32
# weight for the same call (after its own were checked to be within
# MAX_INT8_FORCED_INPUT_REL of them), its kernels' output on them must
# equal the CPU's plain output, and the card's final output must then be
# within MAX_F32_CPU_DIFF of the CPU's, as the float32 paths are.
MAX_INT8_FORCED_INPUT_REL = 1e-4


def int8_conv_shapes(cfg: ModelConfig, batch: int, full_trunk: bool, encode: bool = True,
                     min_ch: int = 64):
    """Every conv of one path call that int8_inference(min_ch) quantizes:
    [((x shape), (weight shape), stride, padding, per call)] in first-call
    order: per generator block two norms (mlp_shared, the modulation conv)
    and conv_0 / conv_1; the style encoder's trunk and head (the mini trunk
    on the LR image or the full trunk on the HR one)."""
    s, nef, nf16, nh = cfg.start_size, cfg.nef, 16 * cfg.ngf, 128
    spec, sty, ks = cfg.norm_g_spec, cfg.regional_style_size, cfg.norm_g_spec.kernel_size
    convs = []
    blocks = [s, 2 * s, 2 * s] + [s * 2 ** (i + 2) for i in range(cfg.n_blocks - 1)]
    for i, hw in enumerate(blocks):
        mod_in = nh + (sty if spec.sean and (i > 0 or not spec.late) else 0)
        for _ in range(2):
            convs += [((batch, cfg.semantic_nc, hw, hw), (nh, cfg.semantic_nc, ks, ks), 1, ks // 2),
                      ((batch, mod_in, hw, hw), (2 * nf16, mod_in, ks, ks), 1, ks // 2),
                      ((batch, nf16, hw, hw), (nf16, nf16, 3, 3), 1, 1)]
    c = cfg.crop_size
    if encode and full_trunk:
        trunk = [((batch, 3, c, c), nef, 1), ((batch, nef, c, c), 2 * nef, 2),
                 ((batch, 2 * nef, c // 2, c // 2), 4 * nef, 2),
                 ((batch, 4 * nef, c // 2, c // 2), 8 * nef, 1),
                 ((batch, 8 * nef, c // 2, c // 2), sty, 1)]
    elif encode:
        trunk = [((batch, 3, s, s), nef, 1), ((batch, nef, s, s), 2 * nef, 1),
                 ((batch, 2 * nef, s, s), 4 * nef, 1),
                 ((batch, 4 * nef, 2 * s, 2 * s), 8 * nef, 1),
                 ((batch, 8 * nef, 2 * s, 2 * s), sty, 1)]
    else:
        trunk = []
    convs = [(x, (cout, x[1], 3, 3), stride, 1) for x, cout, stride in trunk] + convs
    out = {}
    for x, w, stride, pad in convs:
        if w[0] >= min_ch and w[1] >= min_ch:
            out[(x, w, stride, pad)] = out.get((x, w, stride, pad), 0) + 1
    return [key + (n,) for key, n in out.items()]


def int8_per_call(shapes) -> dict:
    """Every int8 launch counter per call of one process: n of each of
    (a)-(d), none of the tensor-parallel (b)'s."""
    return int8_launches(sum(r[-1] for r in shapes))


def int8_launches(n: int) -> dict:
    return dict.fromkeys(ic.launches, 0) | dict.fromkeys(INT8_STAGES, n)


def _int8_inputs(xshape, wshape, dtype, gen):
    """Activations whose channel ranges spread over two decades (the regime
    SmoothQuant is for), one channel all zero; weights and bias as
    init-scale random numbers."""
    dev = torch.device("cuda")
    scales = torch.logspace(-1.5, 0.5, xshape[1], device=dev)[:, None, None]
    x = torch.randn(xshape, generator=gen, device=dev).mul_(scales)
    x[:, 0] = 0.0
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    w = torch.randn(wshape, generator=gen, device=dev) * 0.05
    bias = torch.randn(wshape[0], generator=gen, device=dev) * 0.1
    return x, w, bias


def _ulp_excess(got, want, dtype) -> float:
    """max |got - want| in ulps of want's magnitude in `dtype`."""
    want = want.float()
    mag = want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag))) * torch.finfo(dtype).eps
    return float(((got.float() - want).abs() / ulp).max())


def int8_check(xshape, wshape, stride, pad, dtype, smooth, gen) -> dict:
    """Kernels (a)-(d) against the plain versions on one shape: the maxima
    and the scales bit for bit, x_q and k_q equal, the output within one ulp
    of its type of the plain float64 product's."""
    x, w, bias = _int8_inputs(xshape, wshape, dtype, gen)
    cin = xshape[1]
    want = ic.quantize_plain(x, w, smooth)
    mx_raw, mx = ic.absmax_channels(x)
    s_c, s_k, s_x, k_q = ic.quantize_weight(w, mx_raw, mx, smooth)
    x_q = ic.quantize_activation(x, s_c, s_x)
    del x
    y = ic.int8_conv_igemm(x_q, k_q, s_x, s_k, bias, stride, pad, dtype)
    torch.cuda.synchronize()
    scales = {"mx_raw": (mx_raw, want.mx_raw), "mx": (mx, want.mx), "s_c": (s_c, want.s_c),
              "s_k": (s_k, want.s_k), "s_x": (s_x, want.s_x)}
    row = {"x": list(xshape), "w": list(wshape), "stride": stride, "dtype": str(dtype)[6:],
           "smooth": smooth,
           "scales_equal": all(torch.equal(a, b) for a, b in scales.values()),
           "absmax_max_abs_err": float((mx_raw - want.mx_raw).abs().max()),
           "scale_max_abs_err": max(float((a - b).abs().max()) for a, b in scales.values()),
           "k_q_equal": bool(torch.equal(k_q[..., :cin].permute(0, 3, 1, 2), want.k_q)
                             and not k_q[..., cin:].any()),
           "x_q_equal": bool(torch.equal(x_q[:, :cin], want.x_q) and not x_q[:, cin:].any())}
    del x_q, k_q
    ref = ic.igemm_plain(want.x_q, want.k_q, want.s_x, want.s_k, bias, stride, pad, dtype)
    del want
    row["max_abs_err"] = float((y.float() - ref.float()).abs().max())
    row["max_ulps"] = _ulp_excess(y, ref, dtype)
    del y, ref
    ok = row["scales_equal"] and row["k_q_equal"] and row["x_q_equal"] and row["max_ulps"] <= 1
    log(f"int8 check {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"int8 kernels differ from their plain versions: {row}")
    return row


def _int8_bounds(xshape, wshape, stride, pad, esize: int):
    """The least time of each kernel's function and of the op, (ms, bound_by):
    every input read once and every output written once over the HBM rate,
    or the operations over the peak rate of their type (the conv's
    multiply-adds at the int8 tensor-core rate, the rest in float32)."""
    b, cin, h, w = xshape
    cout, _, kh, kw = wshape
    ph, pw = ic.pads(pad)
    ho, wo = ic.conv_out_size(h, kh, stride, ph), ic.conv_out_size(w, kw, stride, pw)
    n, nw, m = b * cin * h * w, cout * cin * kh * kw, b * ho * wo
    nq = b * ic.padded_channels(cin) * h * w
    kq = cout * kh * kw * ic.padded_channels(cin)
    macs = m * cout * cin * kh * kw

    def bound(nbytes, f32_ops=0.0, int8_ops=0.0):
        t = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": f32_ops / F32_FLOPS_PER_S + int8_ops / INT8_OPS_PER_S}
        by = max(t, key=t.get)
        return t[by] * 1e3, by

    return {"absmax": bound(n * esize + 2 * cin * 4, 2 * n),
            "quantize_weight": bound(nw * 4 + 2 * cin * 4 + kq + (cin + cout + 1) * 4, 6 * nw),
            "quantize_activation": bound(n * esize + nq + cin * 4 + 4, 5 * n),
            "igemm": bound(nq + kq + m * cout * esize + 2 * cout * 4, 3 * m * cout, 2 * macs),
            "op": bound(n * esize + nw * 4 + cout * 4 + m * cout * esize, 0, 2 * macs)}


def igemm_plan_text(xshape, wshape, stride, pad) -> str:
    """Kernel (d)'s tile plan for one conv, as the wrapper launches it."""
    cp = ic.padded_channels(xshape[1])
    p = ic.igemm_plan((xshape[0], cp) + tuple(xshape[2:]), (wshape[0],) + tuple(wshape[2:]) + (cp,),
                      stride, pad, mn.card_sms(torch.device("cuda")))
    return (f"{ic.IGEMM_BM}x{p.bn}x{p.bk} B, {p.stages} stages of "
            f"{(ic.IGEMM_BM + p.bn) * p.bk // 1024} KB, rectangle {p.hbox}x{p.wbox}, "
            f"{p.chunks} chunk(s) x {p.taps} taps, {p.tiles} tiles N fastest on {p.grid} "
            f"persistent blocks")


def int_mm_ms(m: int, n: int, k: int, gen) -> float:
    """torch._int_mm at M x N x K: A (M, K) row-major, B (K, N) column-major,
    random s8; M in slices that keep each operand and the s32 product under
    INT_MM_SLICE_BYTES, the slice's device ms scaled by M / slice rows."""
    dev = torch.device("cuda")
    slices = max(1, -(-m * k // INT_MM_SLICE_BYTES), -(-m * n * 4 // INT_MM_SLICE_BYTES))
    rows = -(-m // slices)
    b = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8).t()
    pool = [torch.randint(-127, 128, (rows, k), generator=gen, device=dev, dtype=torch.int8)
            for _ in range(1 + min(3, (120 << 20) // (rows * k)))]
    ms = _device_ms([lambda a=a: torch._int_mm(a, b) for a in pool]) * m / rows
    del pool, b
    torch.cuda.empty_cache()
    return ms


def int8_times(xshape, wshape, stride, pad, gen) -> dict:
    """Device ms of kernels (a)-(d) apart, of the op, of the bf16 cuDNN conv
    of the same shape, of one library call for (a) and of the library s8
    GEMM of (d)'s M x N x K, over a pool of inputs larger than the L2; the
    plain version's ms per stage by events; the host us of a (d) call."""
    dtype = torch.bfloat16
    x0, w, bias = _int8_inputs(xshape, wshape, dtype, gen)
    pool = [x0] + [_int8_inputs(xshape, wshape, dtype, gen)[0]
                   for _ in range(min(3, (120 << 20) // (x0.numel() * 2)))]
    mx_raw, mx = ic.absmax_channels(x0)
    s_c, s_k, s_x, k_q = ic.quantize_weight(w, mx_raw, mx, True)
    qpool = [ic.quantize_activation(x, s_c, s_x) for x in pool]
    wb, bb = w.to(dtype), bias.to(dtype)
    t = {"absmax": _device_ms([lambda x=x: ic.absmax_channels(x) for x in pool]),
         "quantize_weight": _device_ms([lambda: ic.quantize_weight(w, mx_raw, mx, True)]),
         "quantize_activation": _device_ms([lambda x=x: ic.quantize_activation(x, s_c, s_x)
                                            for x in pool]),
         "igemm": _device_ms([lambda xq=xq: ic.int8_conv_igemm(xq, k_q, s_x, s_k, bias, stride,
                                                               pad, dtype) for xq in qpool]),
         "op": _device_ms([lambda x=x: ic.int8_conv(x, w, bias, stride, pad) for x in pool]),
         "bf16_cudnn": _device_ms([lambda x=x: F.conv2d(x, wb, bb, stride=stride, padding=pad)
                                   for x in pool]),
         "absmax_library": _device_ms([lambda x=x: torch.linalg.vector_norm(
             x, float("inf"), dim=(0, 2, 3)) for x in pool])}
    igemm = functools.partial(ic.int8_conv_igemm, qpool[0], k_q, s_x, s_k, bias, stride, pad,
                              dtype)
    igemm()  # the output's first allocation outside the timed calls
    t["igemm_host_us"] = _host_us(igemm)
    del qpool
    q = ic.quantize_plain(x0, w, True)
    t["plain"] = {
        "absmax": _event_ms(lambda: ic.absmax_channels_plain(x0), reps=1),
        "quantize_weight": _event_ms(lambda: ic.quantize_weight_plain(
            w, ic.smooth_scales_plain(w, mx, True)), reps=1),
        "quantize_activation": _event_ms(lambda: ic.quantize_activation_plain(x0, q.s_c),
                                         reps=1),
        "igemm": _event_ms(lambda: ic.igemm_plain(q.x_q, q.k_q, q.s_x, q.s_k, bias, stride, pad,
                                                  dtype), reps=1)}
    t["plain"]["op"] = sum(t["plain"].values())
    del pool, q
    torch.cuda.empty_cache()
    ho, wo = ic.conv_out_size(xshape[2], wshape[2], stride, pad), ic.conv_out_size(
        xshape[3], wshape[3], stride, pad)
    t["igemm_library_gemm"] = int_mm_ms(xshape[0] * ho * wo, wshape[0],
                                        wshape[1] * wshape[2] * wshape[3], gen)
    return t


def int8_kernel_rows(shapes_by_group, smi: str):
    """The kernel checks at every shape of the groups (bf16 and float32,
    smoothing on; the extra shapes with it off too) and the bf16 times at
    the main path's and the guided trunk's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    checked, rows = set(), []
    for group, shapes in shapes_by_group.items():
        for xshape, wshape, stride, pad, _ in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                for smooth in ((True, False) if group == "extra" else (True,)):
                    key = (xshape, wshape, stride, dtype, smooth)
                    if key not in checked:
                        checked.add(key)
                        rows.append(int8_check(xshape, wshape, stride, pad, dtype, smooth, gen))
            torch.cuda.empty_cache()
    times = {}
    for group in ("main path", "guided trunk"):
        for xshape, wshape, stride, pad, n in shapes_by_group[group]:
            key = (xshape, wshape, stride, pad)
            if key in times:
                continue
            t = int8_times(xshape, wshape, stride, pad, gen)
            bounds = _int8_bounds(xshape, wshape, stride, pad, 2)
            times[key] = dict(t, bounds=bounds)
            log("int8 kernel " + json.dumps({
                "group": group, "x": list(xshape), "w": list(wshape), "stride": stride,
                "per_call": n, "ms": {k: t[k] for k in INT8_STAGES + ("op",)},
                "bound_ms": {k: v[0] for k, v in bounds.items()},
                "bound_by": {k: v[1] for k, v in bounds.items()},
                "bound_share": {k: bounds[k][0] / t[k] for k in INT8_STAGES + ("op",)},
                "plain_ms": t["plain"],
                "bf16_cudnn_ms (library, bf16, not the same function)": t["bf16_cudnn"],
                "igemm_library_gemm_ms (torch._int_mm, same M x N x K, not the same function)":
                    t["igemm_library_gemm"],
                "igemm_plan": igemm_plan_text(xshape, wshape, stride, pad),
                "quantize_weight_plan": ic.weight_plan(
                    wshape[0], wshape[1], wshape[2] * wshape[3],
                    sms=mn.card_sms(torch.device("cuda")))._asdict(),
                "igemm_host_us": t["igemm_host_us"],
                "absmax_library_ms": t["absmax_library"], "card": smi}))
    return rows, times


def int8_path_times(times, shapes) -> dict:
    """Each int8 kernel per call of a path: the device ms, bound, plain and
    library ms of its shapes times their launches, summed; the same for the
    op and the bf16 cuDNN convs of the same shapes."""
    out = {}
    for stage in INT8_STAGES + ("op",):
        rec = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0}
        by = {"bytes": 0.0, "operations": 0.0}
        for xshape, wshape, stride, pad, n in shapes:
            t = times[(xshape, wshape, stride, pad)]
            rec["ms"] += t[stage] * n
            rec["bound_ms"] += t["bounds"][stage][0] * n
            rec["plain_ms"] += t["plain"][stage] * n
            by[t["bounds"][stage][1]] += t["bounds"][stage][0] * n
        rec["bound_by"] = max(by, key=by.get)  # the kind that bounds most of the time
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        out[stage] = rec
    out["absmax"]["library_ms"] = sum(times[r[:4]]["absmax_library"] * r[4] for r in shapes)
    out["bf16_cudnn_ms"] = sum(times[r[:4]]["bf16_cudnn"] * r[4] for r in shapes)
    out["library_gemm_ms"] = sum(times[r[:4]]["igemm_library_gemm"] * r[4] for r in shapes)
    out["igemm_host_us"] = sum(times[r[:4]]["igemm_host_us"] * r[4] for r in shapes) / sum(
        r[4] for r in shapes)
    return out


def drive_int8(tag: str, system: SRSystem, batch, shapes, norms, use_full: bool,
               smooth: bool = True):
    """The path once under int8_inference with both launch counts set to 0
    just before and read just after: the int8 kernels' launches as the
    config reckons them, K1's as without int8.  Returns (fake, launches)."""
    ic.reset_launches()
    mn.reset_launches()
    with int8_inference(smooth=smooth):
        fake = run_path(system, batch, use_full)
    torch.cuda.synchronize()
    launches, k1 = dict(ic.launches), dict(mn.launches)
    want = int8_per_call(shapes)
    log(f"{tag} launches per call: int8 {launches} (expected {want}), K1 {k1} "
        f"(expected {expected_launches(norms)})")
    if launches != want or k1 != expected_launches(norms):
        raise AssertionError(f"{tag}: launches int8 {launches} != {want} or K1 {k1}")
    if not bool(torch.isfinite(fake).all()) or float(fake.abs().max()) > 1.0:
        raise AssertionError(f"{tag}: bad output")
    return fake, launches


def int8_card_vs_cpu(tag: str, system32: SRSystem, batch, fake32_card1) -> dict:
    """The float32 int8 path on the card against the CPU's plain int8 path,
    one sample: teacher-forced (MAX_INT8_FORCED_INPUT_REL) and free."""
    one = {k: v[:1] for k, v in batch.items()}
    cpu = _like(system32, "float32", "cpu")
    calls, real_plain = [], ic.int8_conv_plain

    def recording(x, weight, bias, stride, padding, smooth, out_dtype=None):
        y = real_plain(x, weight, bias, stride, padding, smooth, out_dtype)
        calls.append((x, weight, bias, y))
        return y

    t0 = time.perf_counter()
    ic.int8_conv_plain = recording
    try:
        with int8_inference():
            cpu1 = run_path(cpu, one)
    finally:
        ic.int8_conv_plain = real_plain
    cpu_s = time.perf_counter() - t0
    report, real_conv = [], layers_mod.int8_conv

    def forced(x, weight, bias, stride, padding, smooth):
        xc, wc, bc, yc = calls[len(report)]
        xc = xc.to(x.device).contiguous(memory_format=torch.channels_last)
        wc, bc = wc.to(x.device), None if bc is None else bc.to(x.device)
        y = real_conv(xc, wc, bc, stride, padding, smooth)
        report.append({"input_rel": float((x - xc).abs().max())
                       / max(float(xc.abs().max()), 1e-30),
                       "weight_abs": float((weight - wc).abs().max()),
                       "kernels_vs_plain": float((y.cpu() - yc).abs().max())})
        return y

    layers_mod.int8_conv = forced
    try:
        with int8_inference():
            card1 = run_path(system32, one).cpu()
    finally:
        layers_mod.int8_conv = real_conv
    with int8_inference():
        free1 = run_path(system32, one).cpu()
    ref = fake32_card1.cpu()
    rec = {"forced_max_abs_diff": float((card1 - cpu1).abs().max()),
           "max_forced_input_rel": max(r["input_rel"] for r in report),
           "max_weight_abs_diff": max(r["weight_abs"] for r in report),
           "max_kernels_vs_plain": max(r["kernels_vs_plain"] for r in report),
           "calls": len(report), "free_card_vs_cpu_psnr_db": psnr_db(free1, cpu1),
           "free_card_vs_cpu_max_abs_diff": float((free1 - cpu1).abs().max()),
           "card_int8_vs_float32_psnr_db": psnr_db(free1, ref),
           "cpu_int8_vs_float32_psnr_db": psnr_db(cpu1, ref), "cpu_s": cpu_s,
           "limits": {"forced": MAX_F32_CPU_DIFF, "input_rel": MAX_INT8_FORCED_INPUT_REL}}
    log(f"{tag} float32 int8 card vs CPU plain, one sample " + json.dumps(rec))
    if not (rec["forced_max_abs_diff"] <= MAX_F32_CPU_DIFF
            and rec["max_forced_input_rel"] <= MAX_INT8_FORCED_INPUT_REL
            and rec["max_kernels_vs_plain"] == 0.0 and len(report) == len(calls)):
        raise AssertionError(f"{tag}: the card's int8 path differs from the CPU's: {rec}")
    return rec


def int8_serving(system: SRSystem, smi: str) -> dict:
    """Export the main model as a bf16 and an int8 program (trace batch 8),
    hold the loaded int8 program against the live int8 system, serve both
    from one daemon under the aliases bf16 and int8 and check every
    response against its program on its batch."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="deepsee_int8_serving_")
    cfg = system.cfg
    try:
        dirs = {"bf16": os.path.join(root, "bf16"), "int8": os.path.join(root, "int8")}
        exports = {}
        for alias, mode in (("bf16", ""), ("int8", "int8")):
            t0 = time.perf_counter()
            programs = serve.export_serving(system, SERVE_BATCH, quantize=mode)
            exports[alias] = {"export_s": time.perf_counter() - t0}
            serve.save_serving(dirs[alias], system.exp, programs, SERVE_BATCH, system.device,
                               quantize=mode)
            nodes = {name: sum(str(n.target) == "deepsee.int8_conv.default"
                               for n in p.graph.nodes) for name, p in programs.items()}
            exports[alias]["int8_nodes"] = nodes
            del programs
        want_nodes = {"end_to_end": sum(r[-1] for r in int8_conv_shapes(cfg, 1, False)),
                      "styled": sum(r[-1] for r in int8_conv_shapes(cfg, 1, False, False))}
        if (exports["int8"]["int8_nodes"] != want_nodes
                or any(exports["bf16"]["int8_nodes"].values())):
            raise AssertionError(f"int8 nodes in the programs: {exports}")
        e2e_args, styled_args = _trace_batch_args(cfg, False)
        for name, args in (("end_to_end", e2e_args), ("styled", styled_args)):
            loaded = serve.load_serving(dirs["int8"], name)
            with int8_inference():
                want = _live(system, args, name == "styled")
            check_served_program(f"int8/{name}", loaded, args, want)
        log("int8 exports " + json.dumps(exports))

        srv = server_mod.ServingServer([f"{a}={d}" for a, d in dirs.items()], port=0,
                                       host="127.0.0.1", batch_window_ms=5.0, device=DEVICE)
        srv.start()
        try:
            rng = np.random.RandomState(SEED + 5)
            requests = []
            for i in range(INT8_SERVE_REQUESTS):
                alias, styled = ("bf16", "int8")[i % 2], (i // 2) % 2 == 1
                m = srv.manifests[alias]
                crop, start, nc = m["crop_size"], m["start_size"], m["label_nc"]
                lr = rng.randint(0, 256, (start, start, 3), dtype=np.uint8)
                lab = rng.randint(0, nc, (crop, crop), dtype=np.uint8)
                parts, headers = [lr.tobytes(), lab.tobytes()], {"X-DS-Model": alias}
                args = [server_mod.image_from_u8(lr.reshape(-1), start),
                        server_mod.label_from_u8(lab.reshape(-1), crop, nc)]
                if styled:
                    style = (0.5 * np.tanh(rng.randn(nc, m["regional_style_size"]))
                             ).astype("<f4")
                    parts.append(style.tobytes())
                    headers["X-DS-Style"] = "1"
                    args.append(style[None])
                program = f"{alias}/{'styled' if styled else 'end_to_end'}"
                requests.append((program, headers, b"".join(parts), args))
            warm = {}
            for i, req in enumerate(requests):
                warm.setdefault(req[0], (i, req))
            _client(srv.port, list(warm.values()), {}, threading.Lock())
            programs = {name: fn for name, (fn, _) in srv.batcher.programs.items()}
            served = record_batches(srv)
            srv.batcher.reset_stats()
            ic.reset_launches()
            results, lock = {}, threading.Lock()
            clients = min(SERVE_CLIENTS, INT8_SERVE_REQUESTS)
            shares = [[(i, requests[i]) for i in range(k, INT8_SERVE_REQUESTS, clients)]
                      for k in range(clients)]
            threads = [threading.Thread(target=_client, args=(srv.port, share, results, lock))
                       for share in shares]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            window_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = dict(ic.launches)
            prog_stats = srv.health()["programs"]
            stats = srv.batcher.stats_snapshot()
            if any(t.is_alive() for t in threads) or len(results) != INT8_SERVE_REQUESTS:
                raise AssertionError(f"int8 serving: {len(results)} of {INT8_SERVE_REQUESTS} "
                                     "answered")
            bad = {i: r[1][:200] for i, r in results.items() if r[0] != 200}
            if bad or stats["errors"]:
                raise AssertionError(f"int8 serving: {stats['errors']} errors, failed: {bad}")
            batches = {p: ps["batches"] for p, ps in prog_stats.items()}
            n = sum(batches.get(f"int8/{name}", 0) * k for name, k in want_nodes.items())
            log(f"int8 serving launches in the window: {launches} (expected {n} each from "
                f"{json.dumps(batches)} batches)")
            if launches != int8_launches(n):
                raise AssertionError(f"int8 serving: int8 launches {launches}, expected {n}")
            u8_diff, style_diff, regrouped, call_s = check_responses(programs, served,
                                                                     requests, results)
            lat = {a: np.sort([r[3] for i, r in results.items()
                               if requests[i][0].startswith(a)]) * 1e3 for a in dirs}
            record = {
                "requests": INT8_SERVE_REQUESTS, "clients": clients, "trace_batch": SERVE_BATCH,
                "window_s": window_s, "requests_per_s": INT8_SERVE_REQUESTS / window_s,
                "p50_ms": {a: float(np.percentile(v, 50)) for a, v in lat.items()},
                "p99_ms": {a: float(np.percentile(v, 99)) for a, v in lat.items()},
                "batches_per_program": batches, "errors": stats["errors"],
                "max_u8_diff_vs_direct": u8_diff, "max_style_diff_vs_direct": style_diff,
                "max_u8_diff_in_other_batches": regrouped,
                "direct_call_ms": {p: float(np.median(v)) * 1e3 for p, v in call_s.items()},
                "exports": exports, "card": smi, "wall_s": time.perf_counter() - t_phase}
            log("int8 serving " + json.dumps(record))
            return record
        finally:
            srv.stop()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def int8_clis(smi: str) -> dict:
    """The int8 flags of the three CLIs, each in a process of its own, all at
    once: python -m deepsee_torch.serve --quantize int8_nosmooth (trace batch
    2), python -m deepsee_torch.demo --int8 on a seeded LR image and label
    map, python -m deepsee_torch.evaluate --int8 on 16 synthetic samples."""
    from PIL import Image

    cfg = get_preset(PRESET).model
    root = tempfile.mkdtemp(prefix="deepsee_int8_clis_")
    try:
        rng = np.random.RandomState(SEED + 6)
        lr, sem = os.path.join(root, "lr.png"), os.path.join(root, "sem.png")
        Image.fromarray(rng.randint(0, 256, (cfg.start_size, cfg.start_size, 3),
                                    dtype=np.uint8)).save(lr)
        Image.fromarray(rng.randint(0, cfg.label_nc, (cfg.crop_size, cfg.crop_size),
                                    dtype=np.uint8)).save(sem)
        outs = {name: os.path.join(root, name) for name in ("serve", "demo")}
        cmds = {
            "serve": ["-m", "deepsee_torch.serve", "--name", PRESET, "--batch_size", "2",
                      "--quantize", "int8_nosmooth", "--out", outs["serve"]],
            "demo": ["-m", "deepsee_torch.demo", "--name", PRESET, "--image_lr", lr,
                     "--semantics", sem, "--int8", "--out", outs["demo"]],
            "evaluate": ["-m", "deepsee_torch.evaluate", "--name", PRESET, "--synthetic",
                         "--no_checkpoint", "--num_samples", "16", "--batch_size", "8",
                         "--no_fid", "--no_lpips", "--int8"]}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen([sys.executable, *cmd, "--device", DEVICE],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for name, cmd in cmds.items()}
        runs = {}
        try:
            for name, proc in procs.items():
                out, err = proc.communicate(timeout=600)
                runs[name] = (proc.returncode, out, err, time.perf_counter() - t0)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = {n: (r[1][-1500:] + r[2][-1500:]) for n, r in runs.items() if r[0] != 0}
        if failed:
            raise AssertionError(f"int8 CLIs failed: {failed}")
        with open(os.path.join(outs["serve"], "manifest.json")) as f:
            manifest = json.load(f)
        metrics = json.loads(runs["evaluate"][1][runs["evaluate"][1].index("{"):])
        record = {"serve_manifest_quantize": manifest["quantize"],
                  "serve_files": sorted(os.listdir(outs["serve"])),
                  "demo_files": sorted(os.listdir(outs["demo"])),
                  "evaluate": {k: metrics[k] for k in ("psnr/mean", "ssim/mean", "rmse/mean")},
                  "seconds": {n: r[3] for n, r in runs.items()}, "card": smi}
        log("int8 clis " + json.dumps(record))
        if (manifest["quantize"] != "int8_nosmooth" or "demo_lr.png" not in record["demo_files"]
                or not all(math.isfinite(v) for v in record["evaluate"].values())):
            raise AssertionError(f"int8 CLIs: {record}")
        return record
    finally:
        shutil.rmtree(root, ignore_errors=True)


def int8_phase(system: SRSystem, smi: str) -> dict:
    """The int8 serving path (module docstring, 8)."""
    t_phase = time.perf_counter()
    if any(ic.launches.values()):
        raise AssertionError(f"int8 kernels launched outside int8_inference: {ic.launches}")
    cfg = system.cfg
    gcfg = get_preset(SERVE_PRESETS["guided"]).model
    main = int8_conv_shapes(cfg, BATCH, full_trunk=False)
    guided = int8_conv_shapes(gcfg, BATCH, full_trunk=True)
    trunk = [r for r in guided if r not in main]
    trace = sorted({r[:4] + (0,) for r in int8_conv_shapes(cfg, SERVE_BATCH, False)
                    + int8_conv_shapes(gcfg, SERVE_BATCH, True)})
    shapes = {"main path": main, "guided trunk": trunk, "trace batch": trace,
              "extra": [r + (0,) for r in INT8_EXTRA_SHAPES]}
    log("int8 shapes " + json.dumps({g: [[list(r[0]), list(r[1]), r[2], r[4]] for r in rs]
                                     for g, rs in shapes.items()}))
    rows, times = int8_kernel_rows(shapes, smi)
    log(f"int8 kernel checks: {len(rows)} passed in {time.perf_counter() - t_phase:.1f} s")

    # the main path under int8: launches, ms per batch, accuracy, a profile
    batch = make_batch(cfg, BATCH)
    norms = path_norms(cfg, BATCH, full_trunk=False)
    fake_bf16 = run_path(system, batch)
    fake, launches = drive_int8("int8 path", system, batch, main, norms, use_full=False)
    with int8_inference():
        ms = _event_ms(lambda: run_path(system, batch), reps=5)
    bf16_ms = _event_ms(lambda: run_path(system, batch), reps=5)
    fake_ns, _ = drive_int8("int8_nosmooth path", system, batch, main, norms, use_full=False,
                            smooth=False)
    with int8_inference(smooth=False):
        ms_ns = _event_ms(lambda: run_path(system, batch), reps=5)
    with int8_inference():
        profile_path("int8 path", system, batch, ms, use_full=False)
    system32 = _like(system, "float32", DEVICE)
    fake32 = run_path(system32, batch)
    fake32_int8, _ = drive_int8("int8 path float32", system32, batch, main, norms,
                                use_full=False)
    fake32_ns, _ = drive_int8("int8_nosmooth path float32", system32, batch, main, norms,
                              use_full=False, smooth=False)
    accuracy = {"int8_vs_bf16_psnr_db": psnr_db(fake, fake_bf16),
                "int8_vs_float32_psnr_db": psnr_db(fake32_int8, fake32),
                "int8_bf16_system_vs_float32_psnr_db": psnr_db(fake, fake32),
                "bf16_vs_float32_psnr_db": psnr_db(fake_bf16, fake32),
                "int8_nosmooth_vs_bf16_psnr_db": psnr_db(fake_ns, fake_bf16),
                "int8_nosmooth_vs_float32_psnr_db": psnr_db(fake32_ns, fake32),
                "max_abs_diff_int8_vs_bf16": float((fake - fake_bf16).abs().max()),
                "weights": "seeded random (randomize_weights), not trained"}
    path = {"ms_per_batch": ms, "bf16_ms_per_batch": bf16_ms, "nosmooth_ms_per_batch": ms_ns,
            "img_per_s": BATCH / ms * 1e3, "int8_launches_per_call": launches,
            "kernels": int8_path_times(times, main), "card": smi}
    log("int8 path " + json.dumps(dict(path, accuracy=accuracy)))
    del fake, fake_ns, fake32_int8, fake32_ns
    accuracy["card_vs_cpu"] = int8_card_vs_cpu("int8 path", system32, batch, fake32[:1])
    del system32, fake32, fake_bf16
    torch.cuda.empty_cache()

    # the guided 8x path under int8
    gsys = seeded_system(SERVE_PRESETS["guided"])
    gbatch = make_batch(gcfg, BATCH, guided=True)
    gref = run_path(gsys, gbatch, use_full=True)
    gfake, glaunches = drive_int8("int8 guided path", gsys, gbatch, guided,
                                  path_norms(gcfg, BATCH, full_trunk=True), use_full=True)
    with int8_inference():
        gms = _event_ms(lambda: run_path(gsys, gbatch, use_full=True), reps=3)
    log("int8 guided path " + json.dumps({"ms_per_batch": gms,
                                          "int8_vs_bf16_psnr_db": psnr_db(gfake, gref),
                                          "int8_launches_per_call": glaunches}))
    del gfake, gref
    torch.cuda.empty_cache()
    gdir = tempfile.mkdtemp(prefix="deepsee_int8_guided_")
    try:  # the guided model's int8 export at the trace batch, against the live system
        t0 = time.perf_counter()
        programs = serve.export_serving(gsys, SERVE_BATCH, quantize="int8")
        export_s = time.perf_counter() - t0
        nodes = {name: sum(str(n.target) == "deepsee.int8_conv.default" for n in p.graph.nodes)
                 for name, p in programs.items()}
        serve.save_serving(gdir, gsys.exp, programs, SERVE_BATCH, gsys.device, quantize="int8")
        del programs
        want_nodes = {"end_to_end": sum(r[-1] for r in int8_conv_shapes(gcfg, 1, True)),
                      "styled": sum(r[-1] for r in int8_conv_shapes(gcfg, 1, True, False))}
        log(f"int8 guided export: {export_s:.1f} s, int8 nodes {nodes} (expected {want_nodes})")
        if nodes != want_nodes:
            raise AssertionError(f"int8 guided export: int8 nodes {nodes} != {want_nodes}")
        e2e_args, _ = _trace_batch_args(gcfg, True)
        with int8_inference():
            want = _live(gsys, e2e_args, False)
        check_served_program("int8 guided/end_to_end", serve.load_serving(gdir), e2e_args, want)
    finally:
        shutil.rmtree(gdir, ignore_errors=True)
    del gsys
    torch.cuda.empty_cache()

    serving = int8_serving(system, smi)
    clis = int8_clis(smi)
    ic.reset_launches()
    log(f"int8 phase: {time.perf_counter() - t_phase:.1f} s")
    errs = {"absmax": max(r["absmax_max_abs_err"] for r in rows),
            "quantize_weight": max(r["scale_max_abs_err"] for r in rows),
            "quantize_activation": 0.0 if all(r["x_q_equal"] for r in rows) else None,
            "igemm": max(r["max_abs_err"] for r in rows)}
    return {"launches": launches, "times": path["kernels"], "errs": errs,
            "serving": serving, "accuracy": accuracy, "clis": clis}


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


def kernels_line(rows, launches, norms, train=None, dp=None, int8=None, tp=None, sp=None):
    """Every kernel: the inference modes per main-path call; the training
    kernels per faithful training step (`train`: its launches, per-step
    times and the training kernel rows), with their launches per
    tensor-parallel step and rank beside (`tp`: `tp_phase`'s); the batch
    modes split across ranks per data-parallel step and rank (`dp`:
    `dp_phase`'s numbers), with their launches per spatial step and rank
    beside (`sp`: `sp_phase`'s); the instance mode split across stripes per
    spatial step and rank (`sp`); the int8 conv's kernels per int8
    main-path call (`int8`: `int8_phase`'s), with their launches per
    tensor-parallel and per striped call and rank beside, and the same
    kernels per striped int8 call and rank (`sp`)."""
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
            "tp_launches_per_step_and_rank": tp["k1"][mode],
            "tp_per": f"one tensor-parallel step of one of {TP_WORLD} model ranks ({PRESET} "
                      f"b{TP_BATCH}, on each rank's channel block)",
            "sp_launches_per_step_and_rank": int(sp["launches"].get(mode, 0)),
            "sp_per": f"one spatial step of one of {SP_WORLD} model ranks ({SP_PRESET} "
                      f"b{SP_BF16_BATCH}; the split modes run there instead)",
        })
    for name, (key, _, library_call) in SPLIT_INFO.items():
        t = dp["times"][key]
        out.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": dp["launches"][name], "max_abs_err": dp["errs"][key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": library_call, "one_process_ms": t["one_process_ms"],
            "per": f"one data-parallel training step of one rank ({PRESET}, {DP_WORLD} ranks x "
                   f"b{DP_PER_RANK}, faithful schedule; launches A + B or sums + pass, the "
                   "collective between them not timed; sum over the launches), device time",
            "sp_launches_per_step_and_rank": {
                c: int(sp["launches"].get(c, 0)) for c in SPLIT_INFO[name][1]},
            "sp_ms": sum(sp["totals"]["batch"][stage]["ms"] for stage in
                         (("partials", "apply") if key == "fwd" else ("sums", "pass"))),
            "sp_per": f"one spatial step of one of {SP_WORLD} model ranks ({SP_PRESET} "
                      f"b{SP_BF16_BATCH}, the generator's batch norms over the world), device "
                      "time at the ranks' stripe shapes",
        })
    for name, (kind, stage, library_call) in SP_KERNELS.items():
        t = sp["totals"][kind][stage]
        out.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": int(sp["launches"].get(dict(SP_STAGES[kind])[stage], 0)),
            "max_abs_err": sp["errs"][kind],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": library_call,
            "per": f"one spatial training step of one of {SP_WORLD} model ranks ({SP_PRESET} "
                   f"b{SP_BF16_BATCH}, each rank a stripe of every map; the all-reduce between "
                   "the launches not timed; sum over the launches), device time",
        })
    for name, (key, library_call) in INT8_KERNELS.items():
        t = int8["times"][key]
        entry = {
            "name": name, "route": "cuda", "source": INT8_SOURCE, "replaces": INT8_SITE,
            "replaces_note": INT8_SITE_NOTE, "launches": int8["launches"][key],
            "max_abs_err": int8["errs"][key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "library_call": library_call,
            "per": f"one int8 main-path call ({PRESET} b{BATCH} under int8_inference(); sum "
                   "over its launches), device time",
        }
        entry["tp_launches_per_call_and_rank"] = tp["int8_launches"][key]
        entry["tp_per"] = (f"one int8 main-path call of one of {TP_WORLD} model ranks ({PRESET} "
                           f"b{TP_INT8_BATCH}, float32)")
        entry["sp_launches_per_call_and_rank"] = sp["int8"]["launches"][name]
        entry["sp_per"] = (f"one striped int8 main-path call of one of {SP_WORLD} model ranks "
                           f"({SP_INT8_TIMED} b{SP_INFER[SP_INT8_TIMED]}, bf16; the rows "
                           f"{name}_on_stripes)")
        if key == "igemm":
            entry["bf16_cudnn_ms"] = int8["times"]["bf16_cudnn_ms"]
            entry["bf16_cudnn_note"] = ("library (bf16, not the same function): F.conv2d in "
                                        "bf16 at the same shapes")
            entry["library_gemm_ms"] = int8["times"]["library_gemm_ms"]
            entry["library_gemm_note"] = INT8_LIBRARY_GEMM
            entry["host_us_per_launch"] = int8["times"]["igemm_host_us"]
        out.append(entry)
    for name, (key, library_call) in INT8_KERNELS.items():
        t = sp["int8"]["totals"][key]
        entry = {
            "name": f"{name}_on_stripes", "route": "cuda", "source": INT8_SOURCE,
            "replaces": INT8_SITE,
            "replaces_note": INT8_SITE_NOTE + "; under the spatial layout (int8_conv_striped)",
            "launches": sp["int8"]["launches"][name], "max_abs_err": sp["int8"]["errs"][key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": library_call,
            "per": f"one striped int8 main-path call of one of {SP_WORLD} model ranks "
                   f"({SP_INT8_TIMED} b{SP_INFER[SP_INT8_TIMED]}, bf16; sum over its launches "
                   "at the stripe shapes, (d) on the stripes' slabs at pad_h 0; the MAX "
                   "all-reduce and the halo between the launches not timed), device time",
        }
        if key == "igemm":
            entry["bf16_cudnn_ms"] = sp["int8"]["bf16_cudnn_ms"]
            entry["bf16_cudnn_note"] = ("library (bf16, not the same function): F.conv2d in "
                                        "bf16 on the same slabs at padding (0, p)")
        out.append(entry)
    for name, (key, role) in TP_INT8_KERNELS.items():
        t = tp["int8"]["totals"][key]
        out.append({
            "name": name, "route": "cuda", "source": INT8_SOURCE, "replaces": INT8_SITE,
            "replaces_note": INT8_SITE_NOTE + "; " + role,
            "launches": tp["int8_launches"][key], "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": (TP_COLUMN_MAXIMA_LIBRARY if t["library_ms"] is not None else None),
            "per": f"one int8 main-path call of one of {TP_WORLD} model ranks ({PRESET} "
                   f"b{TP_INT8_BATCH}, float32; sum over its launches at the ranks' block "
                   "shapes), device time; bit for bit the plain version (max_abs_err 0)",
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
    seconds = {"build": time.perf_counter() - t0}

    def phase(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t

    # first, while the card holds nothing else: its memory limits are the phase's readings
    phase("train512", train512_phase, smi)
    rows = phase("kernel", kernel_phase, cfg, BATCH)
    launches, system = phase("main_path", path_phase, BATCH)
    for preset, batch_n in GUIDED_PATHS.items():
        phase(preset, guided_phase, preset, batch_n, rows)
    synthetic_sweep = phase("evaluation", evaluation_phase, system, smi)
    phase("explorative", explorative_phase, system)
    phase("serving", serving_phase, system, smi)
    int8 = phase("int8", int8_phase, system, smi)
    del system
    torch.cuda.empty_cache()
    train, resident = phase("training", training_phase, smi)
    phase("data", data_phase, smi, resident, synthetic_sweep)
    torch.cuda.empty_cache()
    dp = phase("dp", dp_phase, smi)
    tp = phase("tp", tp_phase, smi)
    sp = phase("sp", sp_phase, smi)
    if any(ic.launches.values()):
        raise AssertionError(f"int8 kernels launched outside int8_inference: {ic.launches}")

    log("phase seconds " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    log(json.dumps(kernels_line(rows, launches, path_norms(cfg, BATCH, full_trunk=False),
                                train, dp, int8, tp, sp)))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
