#!/usr/bin/env python3
"""Where the time goes inside one launch of K4 (b) and of K1's instance forward.

    python3 scripts/kernel_phases.py [--split-only | --tp-only]

Builds deepsee_torch/csrc/int8conv.cu and modnorm.cu with
-DDEEPSEE_PHASE_MARKS, which turns the sources' PHASE_MARK(k) points
(csrc/phase_marks.cuh) into reads of the card's global timer (%globaltimer,
ns) by thread 0 of every block, launches each kernel three times on one
shape (the last launch's marks are kept) and prints, per mark, the earliest,
median and latest block, in ns after the first block started.  The marks:

* K4 (b) `quantize_weight_kernel`, smoothing and not, at the 512 x 512,
  1024 x 256 and 128 x 64 3x3 weights of the int8 main path: after the
  column maxima were issued, after the grid barrier, s_c, s_x (block 0),
  the row maxima, and the end of the k_q stores;
* K1's on-chip cluster kernel (`modnorm_instance_kernel`) at the
  discriminator's and the mini trunk's shapes of a faithful b4 step: the
  chunk's sum, the squared deviations, the cluster barrier, the merge of
  the ranks' partials, the statistics, the end of the apply;
* K1's grid variant (`modnorm_batch_kernel<..., INSTANCE>`) at the full
  trunk's shapes of that step: the pilot mean, the streamed vectors, the
  sums, the grid barrier, the merged statistics, the streamed apply, the
  end;
* with --tp-only, K4 (b)'s launches under a tensor-parallel shard at the
  block shapes of one rank's int8 main-path call
  (scripts/tp_weight_kernels_in_turns.py's BLOCKS): the column maxima, the
  row maxima and the scales of a column and of a row block, smoothing, with
  the marks each launch passes (through the entries the tree's library has:
  the redesigned `int8_weight_column_maxima` / `int8_weight_scales`, or the
  earlier modes of one kernel, so that a parent tree runs it too).

Single launches, not CUDA graphs: the numbers show the order and size of
each phase, not the launch's device time, which chip_smoke.py and
scripts/instance_plans.py measure.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepsee_torch.ops import _build  # noqa: E402
from deepsee_torch.ops import int8conv as ic  # noqa: E402
from deepsee_torch.ops import modnorm as mn  # noqa: E402

BLOCKS = 8192   # phase_marks.cuh: kPhaseBlocks, kPhaseMarks
MARKS = 16


def build(name: str, workdir: str) -> ctypes.CDLL:
    """csrc/<name>.cu built with its phase marks on, into `workdir`."""
    out = os.path.join(workdir, f"lib{name}_phases.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DDEEPSEE_PHASE_MARKS", "-o", out,
                    str(_build.CSRC / f"{name}.cu")], check=True)
    lib = ctypes.CDLL(out)
    lib.phase_marks_read.argtypes = [ctypes.c_void_p]
    return lib


def phases(tag: str, lib: ctypes.CDLL, launch, blocks: int, names) -> None:
    for _ in range(3):
        lib.phase_marks_clear()
        torch.cuda.synchronize()
        err = launch()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"kernel_phases: {tag}: CUDA error {err}")
    buf = np.zeros((BLOCKS, MARKS), np.uint64)
    lib.phase_marks_read(buf.ctypes.data)
    t = buf[:blocks].astype(np.int64)
    first = next(k for k, name in enumerate(names) if name)
    t0 = t[:, first][t[:, first] > 0].min()
    row = {}
    for k, name in enumerate(names):
        col = t[:, k][t[:, k] > 0] - t0
        if name and col.size:
            row[name] = [int(col.min()), int(np.median(col)), int(col.max())]
    print(f"phases {tag} " + json.dumps(row), flush=True)


def weight_phases(workdir: str, gen) -> None:
    lib = build("int8conv", workdir)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.int8_quantize_weight.argtypes = [p] * 8 + [i32] * 6 + [p]
    dev = torch.device("cuda")
    names = ["start", "column maxima", "grid barrier", "s_c", "s_x", "row maxima", "end"]
    for wshape in [(512, 512, 3, 3), (1024, 256, 3, 3), (128, 64, 3, 3)]:
        cout, cin, kh, kw = wshape
        w = torch.randn(wshape, generator=gen, device=dev) * 0.05
        mx_raw, mx = ic.absmax_channels_plain(torch.randn((2, cin, 5, 6), generator=gen,
                                                          device=dev))
        cp = ic.padded_channels(cin)
        s_c, s_k = torch.empty(cin, device=dev), torch.empty(cout, device=dev)
        s_x = torch.empty((), device=dev)
        k_q = torch.empty((cout, kh, kw, cp), dtype=torch.int8, device=dev)
        mk = torch.empty(cin, dtype=torch.int32, device=dev)
        for smooth in (1, 0):
            plan = ic.weight_plan(cout, cin, kh * kw, bool(smooth), mn.card_sms(dev))
            phases(f"quantize_weight {list(wshape)} smooth={smooth}", lib, lambda: (
                lib.int8_quantize_weight(w.data_ptr(), mx.data_ptr(), mx_raw.data_ptr(),
                                         s_c.data_ptr(), s_k.data_ptr(), s_x.data_ptr(),
                                         k_q.data_ptr(), mk.data_ptr(), cout, cin, cp,
                                         kh * kw, smooth, plan.grid,
                                         torch.cuda.current_stream().cuda_stream)),
                plan.grid, names)


def instance_phases(workdir: str, gen) -> None:
    lib = build("modnorm", workdir)
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.modnorm_instance.argtypes = [p, p, p, p, p, i32, i64, i32, i32, i32, i32, i32, i32,
                                     f32, i32, i32, f32, p]
    lib.modnorm_instance_grid.argtypes = [p, p, p, p, p, p, i32, i64, i32, i32, i32, i32, f32,
                                          i32, i32, f32, p]
    dev = torch.device("cuda")
    cluster_names = ["start", "sum", "squared deviations", "cluster barrier", "ranks read",
                     "statistics", "end"]
    grid_names = [""] * 7 + ["start", "pilot mean", "streamed", "sums", "grid barrier",
                             "statistics", "streamed apply", "end"]
    cfg = cs.get_preset(cs.PRESET).model
    shapes = {shape for g_full in (True, False)
              for stats, shape, *_ in cs.train_norms(cfg, cs.TRAIN_BATCH, g_full)
              if stats == "instance"}
    for shape in sorted(shapes):
        b, c, h, w = shape
        x = cs._kernel_inputs(shape, False, torch.bfloat16, gen)[0]
        out = torch.empty_like(x)
        mean, rstd = torch.empty((b, c), device=dev), torch.empty((b, c), device=dev)
        plan = mn.instance_plan(shape, torch.bfloat16, mn.card_sms(dev))
        stream = torch.cuda.current_stream().cuda_stream
        tag = f"instance {list(shape)} {plan.variant} tile {plan.tile} x{plan.cluster}"
        if plan.variant == "grid":
            part = torch.empty(2 * b * plan.cluster * c, device=dev)
            phases(tag, lib, lambda: lib.modnorm_instance_grid(
                x.data_ptr(), None, out.data_ptr(), part.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), b, h * w, c, plan.tile, plan.cluster, plan.smem_bytes, 1e-5, 1,
                1, mn.LRELU_SLOPE, stream), plan.grid[0] * plan.grid[1], grid_names)
        else:
            phases(tag, lib, lambda: lib.modnorm_instance(
                x.data_ptr(), None, out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b, h * w,
                c, plan.tile, plan.cluster, plan.smem_bytes, int(plan.variant == "streaming"),
                plan.register_vectors, 1e-5, 1, 1, mn.LRELU_SLOPE, stream),
                plan.grid[0] * plan.grid[1], cluster_names)


def split_phases(workdir: str, gen) -> None:
    """K1's instance-split statistics launches at three stripes of the
    spatial step (split_kernels_in_turns.SHAPES: the largest, a middle and
    the smallest), bf16, their chosen plans."""
    lib = build("modnorm", workdir)
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.modnorm_instance_partials.argtypes = [p, p, i32, i32, i32, i64, i32, i32, i32, i32, i32,
                                              p]
    lib.modnorm_instance_backward_sums.argtypes = [p, p, p, p, p, p, i32, i64, i32, i32, i32,
                                                   i32, i32, i32, f32, p]
    dev = torch.device("cuda")
    names = ["start", "first group", "P", "streamed", "block sums", "cluster barrier",
             "rank 0 done", "end"]
    for shape in [(2, 256, 128, 256), (4, 64, 64, 129), (4, 128, 16, 33)]:
        b, c, h, w = shape
        x = cs._kernel_inputs(shape, False, torch.bfloat16, gen)[0]
        g = cs._kernel_inputs(shape, False, torch.bfloat16, gen)[0]
        stats = torch.empty((2, 3, b, c), device=dev)
        mean, rstd = torch.zeros((b, c), device=dev), torch.ones((b, c), device=dev)
        sums = torch.empty((2, b, c), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        plan = mn.split_plan(shape, torch.bfloat16)
        phases(f"partials {list(shape)} tile {plan.tile} x{plan.cluster}", lib,
               lambda: lib.modnorm_instance_partials(x.data_ptr(), stats.data_ptr(), 0, 2, b,
                                                     h * w, c, plan.tile, plan.cluster,
                                                     plan.smem_bytes, 1, stream),
               plan.grid[0] * plan.grid[1], names)
        phases(f"sums {list(shape)} tile {plan.tile} x{plan.cluster}", lib,
               lambda: lib.modnorm_instance_backward_sums(
                   x.data_ptr(), None, g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                   sums.data_ptr(), b, h * w, c, plan.tile, plan.cluster, plan.smem_bytes, 1, 1,
                   mn.LRELU_SLOPE, stream), plan.grid[0] * plan.grid[1], names)


def tp_phases(workdir: str, gen) -> None:
    """(b)'s launches under a shard, smoothing, at each block shape of one
    rank's tensor-parallel int8 call: the redesigned column maxima and
    scales (`int8_weight_column_maxima`, `int8_weight_scales`) where the
    library has them, else the earlier modes of `quantize_weight_kernel`
    (`int8_quantize_weight_split`, modes 1-4)."""
    import tp_weight_kernels_in_turns as tpk

    lib = build("int8conv", workdir)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    redesigned = hasattr(lib, "int8_weight_scales")
    if redesigned:
        lib.int8_weight_column_maxima.argtypes = [p, p] + [i32] * 5 + [p]
        lib.int8_weight_scales.argtypes = [i32] + [p] * 10 + [i32] * 6 + [p]
        if hasattr(ic, "row_maxima_plan"):  # the row maxima's own kernel, the folded parts
            lib.int8_weight_row_maxima.argtypes = [p] * 5 + [i32] * 9 + [p]
            lib.int8_weight_scales.argtypes = [i32] + [p] * 10 + [i32] * 7 + [p]
        else:
            lib.int8_weight_row_maxima.argtypes = [p] * 6 + [i32] * 6 + [p]
    else:
        lib.int8_quantize_weight_split.argtypes = [i32] + [p] * 9 + [i32] * 6 + [p]
    dev = torch.device("cuda")
    names = ["start", "column maxima", "grid barrier", "s_c", "s_x", "row maxima", "end",
             "loaded", "merged", "cluster merged"]
    stream = torch.cuda.current_stream().cuda_stream
    sms = mn.card_sms(dev)
    for role, wshape, _ in tpk.BLOCKS:
        cout, cin, kh, kw = wshape
        taps, cp = kh * kw, ic.padded_channels(cin)
        w = torch.randn(wshape, generator=gen, device=dev) * 0.05
        mx_raw, mx = ic.absmax_channels_plain(torch.randn((2, cin, 5, 6), generator=gen,
                                                          device=dev))
        s_c, s_k = torch.rand(cin, device=dev) + 0.5, torch.empty(cout, device=dev)
        s_x = torch.empty((), device=dev)
        k_q = torch.empty((cout, kh, kw, cp), dtype=torch.int8, device=dev)
        mk = ic.weight_column_maxima_plain(w)
        bits = torch.empty(cin, dtype=torch.int32, device=dev)
        maxima = torch.rand(cout + 1, device=dev) + 0.1
        plan = ic.weight_plan(cout, cin, taps, True, sms)
        ptr = [t.data_ptr() for t in (w, mx, mx_raw, s_c, s_k, s_x, k_q)]

        def split(mode, scratch=mk):
            return lambda: lib.int8_quantize_weight_split(
                mode, *ptr, scratch.data_ptr(), maxima.data_ptr(), cout, cin, cp, taps, 1,
                plan.grid, stream)

        def scales(columns: bool):
            sp = ic.scales_plan(cout, cin, taps, sms)
            parts = (1,) if hasattr(ic, "row_maxima_plan") else ()  # one row of maxima
            return lambda: lib.int8_weight_scales(
                int(columns), w.data_ptr(), mx.data_ptr(), mx_raw.data_ptr(), mk.data_ptr(),
                s_c.data_ptr(), maxima.data_ptr(), s_c.data_ptr() if columns else None,
                s_k.data_ptr(), s_x.data_ptr(), k_q.data_ptr(), cout, cin, cp, taps, *parts,
                sp.grid, sp.smem, stream), sp.grid

        if redesigned and role == "column":
            cplan = ic.column_maxima_plan(cin, taps, sms)
            out = torch.empty(cin, device=dev)
            phases(f"column maxima {list(wshape)}", lib,
                   lambda: lib.int8_weight_column_maxima(w.data_ptr(), out.data_ptr(), cout, cin,
                                                         taps, cplan.grid, cplan.columns, stream),
                   cplan.grid, names)
            launch, grid = scales(True)
            phases(f"column scales {list(wshape)}", lib, launch, grid, names)
        elif redesigned and hasattr(ic, "row_maxima_plan"):
            rplan = ic.row_maxima_plan(cout, cin, taps)
            parts = torch.empty((rplan.parts, cout + 1), device=dev)
            phases(f"row maxima {list(wshape)} {rplan.grid} blocks of {rplan.columns} columns, "
                   f"clusters of {rplan.cluster}", lib, lambda: lib.int8_weight_row_maxima(
                       w.data_ptr(), mx.data_ptr(), mx_raw.data_ptr(), s_c.data_ptr(),
                       parts.data_ptr(), cout, cin, taps, 1, rplan.grid, rplan.columns,
                       rplan.cluster, rplan.vec, rplan.smem, stream), rplan.grid, names)
            launch, grid = scales(False)
            phases(f"row scales {list(wshape)}", lib, launch, grid, names)
        elif redesigned:
            phases(f"row maxima {list(wshape)}", lib, lambda: lib.int8_weight_row_maxima(
                w.data_ptr(), mx.data_ptr(), mx_raw.data_ptr(), s_c.data_ptr(), bits.data_ptr(),
                maxima.data_ptr(), cout, cin, cp, taps, 1, plan.grid, stream), plan.grid, names)
            launch, grid = scales(False)
            phases(f"row scales {list(wshape)}", lib, launch, grid, names)
        elif role == "column":
            phases(f"column maxima {list(wshape)}", lib, split(1), plan.grid, names)
            phases(f"column scales {list(wshape)}", lib, split(2), plan.grid, names)
        else:
            phases(f"row maxima {list(wshape)}", lib, split(3), plan.grid, names)
            phases(f"row scales {list(wshape)}", lib, split(4), plan.grid, names)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    with tempfile.TemporaryDirectory() as workdir:
        if "--tp-only" in sys.argv:
            tp_phases(workdir, gen)
        else:
            if "--split-only" not in sys.argv:
                weight_phases(workdir, gen)
                instance_phases(workdir, gen)
            split_phases(workdir, gen)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
