"""`modnorm`: normalize -> modulate -> leaky ReLU in one kernel launch.

The epilogue of every SPADE/SEAN norm block and the encoder's instance norm:

    out = lrelu?( norm(x) * mod[:, :C] + mod[:, C:] )

norm(x) is either the eval-mode batch norm from running statistics
(stats="affine", the generator's main path) or the instance norm over H*W
(stats="instance").  In training, `modnorm_train` takes the statistics from
the batch (stats="batch": per channel over N*H*W; stats="instance"), returns
them beside the output, and has a gradient whose backward is a kernel too
(`modnorm_backward`).  `mod` is the 2C-channel modulation-conv output as the
conv returns it (scale first, its +1 already in the conv bias); mod=None
means scale 1 and offset 0.

`modnorm` is the registered custom op `torch.ops.deepsee.modnorm`, so a
program exported with `torch.export` keeps it as one node.  On a CUDA
tensor the op launches the hand-written kernel in
deepsee_torch/csrc/modnorm.cu (the port of the TPU kernel
modulated_instance_norm) or raises; on a CPU tensor it computes
`modnorm_plain`, the same float32 arithmetic in eager torch.  There is no
fallback from one to the other.  Importing this module registers the op.

The launches are planned here, by shape, before the launch.  The instance
mode and its backward (`instance_plan`, `instance_backward_plan`): each
(sample, channel tile) slab is split along H*W over the blocks of a
thread-block cluster, which either hold their chunks in shared memory
("on-chip": each tensor is read from device memory once) or stream them
("streaming", for slabs too large for that).  The batch
forward (`batch_plan`): one cooperative grid of at most the blocks the card
holds at once, each block a channel tile over a run of the N*H*W pixels,
kept in shared memory across the grid barrier where it fits.

Across ranks (data parallelism) `SyncModnormTrain` splits the batch modes
around an all-reduce: the forward into its statistics launch and a merge-
and-apply launch, the backward into its sums and its elementwise pass
(section "training across ranks" below).  Under spatial sharding, where each
rank holds a stripe of every sample, `SplitInstanceModnorm` splits the
instance mode the same way, with one statistics set per sample.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

import torch.distributed as dist

from deepsee_torch.ops import _build
from deepsee_torch.ops.norms import instance_norm_2d

__all__ = ["modnorm", "modnorm_plain", "launches", "reset_launches",
           "InstancePlan", "INSTANCE_VARIANTS", "instance_plan",
           "instance_chunks", "check_instance_plan",
           "clusters_in_flight", "modnorm_train", "modnorm_train_plain",
           "modnorm_backward", "modnorm_backward_plain", "ReducePlan", "reduce_plan",
           "BatchPlan", "batch_plan", "check_batch_plan", "batch_blocks_per_sm", "card_sms",
           "instance_backward_plan", "check_instance_backward_plan", "layout_copies",
           "modnorm_batch_partials", "modnorm_batch_partials_plain", "modnorm_batch_apply",
           "modnorm_batch_apply_plain", "merge_partials", "modnorm_backward_sums",
           "modnorm_backward_sums_plain", "modnorm_backward_apply",
           "modnorm_backward_apply_plain", "SyncModnormTrain", "modnorm_train_sync",
           "instance_partials_plan", "instance_reduce_plan", "modnorm_instance_partials",
           "modnorm_instance_partials_plain", "modnorm_instance_apply",
           "modnorm_instance_apply_plain", "modnorm_instance_backward_sums",
           "modnorm_instance_backward_sums_plain", "modnorm_instance_backward_apply",
           "modnorm_instance_backward_apply_plain", "SplitInstanceModnorm"]

LRELU_SLOPE = 0.2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per mode; each wrapper adds one where it launches its
# kernels and nowhere else, so a caller can show that a run went through
# them.  "batch" is the training forward with batch statistics (one
# cooperative launch), "instance_train" the instance kernel with its
# statistics written out, "backward_batch" the batch backward (reduction,
# then the elementwise pass), "backward_instance" the instance backward (one
# cluster launch).  Across ranks the batch modes split around a collective
# (SyncModnormTrain): "batch_partials" the statistics launch (A),
# "batch_apply" the merge and apply (B), "backward_sums" the batch
# backward's reduction, "backward_apply" its elementwise pass; the instance
# mode across stripes (SplitInstanceModnorm) likewise: "instance_partials",
# "instance_apply", "instance_backward_sums", "instance_backward_apply".
launches = {"affine": 0, "instance": 0, "batch": 0, "instance_train": 0,
            "backward_batch": 0, "backward_instance": 0, "batch_partials": 0,
            "batch_apply": 0, "backward_sums": 0, "backward_apply": 0,
            "instance_partials": 0, "instance_apply": 0, "instance_backward_sums": 0,
            "instance_backward_apply": 0}
# Incoming gradients the backward had to copy into channels_last first.
layout_copies = {"backward": 0}


def reset_launches() -> None:
    for mode in launches:
        launches[mode] = 0
    layout_copies["backward"] = 0


# The launch plans.  Hopper (H100 SXM): 132 SMs (the batch forward, whose
# grid must be resident at once, is sized by the card's own count) with 233,472
# bytes of shared memory each, of which a block may use 232,448 and the
# kernel's static arrays take under STATIC_SMEM (the runtime keeps 1 KB more
# per block); a cluster holds at most 16 blocks (above 8 as a non-portable
# size).  THREADS and REG_VECTORS are the kernel's kThreads and kRegVectors.
SMS = 132
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
STATIC_SMEM = 6144
TWO_BLOCKS_SMEM = SMEM_PER_SM // 2 - STATIC_SMEM - 1024  # the most for 2 blocks per SM
THREADS = 256
REG_VECTORS = 8
MAX_CLUSTER = 16
SECTOR = 32                   # bytes: the channel tile, one sector of a pixel
LINE = 128                    # bytes: the widest (streaming) tile, one cache line
WIDE_SLAB = 256 * 1024        # bytes: slabs up to this take a two-sector tile
WIDE_SLABS = 64               # ... where there are at least this many slabs of it
CHUNK_TARGET = 64 * 1024      # bytes per block, so that 3 blocks share an SM
# The least blocks per slab of the on-chip variant (more where the slabs are
# few: at least SLAB_BLOCKS blocks in all, at most FEW_SLABS_CLUSTER per slab)
MIN_CLUSTER = 2
SLAB_BLOCKS = 64
FEW_SLABS_CLUSTER = 4
# The grid variant, for slabs larger than GRID_SLAB at a two-sector tile
# (H*W > 8192: the training trunks' 128^2 and 256^2 shapes; at 65^2 the
# cluster variant measured faster)
GRID_SLAB = 2 * WIDE_SLAB
# A grid run sums at most this many 16-byte vectors (256 per
# thread); at 1,024 per thread a 256^2 slab's mean measured 1.3e-5 off
GRID_RUN_VECTORS = 256 * THREADS
# ... and keeps at least this share of x in shared memory
GRID_RESIDENT_SHARE = 0.75


INSTANCE_VARIANTS = ("on-chip", "streaming", "grid")


@dataclasses.dataclass(frozen=True)
class InstancePlan:
    """The instance forward's launch.  "on-chip" and "streaming" split each
    slab over a thread-block cluster; "grid" is the batch forward's kernel
    over the N samples' sets: `cluster` blocks (runs) along each slab, their
    partials merged across one grid barrier of a cooperative launch (none
    where a slab is one run), each run's first smem_bytes / (tile * esize)
    pixels kept in shared memory and the rest streamed and read again."""
    variant: str              # "on-chip", "streaming" or "grid"
    tile: int                 # channels per slab: 16 to 128 bytes of a pixel
    cluster: int              # blocks per slab, split along H*W
    pixels_per_cta: int       # the largest chunk of a slab one block takes
    smem_bytes: int           # dynamic shared memory per block
    register_vectors: int     # on-chip: 16-byte vectors per thread held in registers
    grid: Tuple[int, int]     # (cluster * C / tile, B)


def instance_chunks(hw: int, cluster: int) -> List[Tuple[int, int]]:
    """The [start, end) pixels of each cluster rank, as the kernel computes
    them: sizes differ by at most one, and none is empty while cluster <= hw.
    The batch forward splits N*H*W into its runs the same way."""
    return [(r * hw // cluster, (r + 1) * hw // cluster) for r in range(cluster)]


def _layout(shape: Tuple[int, int, int, int], esize: int, tile: int,
            variant: str) -> InstancePlan:
    """The cluster split of `variant` with `tile` channels per slab: the
    least split of H*W that (a) fits a chunk in a block's shared memory
    (on-chip), (b) keeps on-chip chunks near 64 KB, so that several blocks
    per SM overlap their loads, arithmetic and stores, and (c) has at least
    MIN_CLUSTER blocks a slab, up to FEW_SLABS_CLUSTER where fewer than
    SLAB_BLOCKS blocks would run (the H100's training shapes: the
    discriminator's and the mini trunk's small slabs ran fastest in
    clusters of 2, the fewest slabs in clusters of 4, and lost to a wave of
    132 blocks' larger clusters); at most 16 blocks and H*W.  An on-chip
    chunk too large for two blocks per SM keeps REG_VECTORS vectors per
    thread (32 KB per block) in registers and the rest in shared memory."""
    b, c, h, w = shape
    hw, pixel_bytes = h * w, tile * esize
    if variant == "on-chip":
        fit = math.ceil(hw / ((SMEM_PER_BLOCK - STATIC_SMEM) // pixel_bytes))
        near = math.ceil(hw * pixel_bytes / CHUNK_TARGET)
        least = min(FEW_SLABS_CLUSTER,
                    max(MIN_CLUSTER, math.ceil(SLAB_BLOCKS / (b * c // tile))))
        cluster = min(MAX_CLUSTER, hw, max(fit, near, least))
    else:
        cluster = min(MAX_CLUSTER, hw)
    return _split(shape, esize, tile, variant, cluster)


def _split(shape: Tuple[int, int, int, int], esize: int, tile: int, variant: str,
           cluster: int) -> InstancePlan:
    """The plan of `variant` with `tile` channels per slab split over
    `cluster` blocks: an on-chip chunk too large for two blocks per SM
    keeps REG_VECTORS vectors per thread in registers."""
    b, c, h, w = shape
    pixels, pixel_bytes = math.ceil(h * w / cluster), tile * esize
    smem, regs = (pixels * pixel_bytes if variant == "on-chip" else 0), 0
    if smem > TWO_BLOCKS_SMEM:
        regs = REG_VECTORS
        smem = _smem_beyond_registers(pixels, pixel_bytes, regs)
    return InstancePlan(variant, tile, cluster, pixels, smem, regs, (cluster * c // tile, b))


def _grid_plan(shape: Tuple[int, int, int, int], esize: int, tile: int,
               sms: int) -> Optional[InstancePlan]:
    """The grid variant at `tile`, or None where the cluster variants serve:
    slabs of GRID_SLAB or less; or where the runs that fill the card's blocks
    (BATCH_BLOCKS_PER_SM on each SM, no run longer than GRID_RUN_VECTORS)
    would keep less than GRID_RESIDENT_SHARE of x on chip (the inference
    batch's trunks at 128^2 and above).  Runs of about CHUNK_TARGET bytes,
    as many as the card holds at once."""
    b, c, h, w = shape
    hw, pixel_bytes = h * w, tile * esize
    if hw * pixel_bytes <= GRID_SLAB:
        return None
    fill = BATCH_BLOCKS_PER_SM * sms // (b * c // tile)
    runs = min(fill, math.ceil(hw * pixel_bytes / CHUNK_TARGET), hw)
    if runs < math.ceil(hw * pixel_bytes // 16 / GRID_RUN_VECTORS):
        return None
    plan = _grid_split(shape, esize, tile, runs)
    resident = plan.smem_bytes // pixel_bytes
    kept = sum(min(e - s, resident) for s, e in instance_chunks(hw, runs))
    return plan if kept >= GRID_RESIDENT_SHARE * hw else None


def _grid_split(shape: Tuple[int, int, int, int], esize: int, tile: int,
                runs: int) -> InstancePlan:
    """The grid variant with `tile` channels per slab cut into `runs` runs:
    each run's first pixels, as many as a block's share of the SM's shared
    memory holds at two blocks per SM, stay on chip."""
    b, c, h, w = shape
    pixels, pixel_bytes = math.ceil(h * w / runs), tile * esize
    resident = min(pixels, _batch_room(BATCH_BLOCKS_PER_SM) // pixel_bytes)
    return InstancePlan("grid", tile, runs, pixels, resident * pixel_bytes, 0,
                        (runs * c // tile, b))


def _instance_candidates(shape: Tuple[int, int, int, int], dtype: torch.dtype, variant: str,
                         tile: int, clusters) -> List[InstancePlan]:
    """The plans of `variant` at `tile` for each cluster size (runs per slab
    for "grid") in `clusters` that H*W allows (unchecked:
    `check_instance_plan` says which the kernel takes).  For the tests and
    scripts/instance_plans.py, which times them; `instance_plan` chooses."""
    esize = torch.finfo(dtype).bits // 8
    split = (lambda k: _grid_split(shape, esize, tile, k)) if variant == "grid" else (
        lambda k: _split(shape, esize, tile, variant, k))
    return [split(k) for k in clusters if k <= shape[2] * shape[3]]


def _smem_beyond_registers(pixels: int, pixel_bytes: int, regs: int) -> int:
    """Shared memory for a chunk of `pixels` whose first `regs` vectors per
    thread stay in registers: the kernel's slots tid + (k - regs) * THREADS,
    or the whole chunk where regs is 0."""
    if regs == 0:
        return pixels * pixel_bytes
    per_thread = math.ceil(pixels * pixel_bytes // 16 / THREADS)
    return max(0, per_thread - regs) * THREADS * 16


def _fits_on_chip(shape: Tuple[int, int, int, int], esize: int, tile: int) -> bool:
    most_pixels = (SMEM_PER_BLOCK - STATIC_SMEM) // (tile * esize)
    return shape[2] * shape[3] <= MAX_CLUSTER * most_pixels


def instance_plan(shape: Tuple[int, int, int, int], dtype: torch.dtype,
                  sms: int = SMS) -> InstancePlan:
    """The instance mode's launch for x of `shape` (B, C, H, W) and `dtype`
    on a card of `sms` SMs.

    A slab is one sample's `tile` channels over H*W.  Where the slab at a
    two-sector tile (64 bytes of a pixel) exceeds GRID_SLAB (H*W > 8192)
    and the batch's slabs are few enough that the card's blocks keep
    GRID_RESIDENT_SHARE of x in shared memory, the grid variant
    (`_grid_plan`: the training batch's 128^2 and 256^2 trunk shapes).
    Otherwise the slab's pixels split over the blocks of one cluster
    (`_layout`), at one 32-byte sector of a pixel (16 bf16 or 8 float32
    channels; 16 bytes where C forces it), or two sectors where the slab
    stays within WIDE_SLAB and there are WIDE_SLABS slabs of it or more;
    on-chip where a cluster's shared memory holds the slab, otherwise
    streaming, at the widest tile up to a 128-byte line."""
    b, c, h, w = shape
    esize = _check_shape(shape, dtype)
    if b > 65535:
        raise ValueError("modnorm: instance mode takes at most 65535 samples")
    wide = _widest(c, esize, 2 * SECTOR, SECTOR, SECTOR // 2)
    grid = _grid_plan(shape, esize, wide, sms)
    if grid is not None:
        return grid
    sector = _widest(c, esize, SECTOR, SECTOR // 2)
    if _fits_on_chip(shape, esize, sector):
        tile = sector
        if h * w * wide * esize <= WIDE_SLAB and b * c // wide >= WIDE_SLABS:
            tile = wide
        return _layout(shape, esize, tile, "on-chip")
    return _layout(shape, esize, _widest(c, esize, LINE, 2 * SECTOR, SECTOR, SECTOR // 2),
                   "streaming")


def _check_shape(shape: Tuple[int, int, int, int], dtype: torch.dtype) -> int:
    """Raise ValueError unless the kernels take x of `shape` and `dtype`;
    return the element size in bytes."""
    b, c, h, w = shape
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"modnorm: dtype must be float32 or bfloat16, got {dtype}")
    if c % 8 or c < 8 or b < 1 or h * w < 1:
        raise ValueError(f"modnorm: x must be (B, C, H, W) with C % 8 == 0, got {shape}")
    return torch.finfo(dtype).bits // 8


def _widest(c: int, esize: int, *sizes: int) -> int:
    """The channel tile: the channels in the first of `sizes` (bytes of a
    pixel) that holds at least 8 channels and divides C."""
    return next(n // esize for n in sizes if n // esize >= 8 and c % (n // esize) == 0)


def check_instance_plan(plan: InstancePlan, shape: Tuple[int, int, int, int],
                        dtype: torch.dtype, sms: int = SMS) -> None:
    """Raise ValueError unless the kernel can take `plan` for x of `shape`
    on a card of `sms` SMs."""
    esize = torch.finfo(dtype).bits // 8
    if plan.variant == "grid":
        _check_grid_plan(plan, shape, dtype, sms)
        return
    on_chip = plan.variant == "on-chip"
    problems = []
    if plan.register_vectors not in ((0, REG_VECTORS) if on_chip else (0,)):
        problems.append(f"{plan.register_vectors} vectors per thread in registers")
    elif on_chip and plan.tile >= 1:
        need = _smem_beyond_registers(plan.pixels_per_cta, plan.tile * esize,
                                      plan.register_vectors)
        if plan.smem_bytes != need:
            problems.append(f"{plan.smem_bytes} bytes of shared memory")
    _check_cluster_plan("instance", plan, shape, dtype, problems)


def _check_grid_plan(plan: InstancePlan, shape: Tuple[int, int, int, int],
                     dtype: torch.dtype, sms: int) -> None:
    """The grid variant's checks: a tile the batch kernel takes, 1 to H*W
    runs per slab of ceil(H*W / runs) pixels at most, whole resident pixels
    within two blocks' share of an SM, and, where runs are merged across the
    grid barrier, every block resident at once."""
    b, c, h, w = shape
    esize = torch.finfo(dtype).bits // 8
    problems = []
    pixel_bytes = plan.tile * esize
    if plan.tile < 1 or c % plan.tile or pixel_bytes not in (16, SECTOR, 2 * SECTOR, LINE):
        problems.append(f"tile {plan.tile} for C={c} {dtype}")
    elif tuple(plan.grid) != (plan.cluster * c // plan.tile, b):
        problems.append(f"grid {plan.grid}")
    elif (plan.smem_bytes % pixel_bytes
          or not 0 <= plan.smem_bytes // pixel_bytes <= plan.pixels_per_cta
          or plan.smem_bytes > _batch_room(BATCH_BLOCKS_PER_SM)):
        problems.append(f"{plan.smem_bytes} bytes of shared memory")
    if not 1 <= plan.cluster <= h * w:
        problems.append(f"{plan.cluster} runs per slab")
    elif plan.pixels_per_cta != math.ceil(h * w / plan.cluster):
        problems.append(f"{plan.pixels_per_cta} pixels per block")
    elif plan.tile >= 1 and plan.cluster > 1 and (
            plan.cluster * c // plan.tile * b > BATCH_BLOCKS_PER_SM * sms):
        problems.append(f"{plan.cluster * c // plan.tile * b} blocks across the grid barrier "
                        f"at {BATCH_BLOCKS_PER_SM} per SM on {sms} SMs")
    elif plan.pixels_per_cta * pixel_bytes // 16 > GRID_RUN_VECTORS:
        problems.append(f"runs of {plan.pixels_per_cta} pixels: more than {GRID_RUN_VECTORS} "
                        f"16-byte vectors")
    if plan.register_vectors:
        problems.append(f"{plan.register_vectors} vectors per thread in registers")
    if b > 65535:
        problems.append("more than 65535 samples")
    if problems:
        raise ValueError(f"modnorm: the instance grid kernel cannot take {plan} for "
                         f"{dtype} {tuple(shape)}: {'; '.join(problems)}")


def _check_cluster_plan(kernel: str, plan: InstancePlan, shape: Tuple[int, int, int, int],
                        dtype: torch.dtype, problems: List[str]) -> None:
    """Raise ValueError, with `problems` and those of the split that both
    cluster kernels share, unless there are none."""
    b, c, h, w = shape
    esize = torch.finfo(dtype).bits // 8
    if plan.variant not in ("on-chip", "streaming"):
        problems.append(f"unknown variant {plan.variant!r}")
    if plan.tile < 1 or c % plan.tile or plan.tile * esize not in (16, SECTOR, 2 * SECTOR, LINE):
        problems.append(f"tile {plan.tile} for C={c} {dtype}")
    if not 1 <= plan.cluster <= min(MAX_CLUSTER, h * w):
        problems.append(f"cluster {plan.cluster}")
    elif plan.pixels_per_cta != math.ceil(h * w / plan.cluster):
        problems.append(f"{plan.pixels_per_cta} pixels per block")
    if plan.variant == "streaming" and plan.smem_bytes:
        problems.append(f"{plan.smem_bytes} bytes of shared memory")
    if plan.smem_bytes > SMEM_PER_BLOCK - STATIC_SMEM:
        problems.append(f"{plan.smem_bytes} bytes of shared memory")
    if plan.tile >= 1 and tuple(plan.grid) != (plan.cluster * c // plan.tile, b):
        problems.append(f"grid {plan.grid}")
    if problems:
        raise ValueError(f"modnorm: the {kernel} kernel cannot take {plan} for "
                         f"{dtype} {tuple(shape)}: {'; '.join(problems)}")


def _affine_vectors(mean: torch.Tensor, var: torch.Tensor,
                    eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running stats -> float32 (C,) scale and shift of the eval batch norm."""
    inv = torch.rsqrt(var.float() + eps)
    return inv, -mean.float() * inv


def modnorm_plain(x: torch.Tensor, mod: Optional[torch.Tensor] = None, *,
                  stats: str, mean: Optional[torch.Tensor] = None,
                  var: Optional[torch.Tensor] = None, eps: float = 1e-5,
                  lrelu: bool = False) -> torch.Tensor:
    """Eager-torch version of the kernel: float32 throughout, one rounding."""
    xf = x.float()
    if stats == "affine":
        inv, shift = _affine_vectors(mean, var, eps)
        y = xf * inv[:, None, None] + shift[:, None, None]
    elif stats == "instance":
        y = instance_norm_2d(xf, eps)
    else:
        raise ValueError(f"stats must be 'affine' or 'instance', got {stats!r}")
    if mod is not None:
        c = x.shape[1]
        mf = mod.float()
        y = y * mf[:, :c] + mf[:, c:]
    if lrelu:
        y = torch.where(y >= 0, y, LRELU_SLOPE * y)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("modnorm")
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.modnorm_affine.argtypes = [p, p, p, p, p, i64, i32, i32, i32, f32, p]
    lib.modnorm_affine.restype = ctypes.c_int
    lib.modnorm_instance.argtypes = [p, p, p, p, p, i32, i64, i32, i32, i32, i32, i32, i32,
                                     f32, i32, i32, f32, p]
    lib.modnorm_instance.restype = ctypes.c_int
    lib.modnorm_instance_grid.argtypes = [p, p, p, p, p, p, i32, i64, i32, i32, i32, i32, f32,
                                          i32, i32, f32, p]
    lib.modnorm_instance_grid.restype = ctypes.c_int
    lib.modnorm_instance_clusters.argtypes = [i32, i64, i32, i32, i32, i32, i32, i32, i32,
                                              i32, i32]
    lib.modnorm_instance_clusters.restype = ctypes.c_int
    lib.modnorm_batch_blocks_per_sm.argtypes = [i32, i32, i32, i32, i32]
    lib.modnorm_batch_blocks_per_sm.restype = ctypes.c_int
    lib.modnorm_batch.argtypes = [p, p, p, p, p, p, i64, i32, i32, i32, i32, f32, i32, i32,
                                  f32, p]
    lib.modnorm_batch.restype = ctypes.c_int
    lib.modnorm_backward_instance.argtypes = [p, p, p, p, p, p, p, i32, i64, i32, i32, i32,
                                              i32, i32, i32, i32, f32, p]
    lib.modnorm_backward_instance.restype = ctypes.c_int
    lib.modnorm_backward_batch.argtypes = [p, p, p, p, p, p, p, p, p, i64, i32, i32, i32, i64,
                                           i32, i32, f32, p]
    lib.modnorm_backward_batch.restype = ctypes.c_int
    lib.modnorm_batch_partials.argtypes = [p, p, p, i64, i32, i32, i32, i32, i32, p]
    lib.modnorm_batch_partials.restype = ctypes.c_int
    lib.modnorm_batch_apply.argtypes = [p, p, p, i32, p, p, p, i64, i32, f32, i32, i32, f32, p]
    lib.modnorm_batch_apply.restype = ctypes.c_int
    lib.modnorm_backward_batch_sums.argtypes = [p, p, p, p, p, p, p, i64, i32, i32, i32, i64,
                                                i32, i32, f32, p]
    lib.modnorm_backward_batch_sums.restype = ctypes.c_int
    lib.modnorm_backward_batch_apply.argtypes = [p, p, p, p, p, p, p, p, p, i64, i32, f32, i32,
                                                 i32, f32, p]
    lib.modnorm_backward_batch_apply.restype = ctypes.c_int
    lib.modnorm_instance_partials_blocks_per_sm.argtypes = [i32, i32]
    lib.modnorm_instance_partials_blocks_per_sm.restype = ctypes.c_int
    lib.modnorm_instance_partials.argtypes = [p, p, p, i32, i64, i32, i32, i32, i32, i32, p]
    lib.modnorm_instance_partials.restype = ctypes.c_int
    lib.modnorm_instance_apply.argtypes = [p, p, p, i32, p, p, p, i32, i64, i32, f32, i32, i32,
                                           f32, p]
    lib.modnorm_instance_apply.restype = ctypes.c_int
    lib.modnorm_instance_backward_sums.argtypes = [p, p, p, p, p, p, p, p, i32, i64, i32, i32,
                                                   i32, i64, i32, i32, f32, p]
    lib.modnorm_instance_backward_sums.restype = ctypes.c_int
    lib.modnorm_instance_backward_apply.argtypes = [p, p, p, p, p, p, p, p, i32, i64, i32, f32,
                                                    i32, i32, f32, p]
    lib.modnorm_instance_backward_apply.restype = ctypes.c_int
    return lib


def clusters_in_flight(shape: Tuple[int, int, int, int], dtype: torch.dtype,
                       with_mod: bool, lrelu: bool) -> int:
    """How many clusters of the instance mode's launch for this shape the
    current card holds at once (cudaOccupancyMaxActiveClusters); -1 where the
    query fails or the plan launches no clusters (the grid variant).  A
    measurement aid: the plan does not read it."""
    b, c, h, w = shape
    plan = instance_plan(shape, dtype)
    if plan.variant == "grid":
        return -1
    return _lib().modnorm_instance_clusters(
        b, h * w, c, plan.tile, plan.cluster, plan.smem_bytes,
        int(plan.variant == "streaming"), plan.register_vectors, _DTYPE_CODE[dtype],
        int(with_mod), int(lrelu))


def _check_nhwc(name: str, t: torch.Tensor, device: torch.device,
                dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"modnorm: {name} must be {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"modnorm: {name} must be channels_last contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"modnorm: {name} must be 16-byte aligned")


def modnorm(x: torch.Tensor, mod: Optional[torch.Tensor] = None, *,
            stats: str, mean: Optional[torch.Tensor] = None,
            var: Optional[torch.Tensor] = None, eps: float = 1e-5,
            lrelu: bool = False) -> torch.Tensor:
    """x: (B, C, H, W) channels_last, bf16 or f32; mod: (B, 2C, H, W) of the
    same type and layout, or None; mean/var: (C,) running stats for
    stats="affine".  Returns a new channels_last tensor of x's type.

    Calls the registered op `torch.ops.deepsee.modnorm`, so `torch.export`
    records the op itself (not its plain version) and an exported program
    launches the kernel where it runs on CUDA."""
    if stats not in ("affine", "instance"):
        raise ValueError(f"stats must be 'affine' or 'instance', got {stats!r}")
    if stats == "affine" and (mean is None or var is None):
        raise ValueError("stats='affine' needs the running mean and var")
    return torch.ops.deepsee.modnorm(x, mod, mean, var, stats, eps, lrelu)


@torch.library.custom_op("deepsee::modnorm", mutates_args=())
def _modnorm_op(x: torch.Tensor, mod: Optional[torch.Tensor],
                mean: Optional[torch.Tensor], var: Optional[torch.Tensor],
                stats: str, eps: float, lrelu: bool) -> torch.Tensor:
    """The op's implementation: the plain version on CPU tensors; on CUDA
    tensors the checks, the launch and the launch count, or a raise."""
    if x.device.type == "cpu":
        return modnorm_plain(x, mod, stats=stats, mean=mean, var=var, eps=eps,
                             lrelu=lrelu)
    if x.device.type != "cuda":
        raise ValueError(f"modnorm: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"modnorm: dtype must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] % 8 or x.numel() == 0:
        raise ValueError(f"modnorm: x must be (B, C, H, W) with C % 8 == 0, "
                         f"got {tuple(x.shape)}")
    b, c, h, w = x.shape
    _check_nhwc("x", x, x.device, x.dtype, (b, c, h, w))
    if mod is not None:
        _check_nhwc("mod", mod, x.device, x.dtype, (b, 2 * c, h, w))

    out = torch.empty_like(x, memory_format=torch.channels_last)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    mod_ptr = None if mod is None else mod.data_ptr()
    code = _DTYPE_CODE[x.dtype]
    with torch.cuda.device(x.device):
        if stats == "affine":
            if mean.shape != (c,) or var.shape != (c,):
                raise ValueError(f"modnorm: mean and var must be ({c},)")
            inv, shift = _affine_vectors(mean.to(x.device), var.to(x.device), eps)
            err = _lib().modnorm_affine(x.data_ptr(), mod_ptr, inv.data_ptr(),
                                        shift.data_ptr(), out.data_ptr(), b * h * w,
                                        c, code, int(lrelu), LRELU_SLOPE, stream)
        else:
            err = _launch_instance(x, mod, out, None, None, eps, lrelu, stream)
    if err != 0:
        raise RuntimeError(f"modnorm ({stats}) launch failed with CUDA error {err}")
    launches[stats] += 1
    return out


def _launch_instance(x: torch.Tensor, mod: Optional[torch.Tensor], out: torch.Tensor,
                     mean: Optional[torch.Tensor], rstd: Optional[torch.Tensor], eps: float,
                     lrelu: bool, stream: ctypes.c_void_p) -> int:
    """The instance forward of checked x (and mod) into out, under the plan
    `instance_plan` gives and `check_instance_plan` accepts for the card;
    (mean, rstd) (N, C) receive the statistics where given.  Returns the C
    entry's error code."""
    b, c, h, w = x.shape
    sms = card_sms(x.device)
    plan = instance_plan((b, c, h, w), x.dtype, sms)
    check_instance_plan(plan, (b, c, h, w), x.dtype, sms)
    ptrs = (x.data_ptr(), None if mod is None else mod.data_ptr(), out.data_ptr())
    stats = (None if mean is None else mean.data_ptr(), None if rstd is None else rstd.data_ptr())
    code = _DTYPE_CODE[x.dtype]
    if plan.variant == "grid":
        part = (torch.empty(2 * b * plan.cluster * c, dtype=torch.float32, device=x.device)
                if plan.cluster > 1 else None)
        return _lib().modnorm_instance_grid(
            *ptrs, None if part is None else part.data_ptr(), *stats, b, h * w, c, plan.tile,
            plan.cluster, plan.smem_bytes, eps, code, int(lrelu), LRELU_SLOPE, stream)
    return _lib().modnorm_instance(
        *ptrs, *stats, b, h * w, c, plan.tile, plan.cluster, plan.smem_bytes,
        int(plan.variant == "streaming"), plan.register_vectors, eps, code, int(lrelu),
        LRELU_SLOPE, stream)


@_modnorm_op.register_fake
def _modnorm_fake(x, mod, mean, var, stats, eps, lrelu):
    """Shape, type and layout of the output, for tracing (torch.export)."""
    return torch.empty_like(x, memory_format=torch.channels_last)


# -- training: batch statistics and the backward ------------------------------

TRAIN_STATS = ("batch", "instance")
REDUCE_BLOCKS = 8 * SMS       # one wave of 256-thread blocks, 8 per SM
# The batch forward's aim in blocks per SM; the card's own figure for the
# kernel's registers and shared memory (batch_blocks_per_sm) decides.
BATCH_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    tile: int                 # channels per block: 16 to 128 bytes of a pixel
    runs: int                 # blocks along the N*H*W pixels of each channel tile
    pixels_per_run: int       # the longest run (runs differ by at most one pixel)
    resident_pixels: int      # of a run, the first pixels kept in shared memory
    smem_bytes: int           # dynamic shared memory per block: the resident pixels
    blocks_per_sm: int        # blocks an SM holds at once, as the grid was sized
    sms: int                  # the card's SMs, as the grid was sized
    grid: int                 # runs * C / tile blocks, all resident at once

    @property
    def variant(self) -> str:
        """"on-chip" where every run stays in shared memory (x is read from
        device memory once), else "re-read"."""
        return "on-chip" if self.resident_pixels >= self.pixels_per_run else "re-read"


def _batch_room(blocks_per_sm: int) -> int:
    """Dynamic shared memory per block with `blocks_per_sm` blocks on an SM."""
    return min(SMEM_PER_SM // blocks_per_sm - STATIC_SMEM - 1024,
               SMEM_PER_BLOCK - STATIC_SMEM)


def batch_plan(shape: Tuple[int, int, int, int], dtype: torch.dtype,
               blocks_per_sm: int = BATCH_BLOCKS_PER_SM, sms: int = SMS) -> BatchPlan:
    """The batch forward's cooperative launch for x of `shape` (B, C, H, W)
    on a card of `sms` SMs (`card_sms`; the H100 SXM's 132 by default):
    the widest channel tile up to a 128-byte line of a pixel; as many runs of
    the P = N*H*W pixels per tile as fill the `blocks_per_sm` * `sms` blocks
    the card holds at once (none shorter than one 16-byte vector per
    thread); and each run's first pixels, as many as a block's share of the
    SM's shared memory holds, kept there across the grid barrier."""
    b, c, h, w = shape
    esize = _check_shape(shape, dtype)
    tile = _widest(c, esize, LINE, 2 * SECTOR, SECTOR, SECTOR // 2)
    tiles, capacity = c // tile, blocks_per_sm * sms
    if blocks_per_sm < 1 or tiles > capacity:
        raise ValueError(f"modnorm: the batch forward holds at most {capacity} channel tiles "
                         f"of {tile} at once, got C={c}")
    p, pixel_bytes = b * h * w, tile * esize
    runs = max(1, min(capacity // tiles, math.ceil(p / (THREADS // (pixel_bytes // 16)))))
    pixels = math.ceil(p / runs)
    resident = min(pixels, _batch_room(blocks_per_sm) // pixel_bytes)
    return BatchPlan(tile, runs, pixels, resident, resident * pixel_bytes, blocks_per_sm, sms,
                     runs * tiles)


def check_batch_plan(plan: BatchPlan, shape: Tuple[int, int, int, int],
                     dtype: torch.dtype) -> None:
    """Raise ValueError unless the batch forward can take `plan` for x of
    `shape`: every run nonempty, the grid within the blocks the card holds
    at once (`blocks_per_sm` on each of its `sms` SMs)."""
    b, c, h, w = shape
    esize = torch.finfo(dtype).bits // 8
    p = b * h * w
    problems = []
    if plan.tile < 1 or c % plan.tile or plan.tile * esize not in (16, SECTOR, 2 * SECTOR, LINE):
        problems.append(f"tile {plan.tile} for C={c} {dtype}")
    elif plan.grid != plan.runs * c // plan.tile:
        problems.append(f"grid {plan.grid}")
    if not 1 <= plan.runs <= p:
        problems.append(f"{plan.runs} runs of {p} pixels")
    elif plan.pixels_per_run != math.ceil(p / plan.runs):
        problems.append(f"{plan.pixels_per_run} pixels per run")
    if not 1 <= plan.blocks_per_sm or plan.grid > plan.blocks_per_sm * plan.sms:
        problems.append(f"{plan.grid} blocks at {plan.blocks_per_sm} per SM")
    elif (not 0 <= plan.resident_pixels <= plan.pixels_per_run
          or plan.smem_bytes != plan.resident_pixels * plan.tile * esize
          or plan.smem_bytes > _batch_room(plan.blocks_per_sm)):
        problems.append(f"{plan.resident_pixels} resident pixels in {plan.smem_bytes} bytes")
    if problems:
        raise ValueError(f"modnorm: the batch forward cannot take {plan} for "
                         f"{dtype} {tuple(shape)}: {'; '.join(problems)}")


@functools.cache
def batch_blocks_per_sm(dtype: torch.dtype, with_mod: bool, lrelu: bool,
                        stats_only: bool = False) -> int:
    """Blocks of the batch forward the current card holds per SM with the
    shared memory its plan gives them (cudaOccupancyMaxActiveBlocksPerMultiprocessor):
    BATCH_BLOCKS_PER_SM where they fit, else fewer.  `stats_only` asks for
    the statistics launch of the cross-rank forward (its own registers)."""
    for n in range(BATCH_BLOCKS_PER_SM, 0, -1):
        if _lib().modnorm_batch_blocks_per_sm(_DTYPE_CODE[dtype], int(with_mod), int(lrelu),
                                              int(stats_only), _batch_room(n)) >= n:
            return n
    raise RuntimeError("modnorm: the card holds no block of the batch forward")


@functools.cache
def card_sms(device: torch.device) -> int:
    """The SMs of the card `device` (the batch forward's grid must fit them
    all at once; the PCIe H100 has 114, the SXM 132)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _backward_smem(pixels: int, lanes: int, tensors: int) -> int:
    """Shared memory of the on-chip instance backward: each tensor's chunk
    in slots tid + k * THREADS, padded to whole rounds of THREADS vectors."""
    return tensors * math.ceil(pixels * lanes / THREADS) * THREADS * 16


def instance_backward_plan(shape: Tuple[int, int, int, int], dtype: torch.dtype,
                           with_mod: bool) -> InstancePlan:
    """The instance backward's cluster launch for x of `shape` (B, C, H, W).

    On-chip where a cluster's blocks hold the slab of x and gout (and mod)
    with two blocks per SM, at a tile of two 32-byte sectors of a pixel for
    slabs of up to 2 * WIDE_SLAB bytes per tensor and of one sector beyond
    (16 bytes where C forces it); split as `_layout` splits the forward's
    (the least split that fits, keeps chunks near CHUNK_TARGET) but filling
    only half the card, since small slabs (the discriminator's) lose more
    to a larger cluster than they gain from more blocks.  Otherwise
    streaming, at the widest tile up to a 128-byte line that still gives
    half as many blocks as the card has SMs: on the H100 the full trunk's
    (4, 32, 256, 256) bf16 streamed faster at a 32-byte tile than on-chip at
    the 16-byte tile its slab would need, one block per SM over several
    waves."""
    b, c, h, w = shape
    esize = _check_shape(shape, dtype)
    if b > 65535:
        raise ValueError("modnorm: instance mode takes at most 65535 samples")
    hw, tensors = h * w, 4 if with_mod else 2
    wide = _widest(c, esize, 2 * SECTOR, SECTOR, SECTOR // 2)
    tiles = [wide] if hw * wide * esize <= 2 * WIDE_SLAB else []
    for tile in dict.fromkeys(tiles + [_widest(c, esize, SECTOR, SECTOR // 2)]):
        lanes = tile * esize // 16
        fit = next((k for k in range(1, min(MAX_CLUSTER, hw) + 1) if _backward_smem(
            math.ceil(hw / k), lanes, tensors) <= TWO_BLOCKS_SMEM), None)
        if fit is None:
            continue
        fill = math.ceil(SMS // 2 / (b * c // tile))
        near = math.ceil(hw * tile * esize * tensors / CHUNK_TARGET)
        cluster = min(MAX_CLUSTER, hw, max(fit, fill, near))
        pixels = math.ceil(hw / cluster)
        return InstancePlan("on-chip", tile, cluster, pixels,
                            _backward_smem(pixels, lanes, tensors), 0,
                            (cluster * c // tile, b))
    cluster = min(MAX_CLUSTER, hw)
    tiles = [t for t in (LINE // esize, 2 * SECTOR // esize, SECTOR // esize, 16 // esize)
             if t >= 8 and c % t == 0]
    tile = next((t for t in tiles if b * c // t * cluster >= SMS // 2), tiles[-1])
    return InstancePlan("streaming", tile, cluster, math.ceil(hw / cluster), 0, 0,
                        (cluster * c // tile, b))


def check_instance_backward_plan(plan: InstancePlan, shape: Tuple[int, int, int, int],
                                 dtype: torch.dtype, with_mod: bool) -> None:
    """Raise ValueError unless the instance backward can take `plan`."""
    esize = torch.finfo(dtype).bits // 8
    problems = []
    if plan.register_vectors:
        problems.append(f"{plan.register_vectors} vectors per thread in registers")
    if plan.variant == "on-chip" and plan.tile >= 1 and plan.smem_bytes != _backward_smem(
            plan.pixels_per_cta, max(1, plan.tile * esize // 16), 4 if with_mod else 2):
        problems.append(f"{plan.smem_bytes} bytes of shared memory")
    _check_cluster_plan("instance backward", plan, shape, dtype, problems)


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    lanes: int                # 8-channel vectors per block: 1, 2, 4 or 8
    chunks: int               # blocks along the pixels
    chunk: int                # pixels per chunk (the last may have fewer)
    grid: Tuple[int, int]     # (chunks, C / (8 * lanes))


def reduce_plan(p: int, c: int) -> ReducePlan:
    """The launch of the batch backward's reduction over `p` = N*H*W pixels
    and `c` channels: the widest channel tile up to 64 channels, and enough
    chunks of the pixels for one wave of blocks, each chunk at least 8
    pixels per thread."""
    if c % 8 or c < 8 or p < 1:
        raise ValueError(f"modnorm: training needs C % 8 == 0 and a nonempty x, got "
                         f"{p} pixels x {c} channels")
    lanes = next(n for n in (8, 4, 2, 1) if (c // 8) % n == 0)
    rows = THREADS // lanes
    groups = c // (8 * lanes)
    chunks = max(1, min(math.ceil(REDUCE_BLOCKS / groups), math.ceil(p / (8 * rows))))
    chunk = math.ceil(p / chunks)
    chunks = math.ceil(p / chunk)
    return ReducePlan(lanes, chunks, chunk, (chunks, groups))


def _set_dims(stats: str) -> Tuple[int, ...]:
    return (0, 2, 3) if stats == "batch" else (2, 3)


def _per_set(v: torch.Tensor, stats: str) -> torch.Tensor:
    """(C,) or (B, C) statistics -> broadcastable against (B, C, H, W)."""
    return v.reshape(-1 if stats == "instance" else 1, v.shape[-1], 1, 1)


def _normalized(xf: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                stats: str) -> torch.Tensor:
    """x_hat with the forward kernels' operations: the affine kernel's
    x * rstd + (-mean * rstd) for batch statistics, the instance kernel's
    (x - mean) * rstd."""
    m, r = _per_set(mean, stats), _per_set(rstd, stats)
    if stats == "batch":
        return xf * r + (-m * r)
    return (xf - m) * r


def _modulate(y: torch.Tensor, mod: Optional[torch.Tensor], lrelu: bool) -> torch.Tensor:
    if mod is not None:
        c = y.shape[1]
        mf = mod.float()
        y = y * mf[:, :c] + mf[:, c:]
    if lrelu:
        y = torch.where(y >= 0, y, LRELU_SLOPE * y)
    return y


def modnorm_train_plain(x: torch.Tensor, mod: Optional[torch.Tensor] = None, *,
                        stats: str, eps: float = 1e-5, lrelu: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eager-torch version of the training forward: float32 two-pass
    statistics and arithmetic, one rounding.  Returns (out, mean, rstd) with
    float32 (C,) statistics for stats="batch" and (B, C) for "instance"."""
    if stats not in TRAIN_STATS:
        raise ValueError(f"stats must be 'batch' or 'instance', got {stats!r}")
    xf = x.float()
    dims = _set_dims(stats)
    mean = xf.mean(dims)
    d = xf - _per_set(mean, stats)
    rstd = torch.rsqrt((d * d).mean(dims) + eps)
    y = _modulate(_normalized(xf, mean, rstd, stats), mod, lrelu)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last), mean, rstd


def modnorm_backward_plain(x: torch.Tensor, mod: Optional[torch.Tensor],
                           gout: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, *,
                           stats: str, lrelu: bool = False
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Eager-torch version of the backward kernels, float32, one rounding:
    grad_x = rstd * (gy - mean_S(gy) - x_hat * mean_S(gy * x_hat)) and
    grad_mod = [gz * x_hat | gz] (None without mod)."""
    xh, gz, gy = _backward_terms(x, mod, gout, mean, rstd, stats, lrelu)
    dims = _set_dims(stats)
    mgy = gy.mean(dims, keepdim=True)
    mgyx = (gy * xh).mean(dims, keepdim=True)
    return _backward_outputs(x, mod, xh, gz, gy, rstd, mgy, mgyx, stats)


def _backward_terms(x, mod, gout, mean, rstd, stats: str, lrelu: bool):
    """x_hat, gz and gy in float32, recomputed with the forward's operations."""
    xf, g = x.float(), gout.float()
    xh = _normalized(xf, mean, rstd, stats)
    z, s = xh, None
    if mod is not None:
        c = x.shape[1]
        mf = mod.float()
        s = mf[:, :c]
        z = xh * s + mf[:, c:]
    gz = torch.where(z >= 0, g, LRELU_SLOPE * g) if lrelu else g
    gy = gz * s if s is not None else gz
    return xh, gz, gy


def _backward_outputs(x, mod, xh, gz, gy, rstd, mgy, mgyx, stats: str):
    """(grad_x, grad_mod or None) from the terms and the set means of gy and
    gy * x_hat, rounded once to the tensors' types."""
    gx = _per_set(rstd, stats) * (gy - mgy - xh * mgyx)
    cl = torch.channels_last
    gx = gx.to(x.dtype).contiguous(memory_format=cl)
    if mod is None:
        return gx, None
    return gx, torch.cat([gz * xh, gz], dim=1).to(mod.dtype).contiguous(memory_format=cl)


def modnorm_train(x: torch.Tensor, mod: Optional[torch.Tensor] = None, *,
                  stats: str, eps: float = 1e-5, lrelu: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training forward: (out, mean, rstd), the statistics float32 (C,)
    for stats="batch" and (B, C) for "instance"; differentiable in x and mod
    (the statistics are not), with `modnorm_backward` as its backward.

    Calls the registered op `torch.ops.deepsee.modnorm_train`.  Under
    torch.no_grad it runs the forward alone; the caller updates running
    statistics from the returned vectors."""
    if stats not in TRAIN_STATS:
        raise ValueError(f"stats must be 'batch' or 'instance', got {stats!r}")
    return torch.ops.deepsee.modnorm_train(x, mod, stats, eps, lrelu)


def modnorm_backward(x: torch.Tensor, mod: Optional[torch.Tensor], gout: torch.Tensor,
                     mean: torch.Tensor, rstd: torch.Tensor, *, stats: str,
                     lrelu: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(grad_x, grad_mod) of `modnorm_train` for the incoming gradient
    `gout` (channels_last, x's type); grad_mod is None without mod."""
    if stats not in TRAIN_STATS:
        raise ValueError(f"stats must be 'batch' or 'instance', got {stats!r}")
    gx, gmod = torch.ops.deepsee.modnorm_backward(x, mod, gout, mean, rstd, stats, lrelu)
    return gx, (gmod if mod is not None else None)


def _check_train(x: torch.Tensor, mod: Optional[torch.Tensor]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"modnorm: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"modnorm: dtype must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] % 8 or x.numel() == 0:
        raise ValueError(f"modnorm: x must be (B, C, H, W) with C % 8 == 0, "
                         f"got {tuple(x.shape)}")
    b, c, h, w = x.shape
    _check_nhwc("x", x, x.device, x.dtype, (b, c, h, w))
    if mod is not None:
        _check_nhwc("mod", mod, x.device, x.dtype, (b, 2 * c, h, w))


def _stats_shape(x: torch.Tensor, stats: str) -> Tuple[int, ...]:
    return (x.shape[1],) if stats == "batch" else (x.shape[0], x.shape[1])


@torch.library.custom_op("deepsee::modnorm_train", mutates_args=())
def _modnorm_train_op(x: torch.Tensor, mod: Optional[torch.Tensor], stats: str,
                      eps: float, lrelu: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training forward: the plain version on CPU tensors; on CUDA the
    checks, the launches and the launch count, or a raise."""
    if x.device.type == "cpu":
        return modnorm_train_plain(x, mod, stats=stats, eps=eps, lrelu=lrelu)
    _check_train(x, mod)
    b, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    f32 = dict(dtype=torch.float32, device=x.device)
    mean = torch.empty(_stats_shape(x, stats), **f32)
    rstd = torch.empty(_stats_shape(x, stats), **f32)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    mod_ptr = None if mod is None else mod.data_ptr()
    code = _DTYPE_CODE[x.dtype]
    with torch.cuda.device(x.device):
        if stats == "batch":
            plan = batch_plan((b, c, h, w), x.dtype,
                              batch_blocks_per_sm(x.dtype, mod is not None, lrelu),
                              card_sms(x.device))
            check_batch_plan(plan, (b, c, h, w), x.dtype)
            part = torch.empty(2 * plan.runs * c, **f32)
            err = _lib().modnorm_batch(
                x.data_ptr(), mod_ptr, out.data_ptr(), part.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), b * h * w, c, plan.tile, plan.runs, plan.smem_bytes, eps,
                code, int(lrelu), LRELU_SLOPE, stream)
        else:
            err = _launch_instance(x, mod, out, mean, rstd, eps, lrelu, stream)
    if err != 0:
        raise RuntimeError(f"modnorm_train ({stats}) launch failed with CUDA error {err}")
    launches["batch" if stats == "batch" else "instance_train"] += 1
    return out, mean, rstd


@_modnorm_train_op.register_fake
def _modnorm_train_fake(x, mod, stats, eps, lrelu):
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty_like(x, memory_format=torch.channels_last),
            torch.empty(_stats_shape(x, stats), **f32),
            torch.empty(_stats_shape(x, stats), **f32))


@torch.library.custom_op("deepsee::modnorm_backward", mutates_args=())
def _modnorm_backward_op(x: torch.Tensor, mod: Optional[torch.Tensor], gout: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor, stats: str, lrelu: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward: the plain version on CPU tensors; on CUDA the checks,
    the launches and the launch count, or a raise.  grad_mod is an empty
    tensor where there is no mod."""
    if x.device.type == "cpu":
        gx, gmod = modnorm_backward_plain(x, mod, gout, mean, rstd, stats=stats, lrelu=lrelu)
        return gx, (gmod if gmod is not None else x.new_empty(0))
    _check_train(x, mod)
    b, c, h, w = x.shape
    _check_nhwc("gout", gout, x.device, x.dtype, (b, c, h, w))
    for name, v in (("mean", mean), ("rstd", rstd)):
        if (v.device != x.device or v.dtype != torch.float32
                or tuple(v.shape) != _stats_shape(x, stats) or not v.is_contiguous()):
            raise ValueError(f"modnorm: {name} must be contiguous float32 "
                             f"{_stats_shape(x, stats)} on {x.device}")
    f32 = dict(dtype=torch.float32, device=x.device)
    gx = torch.empty_like(x, memory_format=torch.channels_last)
    gmod = (torch.empty_like(mod, memory_format=torch.channels_last) if mod is not None
            else x.new_empty(0))
    ptrs = (x.data_ptr(), None if mod is None else mod.data_ptr(), gout.data_ptr(),
            mean.data_ptr(), rstd.data_ptr())
    out_ptrs = (gx.data_ptr(), None if mod is None else gmod.data_ptr())
    code = _DTYPE_CODE[x.dtype]
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        if stats == "batch":
            plan = reduce_plan(b * h * w, c)
            part = torch.empty(2 * plan.chunks * c, **f32)
            coef = torch.empty(2 * c, **f32)
            err = _lib().modnorm_backward_batch(
                *ptrs, part.data_ptr(), coef.data_ptr(), *out_ptrs, b * h * w, c, plan.lanes,
                plan.chunks, plan.chunk, code, int(lrelu), LRELU_SLOPE, stream)
        else:
            plan = instance_backward_plan((b, c, h, w), x.dtype, mod is not None)
            check_instance_backward_plan(plan, (b, c, h, w), x.dtype, mod is not None)
            err = _lib().modnorm_backward_instance(
                *ptrs, *out_ptrs, b, h * w, c, plan.tile, plan.cluster, plan.smem_bytes,
                int(plan.variant == "streaming"), code, int(lrelu), LRELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"modnorm_backward ({stats}) launch failed with CUDA error {err}")
    launches["backward_" + stats] += 1
    return gx, gmod


@_modnorm_backward_op.register_fake
def _modnorm_backward_fake(x, mod, gout, mean, rstd, stats, lrelu):
    return (torch.empty_like(x, memory_format=torch.channels_last),
            torch.empty_like(mod, memory_format=torch.channels_last) if mod is not None
            else x.new_empty(0))


def _train_setup_context(ctx, inputs, output) -> None:
    x, mod, stats, _, lrelu = inputs
    _, mean, rstd = output
    ctx.mark_non_differentiable(mean, rstd)
    ctx.save_for_backward(x, mod, mean, rstd)
    ctx.stats, ctx.lrelu = stats, lrelu


def _train_backward(ctx, gout, _grad_mean, _grad_rstd):
    """Autograd's formula: the backward op on the incoming gradient, which
    autograd may hand over in another layout; it is copied into
    channels_last here, explicitly and counted, never inside the wrapper."""
    x, mod, mean, rstd = ctx.saved_tensors
    if not gout.is_contiguous(memory_format=torch.channels_last):
        gout = gout.contiguous(memory_format=torch.channels_last)
        layout_copies["backward"] += 1
    gx, gmod = torch.ops.deepsee.modnorm_backward(x, mod, gout, mean, rstd, ctx.stats,
                                                  ctx.lrelu)
    return gx, (gmod if mod is not None else None), None, None, None


torch.library.register_autograd("deepsee::modnorm_train", _train_backward,
                                setup_context=_train_setup_context)


# -- training across ranks: the batch modes split around a collective --------
#
# Under data parallelism the batch statistics cover the global batch (the JAX
# package's batch norm under jit over a sharded batch).  A kernel cannot take
# a process group, so each batch mode splits into two registered ops with a
# collective between them, run in Python by SyncModnormTrain: the forward's
# statistics launch (A), an all-reduce of the ranks' (count, mean, M2) rows,
# the merge-and-apply launch (B); the backward's reduction, an all-reduce of
# the [2, C] sums, its elementwise pass.  The collectives run on the current
# stream's order: NCCL's all_reduce waits for the work queued on the current
# stream and makes it wait for the result; gloo's, on CUDA tensors, copies
# through host memory in the same order.  So launch B and the elementwise
# pass read finished sums.  Every rank must hold the same number of rows (a
# global batch's per-rank share), which gives the backward's global count.


def modnorm_batch_partials_plain(x: torch.Tensor) -> torch.Tensor:
    """Eager-torch version of launch A: float32 (3, C) rows of (count, mean,
    centred M2) per channel over x's N*H*W pixels (two passes)."""
    b, c, h, w = x.shape
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    d = xf - mean[:, None, None]
    return torch.stack([torch.full_like(mean, float(b * h * w)), mean, (d * d).sum((0, 2, 3))])


def merge_partials(partials: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(count, mean, M2) per channel of [world, 3, C] rows merged in rank
    order with Chan's formula, as launch B merges them: float32, a row with
    count 0 adds nothing."""
    n = torch.zeros_like(partials[0, 0])
    mean, m2 = torch.zeros_like(n), torch.zeros_like(n)
    for nb, mb, qb in partials.float():
        nn = n + nb
        fb = torch.where(nb > 0, nb / torch.clamp(nn, min=1.0), torch.zeros_like(nb))
        d = mb - mean
        mean = torch.where(nb > 0, mean + d * fb, mean)
        m2 = torch.where(nb > 0, m2 + (qb + d * d * (n * fb)), m2)
        n = nn
    return n, mean, m2


def modnorm_batch_apply_plain(x: torch.Tensor, mod: Optional[torch.Tensor],
                              partials: torch.Tensor, *, eps: float = 1e-5, lrelu: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eager-torch version of launch B: the rows of `partials` ([world, 3, C])
    merged (`merge_partials`), then x normalized with the merged statistics,
    modulated and leaky-ReLU'd as `modnorm_train_plain` does.  Returns (out,
    mean, rstd)."""
    n, mean, m2 = merge_partials(partials)
    rstd = torch.rsqrt(m2 / n + eps)
    y = _modulate(_normalized(x.float(), mean, rstd, "batch"), mod, lrelu)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last), mean, rstd


def modnorm_backward_sums_plain(x: torch.Tensor, mod: Optional[torch.Tensor],
                                gout: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, *,
                                lrelu: bool = False) -> torch.Tensor:
    """Eager-torch version of the backward's reduction across ranks: float32
    (2, C) sums of gy and gy * x_hat over x's N*H*W pixels."""
    xh, _, gy = _backward_terms(x, mod, gout, mean, rstd, "batch", lrelu)
    return torch.stack([gy.sum((0, 2, 3)), (gy * xh).sum((0, 2, 3))])


def modnorm_backward_apply_plain(x: torch.Tensor, mod: Optional[torch.Tensor],
                                 gout: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                                 sums: torch.Tensor, count: float, *, lrelu: bool = False
                                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Eager-torch version of the backward's elementwise pass across ranks:
    (grad_x, grad_mod) from the all-reduced (2, C) `sums` over `count`
    pixels (the world's)."""
    xh, gz, gy = _backward_terms(x, mod, gout, mean, rstd, "batch", lrelu)
    mgy, mgyx = (_per_set(v / count, "batch") for v in sums.float())
    return _backward_outputs(x, mod, xh, gz, gy, rstd, mgy, mgyx, "batch")


def modnorm_batch_partials(x: torch.Tensor, rank: int = 0, world: int = 1) -> torch.Tensor:
    """Launch A: a float32 [world, 3, C] buffer of zeros but for row `rank`,
    x's (count, mean, M2) per channel; the caller all-reduces it (sum)."""
    return torch.ops.deepsee.modnorm_batch_partials(x, rank, world)


def modnorm_batch_apply(x: torch.Tensor, mod: Optional[torch.Tensor], partials: torch.Tensor, *,
                        eps: float = 1e-5, lrelu: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B: (out, mean, rstd) from x, mod and the all-reduced partials."""
    return torch.ops.deepsee.modnorm_batch_apply(x, mod, partials, eps, lrelu)


def modnorm_backward_sums(x: torch.Tensor, mod: Optional[torch.Tensor], gout: torch.Tensor,
                          mean: torch.Tensor, rstd: torch.Tensor, *,
                          lrelu: bool = False) -> torch.Tensor:
    """The backward's reduction: float32 (2, C) sums of gy and gy * x_hat."""
    return torch.ops.deepsee.modnorm_backward_sums(x, mod, gout, mean, rstd, lrelu)


def modnorm_backward_apply(x: torch.Tensor, mod: Optional[torch.Tensor], gout: torch.Tensor,
                           mean: torch.Tensor, rstd: torch.Tensor, sums: torch.Tensor,
                           count: float, *, lrelu: bool = False
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward's elementwise pass from the all-reduced sums over
    `count` pixels: (grad_x, grad_mod), grad_mod None without mod."""
    gx, gmod = torch.ops.deepsee.modnorm_backward_apply(x, mod, gout, mean, rstd, sums,
                                                        float(count), lrelu)
    return gx, (gmod if mod is not None else None)


def _check_stats(name: str, v: torch.Tensor, x: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if (v.device != x.device or v.dtype != torch.float32 or tuple(v.shape) != shape
            or not v.is_contiguous()):
        raise ValueError(f"modnorm: {name} must be contiguous float32 {shape} on {x.device}")


@torch.library.custom_op("deepsee::modnorm_batch_partials", mutates_args=())
def _batch_partials_op(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Launch A: the plain version on CPU tensors; on CUDA the checks, the
    statistics-only cooperative launch and its count, or a raise."""
    if not 0 <= rank < world:
        raise ValueError(f"modnorm: rank {rank} of a world of {world}")
    c = x.shape[1]
    if x.device.type == "cpu":
        out = torch.zeros(world, 3, c, dtype=torch.float32)
        out[rank] = modnorm_batch_partials_plain(x)
        return out
    _check_train(x, None)
    b, _, h, w = x.shape
    out = torch.zeros(world, 3, c, dtype=torch.float32, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        plan = batch_plan((b, c, h, w), x.dtype,
                          batch_blocks_per_sm(x.dtype, False, False, stats_only=True),
                          card_sms(x.device))
        check_batch_plan(plan, (b, c, h, w), x.dtype)
        part = torch.empty(2 * plan.runs * c, dtype=torch.float32, device=x.device)
        err = _lib().modnorm_batch_partials(
            x.data_ptr(), part.data_ptr(), out[rank].data_ptr(), b * h * w, c, plan.tile,
            plan.runs, plan.smem_bytes, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"modnorm_batch_partials launch failed with CUDA error {err}")
    launches["batch_partials"] += 1
    return out


@_batch_partials_op.register_fake
def _batch_partials_fake(x, rank, world):
    return torch.empty(world, 3, x.shape[1], dtype=torch.float32, device=x.device)


@torch.library.custom_op("deepsee::modnorm_batch_apply", mutates_args=())
def _batch_apply_op(x: torch.Tensor, mod: Optional[torch.Tensor], partials: torch.Tensor,
                    eps: float, lrelu: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B: the plain version on CPU tensors; on CUDA the checks, the
    launch and its count, or a raise."""
    if x.device.type == "cpu":
        return modnorm_batch_apply_plain(x, mod, partials, eps=eps, lrelu=lrelu)
    _check_train(x, mod)
    b, c, h, w = x.shape
    if partials.dim() != 3:
        raise ValueError(f"modnorm: partials must be (world, 3, {c}), got {tuple(partials.shape)}")
    _check_stats("partials", partials, x, (partials.shape[0], 3, c))
    out = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    rstd = torch.empty(c, dtype=torch.float32, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib().modnorm_batch_apply(
            x.data_ptr(), None if mod is None else mod.data_ptr(), partials.data_ptr(),
            partials.shape[0], out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b * h * w, c,
            eps, _DTYPE_CODE[x.dtype], int(lrelu), LRELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"modnorm_batch_apply launch failed with CUDA error {err}")
    launches["batch_apply"] += 1
    return out, mean, rstd


@_batch_apply_op.register_fake
def _batch_apply_fake(x, mod, partials, eps, lrelu):
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty_like(x, memory_format=torch.channels_last),
            torch.empty(x.shape[1], **f32), torch.empty(x.shape[1], **f32))


def _check_backward_inputs(x, mod, gout, mean, rstd) -> None:
    _check_train(x, mod)
    _check_nhwc("gout", gout, x.device, x.dtype, tuple(x.shape))
    for name, v in (("mean", mean), ("rstd", rstd)):
        _check_stats(name, v, x, (x.shape[1],))


@torch.library.custom_op("deepsee::modnorm_backward_sums", mutates_args=())
def _backward_sums_op(x: torch.Tensor, mod: Optional[torch.Tensor], gout: torch.Tensor,
                      mean: torch.Tensor, rstd: torch.Tensor, lrelu: bool) -> torch.Tensor:
    """The backward's reduction: the plain version on CPU tensors; on CUDA
    the checks, the launches and their count, or a raise."""
    if x.device.type == "cpu":
        return modnorm_backward_sums_plain(x, mod, gout, mean, rstd, lrelu=lrelu)
    _check_backward_inputs(x, mod, gout, mean, rstd)
    b, c, h, w = x.shape
    plan = reduce_plan(b * h * w, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty(2 * plan.chunks * c, **f32)
    sums = torch.empty(2, c, **f32)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib().modnorm_backward_batch_sums(
            x.data_ptr(), None if mod is None else mod.data_ptr(), gout.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part.data_ptr(), sums.data_ptr(), b * h * w, c,
            plan.lanes, plan.chunks, plan.chunk, _DTYPE_CODE[x.dtype], int(lrelu), LRELU_SLOPE,
            stream)
    if err != 0:
        raise RuntimeError(f"modnorm_backward_sums launch failed with CUDA error {err}")
    launches["backward_sums"] += 1
    return sums


@_backward_sums_op.register_fake
def _backward_sums_fake(x, mod, gout, mean, rstd, lrelu):
    return torch.empty(2, x.shape[1], dtype=torch.float32, device=x.device)


@torch.library.custom_op("deepsee::modnorm_backward_apply", mutates_args=())
def _backward_apply_op(x: torch.Tensor, mod: Optional[torch.Tensor], gout: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor, sums: torch.Tensor, count: float,
                       lrelu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's elementwise pass: the plain version on CPU tensors; on
    CUDA the checks, the launches and their count, or a raise.  grad_mod is
    an empty tensor where there is no mod."""
    if x.device.type == "cpu":
        gx, gmod = modnorm_backward_apply_plain(x, mod, gout, mean, rstd, sums, count,
                                                lrelu=lrelu)
        return gx, (gmod if gmod is not None else x.new_empty(0))
    _check_backward_inputs(x, mod, gout, mean, rstd)
    b, c, h, w = x.shape
    _check_stats("sums", sums, x, (2, c))
    gx = torch.empty_like(x, memory_format=torch.channels_last)
    gmod = (torch.empty_like(mod, memory_format=torch.channels_last) if mod is not None
            else x.new_empty(0))
    coef = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib().modnorm_backward_batch_apply(
            x.data_ptr(), None if mod is None else mod.data_ptr(), gout.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), sums.data_ptr(), coef.data_ptr(), gx.data_ptr(),
            None if mod is None else gmod.data_ptr(), b * h * w, c, count, _DTYPE_CODE[x.dtype],
            int(lrelu), LRELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"modnorm_backward_apply launch failed with CUDA error {err}")
    launches["backward_apply"] += 1
    return gx, gmod


@_backward_apply_op.register_fake
def _backward_apply_fake(x, mod, gout, mean, rstd, sums, count, lrelu):
    return (torch.empty_like(x, memory_format=torch.channels_last),
            torch.empty_like(mod, memory_format=torch.channels_last) if mod is not None
            else x.new_empty(0))


class SyncModnormTrain(torch.autograd.Function):
    """The training forward with batch statistics over every rank's rows:
    launch A, an all-reduce (sum) of the [world, 3, C] partials, launch B;
    its backward: the reduction, an all-reduce of the [2, C] sums, the
    elementwise pass over the world's pixel count.  Returns (out, mean,
    rstd), the statistics global and equal on every rank.  `group` is the
    process group (None: the default one); every rank must call it with the
    same shapes, in the same order.  `all_reduce` and `grad_all_reduce`, where
    given, replace the forward's and the backward's in-place all-reduce
    over the group (a caller that counts its collectives)."""

    @staticmethod
    def forward(ctx, x, mod, eps: float, lrelu: bool, group=None, all_reduce=None,
                grad_all_reduce=None):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        partials = torch.ops.deepsee.modnorm_batch_partials(x, rank, world)
        (all_reduce or functools.partial(dist.all_reduce, group=group))(partials)
        out, mean, rstd = torch.ops.deepsee.modnorm_batch_apply(x, mod, partials, eps, lrelu)
        ctx.mark_non_differentiable(mean, rstd)
        ctx.save_for_backward(x, mod, mean, rstd)
        b, _, h, w = x.shape
        ctx.count, ctx.lrelu = float(world * b * h * w), lrelu
        ctx.grad_all_reduce = grad_all_reduce or functools.partial(dist.all_reduce, group=group)
        return out, mean, rstd

    @staticmethod
    def backward(ctx, gout, _grad_mean, _grad_rstd):
        x, mod, mean, rstd = ctx.saved_tensors
        if not gout.is_contiguous(memory_format=torch.channels_last):
            gout = gout.contiguous(memory_format=torch.channels_last)
            layout_copies["backward"] += 1
        sums = torch.ops.deepsee.modnorm_backward_sums(x, mod, gout, mean, rstd, ctx.lrelu)
        ctx.grad_all_reduce(sums)
        gx, gmod = torch.ops.deepsee.modnorm_backward_apply(x, mod, gout, mean, rstd, sums,
                                                            ctx.count, ctx.lrelu)
        return gx, (gmod if mod is not None else None), None, None, None, None, None


def modnorm_train_sync(x: torch.Tensor, mod: Optional[torch.Tensor] = None, *,
                       eps: float = 1e-5, lrelu: bool = False, group=None, all_reduce=None,
                       grad_all_reduce=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`modnorm_train(x, mod, stats="batch")` with the statistics of every
    rank's rows (SyncModnormTrain): (out, mean, rstd)."""
    return SyncModnormTrain.apply(x, mod, eps, lrelu, group, all_reduce, grad_all_reduce)


# -- the instance mode across the stripes of a map ---------------------------
#
# Under spatial sharding (parallel/spatial.py) each rank holds a horizontal
# stripe of every sample, so an instance norm's (sample, channel) statistics
# are partials.  SplitInstanceModnorm splits the instance mode as
# SyncModnormTrain splits the batch mode, with one statistics set per sample:
# the partials launch (the grid variant's statistics alone, [3, B, C] rows of
# (count, mean, M2)), an all-reduce of the [world, 3, B, C] rows, the merge-
# and-apply launch; in the backward, the sums launch ([2, B, C] sums of gy and
# gy * x_hat), an all-reduce, and the apply launch over the global count of a
# sample's pixels, which the caller passes: the stripes may be uneven.


MAX_RUNS_PER_SET = 46340      # the kernel's kMaxRunsPerSet


def instance_partials_plan(shape: Tuple[int, int, int, int], dtype: torch.dtype,
                           blocks_per_sm: int = BATCH_BLOCKS_PER_SM, sms: int = SMS
                           ) -> BatchPlan:
    """The partials launch for x of `shape` (B, C, H, W): the batch
    forward's kernel over B statistics sets, the widest channel tile up to a
    128-byte line, as many runs of each (sample, tile) slab as fill the
    `blocks_per_sm` * `sms` blocks the card holds at once (at least one; a
    slab of one run needs no grid barrier and so no co-residency), each
    run's first pixels kept in shared memory.  `runs` counts the runs of
    every slab of a tile (B times the runs per slab), `pixels_per_run` is a
    slab's longest run."""
    b, c, h, w = shape
    esize = _check_shape(shape, dtype)
    tile = _widest(c, esize, LINE, 2 * SECTOR, SECTOR, SECTOR // 2)
    tiles, capacity, hw, pixel_bytes = c // tile, blocks_per_sm * sms, h * w, tile * esize
    per_slab = max(1, min(capacity // (tiles * b), math.ceil(hw / (THREADS // (pixel_bytes // 16))),
                          MAX_RUNS_PER_SET))
    pixels = math.ceil(hw / per_slab)
    resident = min(pixels, _batch_room(blocks_per_sm) // pixel_bytes)
    return BatchPlan(tile, per_slab * b, pixels, resident, resident * pixel_bytes, blocks_per_sm,
                     sms, per_slab * b * tiles)


@functools.cache
def instance_partials_blocks_per_sm(dtype: torch.dtype) -> int:
    """Blocks of the partials launch the current card holds per SM with the
    shared memory its plan gives them: BATCH_BLOCKS_PER_SM where they fit."""
    for n in range(BATCH_BLOCKS_PER_SM, 0, -1):
        if _lib().modnorm_instance_partials_blocks_per_sm(_DTYPE_CODE[dtype],
                                                          _batch_room(n)) >= n:
            return n
    raise RuntimeError("modnorm: the card holds no block of the instance partials launch")


def instance_reduce_plan(b: int, hw: int, c: int) -> ReducePlan:
    """The backward sums launch over `b` samples of `hw` pixels: as
    `reduce_plan`, the chunks of each sample's pixels filling one wave of
    blocks over the batch."""
    if c % 8 or c < 8 or hw < 1 or b < 1:
        raise ValueError(f"modnorm: training needs C % 8 == 0 and a nonempty x, got "
                         f"{b} x {hw} pixels x {c} channels")
    lanes = next(n for n in (8, 4, 2, 1) if (c // 8) % n == 0)
    rows, groups = THREADS // lanes, c // (8 * lanes)
    chunks = max(1, min(math.ceil(REDUCE_BLOCKS / (groups * b)), math.ceil(hw / (8 * rows))))
    chunk = math.ceil(hw / chunks)
    chunks = math.ceil(hw / chunk)
    return ReducePlan(lanes, chunks, chunk, (chunks, groups))


def modnorm_instance_partials_plain(x: torch.Tensor) -> torch.Tensor:
    """Eager-torch version of the partials launch: float32 (3, B, C) rows of
    (count, mean, centred M2) per sample and channel over x's H*W pixels."""
    b, c, h, w = x.shape
    xf = x.float()
    mean = xf.mean((2, 3))
    d = xf - mean[:, :, None, None]
    return torch.stack([torch.full_like(mean, float(h * w)), mean, (d * d).sum((2, 3))])


def modnorm_instance_apply_plain(x: torch.Tensor, mod: Optional[torch.Tensor],
                                 partials: torch.Tensor, *, eps: float = 1e-5,
                                 lrelu: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eager-torch version of the apply launch: the [world, 3, B, C] rows
    merged per sample in rank order (`merge_partials`), then x normalized as
    the instance mode does, modulated and leaky-ReLU'd.  Returns (out, mean,
    rstd), the statistics (B, C)."""
    n, mean, m2 = merge_partials(partials)
    rstd = torch.rsqrt(m2 / n + eps)
    y = _modulate(_normalized(x.float(), mean, rstd, "instance"), mod, lrelu)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last), mean, rstd


def modnorm_instance_backward_sums_plain(x: torch.Tensor, mod: Optional[torch.Tensor],
                                         gout: torch.Tensor, mean: torch.Tensor,
                                         rstd: torch.Tensor, *, lrelu: bool = False
                                         ) -> torch.Tensor:
    """Eager-torch version of the backward sums launch: float32 (2, B, C)
    sums of gy and gy * x_hat over x's H*W pixels."""
    xh, _, gy = _backward_terms(x, mod, gout, mean, rstd, "instance", lrelu)
    return torch.stack([gy.sum((2, 3)), (gy * xh).sum((2, 3))])


def modnorm_instance_backward_apply_plain(x: torch.Tensor, mod: Optional[torch.Tensor],
                                          gout: torch.Tensor, mean: torch.Tensor,
                                          rstd: torch.Tensor, sums: torch.Tensor, count: float,
                                          *, lrelu: bool = False
                                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Eager-torch version of the backward apply launch: (grad_x, grad_mod)
    from the all-reduced (2, B, C) `sums` over `count` pixels per sample."""
    xh, gz, gy = _backward_terms(x, mod, gout, mean, rstd, "instance", lrelu)
    mgy, mgyx = (v[:, :, None, None] / count for v in sums.float())
    return _backward_outputs(x, mod, xh, gz, gy, rstd, mgy, mgyx, "instance")


def modnorm_instance_partials(x: torch.Tensor, rank: int = 0, world: int = 1) -> torch.Tensor:
    """The partials launch: a float32 [world, 3, B, C] buffer of zeros but
    for row `rank`, x's (count, mean, M2) per sample and channel; the caller
    all-reduces it (sum)."""
    return torch.ops.deepsee.modnorm_instance_partials(x, rank, world)


def modnorm_instance_apply(x: torch.Tensor, mod: Optional[torch.Tensor], partials: torch.Tensor,
                           *, eps: float = 1e-5, lrelu: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The apply launch: (out, mean, rstd) from x, mod and the all-reduced
    partials."""
    return torch.ops.deepsee.modnorm_instance_apply(x, mod, partials, eps, lrelu)


def modnorm_instance_backward_sums(x: torch.Tensor, mod: Optional[torch.Tensor],
                                   gout: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                                   *, lrelu: bool = False) -> torch.Tensor:
    """The backward sums launch: float32 (2, B, C) sums of gy and gy * x_hat."""
    return torch.ops.deepsee.modnorm_instance_backward_sums(x, mod, gout, mean, rstd, lrelu)


def modnorm_instance_backward_apply(x: torch.Tensor, mod: Optional[torch.Tensor],
                                    gout: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                                    sums: torch.Tensor, count: float, *, lrelu: bool = False
                                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward apply launch from the all-reduced sums over `count`
    pixels per sample: (grad_x, grad_mod), grad_mod None without mod."""
    gx, gmod = torch.ops.deepsee.modnorm_instance_backward_apply(x, mod, gout, mean, rstd, sums,
                                                                 float(count), lrelu)
    return gx, (gmod if mod is not None else None)


def _check_instance_stats(x, mod, gout, mean, rstd) -> None:
    _check_train(x, mod)
    _check_nhwc("gout", gout, x.device, x.dtype, tuple(x.shape))
    for name, v in (("mean", mean), ("rstd", rstd)):
        _check_stats(name, v, x, (x.shape[0], x.shape[1]))


@torch.library.custom_op("deepsee::modnorm_instance_partials", mutates_args=())
def _instance_partials_op(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """The partials launch: the plain version on CPU tensors; on CUDA the
    checks, the launch and its count, or a raise."""
    if not 0 <= rank < world:
        raise ValueError(f"modnorm: rank {rank} of a world of {world}")
    b, c = x.shape[:2]
    if x.device.type == "cpu":
        out = torch.zeros(world, 3, b, c, dtype=torch.float32)
        out[rank] = modnorm_instance_partials_plain(x)
        return out
    _check_train(x, None)
    _, _, h, w = x.shape
    out = torch.zeros(world, 3, b, c, dtype=torch.float32, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        plan = instance_partials_plan((b, c, h, w), x.dtype,
                                      instance_partials_blocks_per_sm(x.dtype),
                                      card_sms(x.device))
        part = (torch.empty(2 * plan.runs * c, dtype=torch.float32, device=x.device)
                if plan.runs > b else None)
        err = _lib().modnorm_instance_partials(
            x.data_ptr(), None if part is None else part.data_ptr(), out[rank].data_ptr(), b,
            h * w, c, plan.tile, plan.runs, plan.smem_bytes, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"modnorm_instance_partials launch failed with CUDA error {err}")
    launches["instance_partials"] += 1
    return out


@_instance_partials_op.register_fake
def _instance_partials_fake(x, rank, world):
    return torch.empty(world, 3, x.shape[0], x.shape[1], dtype=torch.float32, device=x.device)


@torch.library.custom_op("deepsee::modnorm_instance_apply", mutates_args=())
def _instance_apply_op(x: torch.Tensor, mod: Optional[torch.Tensor], partials: torch.Tensor,
                       eps: float, lrelu: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The apply launch: the plain version on CPU tensors; on CUDA the
    checks, the launch and its count, or a raise."""
    if x.device.type == "cpu":
        return modnorm_instance_apply_plain(x, mod, partials, eps=eps, lrelu=lrelu)
    _check_train(x, mod)
    b, c, h, w = x.shape
    if partials.dim() != 4:
        raise ValueError(f"modnorm: partials must be (world, 3, {b}, {c}), got "
                         f"{tuple(partials.shape)}")
    _check_stats("partials", partials, x, (partials.shape[0], 3, b, c))
    out = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty(b, c, dtype=torch.float32, device=x.device)
    rstd = torch.empty(b, c, dtype=torch.float32, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib().modnorm_instance_apply(
            x.data_ptr(), None if mod is None else mod.data_ptr(), partials.data_ptr(),
            partials.shape[0], out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b, h * w, c,
            eps, _DTYPE_CODE[x.dtype], int(lrelu), LRELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"modnorm_instance_apply launch failed with CUDA error {err}")
    launches["instance_apply"] += 1
    return out, mean, rstd


@_instance_apply_op.register_fake
def _instance_apply_fake(x, mod, partials, eps, lrelu):
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty_like(x, memory_format=torch.channels_last),
            torch.empty(x.shape[0], x.shape[1], **f32), torch.empty(x.shape[0], x.shape[1], **f32))


@torch.library.custom_op("deepsee::modnorm_instance_backward_sums", mutates_args=())
def _instance_backward_sums_op(x: torch.Tensor, mod: Optional[torch.Tensor], gout: torch.Tensor,
                               mean: torch.Tensor, rstd: torch.Tensor, lrelu: bool
                               ) -> torch.Tensor:
    """The backward sums launch: the plain version on CPU tensors; on CUDA
    the checks, the launch and its count, or a raise."""
    if x.device.type == "cpu":
        return modnorm_instance_backward_sums_plain(x, mod, gout, mean, rstd, lrelu=lrelu)
    _check_instance_stats(x, mod, gout, mean, rstd)
    b, c, h, w = x.shape
    plan = instance_reduce_plan(b, h * w, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty(2 * b * plan.chunks * c, **f32)
    done = torch.zeros(b * plan.grid[1], dtype=torch.int32, device=x.device)
    sums = torch.empty(2, b, c, **f32)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib().modnorm_instance_backward_sums(
            x.data_ptr(), None if mod is None else mod.data_ptr(), gout.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part.data_ptr(), done.data_ptr(), sums.data_ptr(),
            b, h * w, c, plan.lanes, plan.chunks, plan.chunk, _DTYPE_CODE[x.dtype], int(lrelu),
            LRELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"modnorm_instance_backward_sums launch failed with CUDA error {err}")
    launches["instance_backward_sums"] += 1
    return sums


@_instance_backward_sums_op.register_fake
def _instance_backward_sums_fake(x, mod, gout, mean, rstd, lrelu):
    return torch.empty(2, x.shape[0], x.shape[1], dtype=torch.float32, device=x.device)


@torch.library.custom_op("deepsee::modnorm_instance_backward_apply", mutates_args=())
def _instance_backward_apply_op(x: torch.Tensor, mod: Optional[torch.Tensor], gout: torch.Tensor,
                                mean: torch.Tensor, rstd: torch.Tensor, sums: torch.Tensor,
                                count: float, lrelu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward apply launch: the plain version on CPU tensors; on CUDA
    the checks, the launch and its count, or a raise.  grad_mod is an empty
    tensor where there is no mod."""
    if x.device.type == "cpu":
        gx, gmod = modnorm_instance_backward_apply_plain(x, mod, gout, mean, rstd, sums, count,
                                                         lrelu=lrelu)
        return gx, (gmod if gmod is not None else x.new_empty(0))
    _check_instance_stats(x, mod, gout, mean, rstd)
    b, c, h, w = x.shape
    _check_stats("sums", sums, x, (2, b, c))
    gx = torch.empty_like(x, memory_format=torch.channels_last)
    gmod = (torch.empty_like(mod, memory_format=torch.channels_last) if mod is not None
            else x.new_empty(0))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib().modnorm_instance_backward_apply(
            x.data_ptr(), None if mod is None else mod.data_ptr(), gout.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), sums.data_ptr(), gx.data_ptr(),
            None if mod is None else gmod.data_ptr(), b, h * w, c, count, _DTYPE_CODE[x.dtype],
            int(lrelu), LRELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"modnorm_instance_backward_apply launch failed with CUDA error {err}")
    launches["instance_backward_apply"] += 1
    return gx, gmod


@_instance_backward_apply_op.register_fake
def _instance_backward_apply_fake(x, mod, gout, mean, rstd, sums, count, lrelu):
    return (torch.empty_like(x, memory_format=torch.channels_last),
            torch.empty_like(mod, memory_format=torch.channels_last) if mod is not None
            else x.new_empty(0))


class SplitInstanceModnorm(torch.autograd.Function):
    """The instance mode with each sample's statistics over the stripes of
    every rank: the partials launch, `all_reduce` (in place, sum) of the
    [world, 3, B, C] rows, the apply launch; its backward: the sums launch,
    `grad_all_reduce` of the [2, B, C] sums, the apply launch over `count`
    pixels per sample (the whole map's).  Returns (out, mean, rstd), the
    statistics (B, C), equal on every rank.  `rank` and `world` are this
    rank's place in the group the callables reduce over; every rank must
    call it with the same B and C, in the same order."""

    @staticmethod
    def forward(ctx, x, mod, eps: float, lrelu: bool, count: float, rank: int, world: int,
                all_reduce, grad_all_reduce):
        partials = torch.ops.deepsee.modnorm_instance_partials(x, rank, world)
        all_reduce(partials)
        out, mean, rstd = torch.ops.deepsee.modnorm_instance_apply(x, mod, partials, eps, lrelu)
        ctx.mark_non_differentiable(mean, rstd)
        ctx.save_for_backward(x, mod, mean, rstd)
        ctx.count, ctx.lrelu, ctx.grad_all_reduce = count, lrelu, grad_all_reduce
        return out, mean, rstd

    @staticmethod
    def backward(ctx, gout, _grad_mean, _grad_rstd):
        x, mod, mean, rstd = ctx.saved_tensors
        if not gout.is_contiguous(memory_format=torch.channels_last):
            gout = gout.contiguous(memory_format=torch.channels_last)
            layout_copies["backward"] += 1
        sums = torch.ops.deepsee.modnorm_instance_backward_sums(x, mod, gout, mean, rstd,
                                                                ctx.lrelu)
        ctx.grad_all_reduce(sums)
        gx, gmod = torch.ops.deepsee.modnorm_instance_backward_apply(
            x, mod, gout, mean, rstd, sums, ctx.count, ctx.lrelu)
        return (gx, (gmod if mod is not None else None)) + (None,) * 7
