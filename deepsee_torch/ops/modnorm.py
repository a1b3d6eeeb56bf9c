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

The instance mode's launch is planned here, by shape, before the launch
(`instance_plan`): each (sample, channel tile) slab is split along H*W over
the blocks of a thread-block cluster, which either hold their chunks in
shared memory ("on-chip": x is read from device memory once) or stream them
("streaming", for slabs beyond a cluster's shared memory).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

from deepsee_torch.ops import _build
from deepsee_torch.ops.norms import instance_norm_2d

__all__ = ["modnorm", "modnorm_plain", "launches", "reset_launches",
           "InstancePlan", "instance_plan", "instance_chunks", "check_instance_plan",
           "clusters_in_flight", "modnorm_train", "modnorm_train_plain",
           "modnorm_backward", "modnorm_backward_plain", "ReducePlan", "reduce_plan",
           "layout_copies"]

LRELU_SLOPE = 0.2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per mode; each wrapper adds one where it launches its
# kernels and nowhere else, so a caller can show that a run went through
# them.  "batch" is the training forward with batch statistics (the
# statistics kernels, then the affine kernel), "instance_train" the
# instance kernel with its statistics written out, "backward_*" the backward
# of either (reduction, then the elementwise pass).
launches = {"affine": 0, "instance": 0, "batch": 0, "instance_train": 0,
            "backward_batch": 0, "backward_instance": 0}
# Incoming gradients the backward had to copy into channels_last first.
layout_copies = {"backward": 0}


def reset_launches() -> None:
    for mode in launches:
        launches[mode] = 0
    layout_copies["backward"] = 0


# The instance mode's launch plan.  Hopper (H100): 132 SMs with 233,472
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
CHUNK_TARGET = 64 * 1024      # bytes per block, so that 3 blocks share an SM


@dataclasses.dataclass(frozen=True)
class InstancePlan:
    variant: str              # "on-chip" or "streaming"
    tile: int                 # channels per slab: 16 to 128 bytes of a pixel
    cluster: int              # blocks per slab, split along H*W
    pixels_per_cta: int       # the largest chunk of a slab one block takes
    smem_bytes: int           # dynamic shared memory per block
    register_vectors: int     # on-chip: 16-byte vectors per thread held in registers
    grid: Tuple[int, int]     # (cluster * C / tile, B)


def instance_chunks(hw: int, cluster: int) -> List[Tuple[int, int]]:
    """The [start, end) pixels of each cluster rank, as the kernel computes
    them: sizes differ by at most one, and none is empty while cluster <= hw."""
    return [(r * hw // cluster, (r + 1) * hw // cluster) for r in range(cluster)]


def _layout(shape: Tuple[int, int, int, int], esize: int, tile: int,
            variant: str) -> InstancePlan:
    """The cluster split of `variant` with `tile` channels per slab: the
    least split of H*W that (a) fits a chunk in a block's shared memory
    (on-chip), (b) gives the card one wave of 132 blocks, and (c) keeps
    on-chip chunks near 64 KB, so that several blocks per SM overlap their
    loads, arithmetic and stores; at most 16 blocks and H*W.  An on-chip
    chunk too large for two blocks per SM keeps REG_VECTORS vectors per
    thread (32 KB per block) in registers and the rest in shared memory."""
    b, c, h, w = shape
    hw, pixel_bytes = h * w, tile * esize
    fill = math.ceil(SMS / (b * c // tile))
    if variant == "on-chip":
        fit = math.ceil(hw / ((SMEM_PER_BLOCK - STATIC_SMEM) // pixel_bytes))
        near = math.ceil(hw * pixel_bytes / CHUNK_TARGET)
        cluster = min(MAX_CLUSTER, hw, max(fit, fill, near))
    else:
        cluster = min(MAX_CLUSTER, hw)
    pixels = math.ceil(hw / cluster)
    smem, regs = (pixels * pixel_bytes if variant == "on-chip" else 0), 0
    if smem > TWO_BLOCKS_SMEM:
        regs = REG_VECTORS
        smem = _smem_beyond_registers(pixels, pixel_bytes, regs)
    return InstancePlan(variant, tile, cluster, pixels, smem, regs, (cluster * c // tile, b))


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


def instance_plan(shape: Tuple[int, int, int, int], dtype: torch.dtype) -> InstancePlan:
    """The instance mode's launch for x of `shape` (B, C, H, W) and `dtype`.

    A slab is one sample's `tile` channels over H*W; its pixels split over
    the blocks of one cluster (`_layout`).  The tile is one 32-byte sector
    of a pixel (16 bf16 or 8 float32 channels; 16 bytes where C forces it),
    or two sectors where the slab stays within WIDE_SLAB (H*W <= 4096) and
    the slabs still fill the card, which it then runs faster.  On-chip where
    a cluster's shared memory holds the slab; otherwise streaming, at the
    widest tile up to a 128-byte line."""
    b, c, h, w = shape
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"modnorm: dtype must be float32 or bfloat16, got {dtype}")
    if c % 8 or b < 1 or h * w < 1:
        raise ValueError(f"modnorm: x must be (B, C, H, W) with C % 8 == 0, got {shape}")
    if b > 65535:
        raise ValueError("modnorm: instance mode takes at most 65535 samples")
    esize = torch.finfo(dtype).bits // 8

    def widest(*sizes: int) -> int:
        return next(n // esize for n in sizes if n // esize >= 8 and c % (n // esize) == 0)

    sector = widest(SECTOR, SECTOR // 2)
    if _fits_on_chip(shape, esize, sector):
        tile = widest(2 * SECTOR, SECTOR, SECTOR // 2)
        if (h * w * tile * esize > WIDE_SLAB
                or b * c // tile * min(MAX_CLUSTER, h * w) < SMS):
            tile = sector
        return _layout(shape, esize, tile, "on-chip")
    return _layout(shape, esize, widest(LINE, 2 * SECTOR, SECTOR, SECTOR // 2), "streaming")


def check_instance_plan(plan: InstancePlan, shape: Tuple[int, int, int, int],
                        dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernel can take `plan` for x of `shape`."""
    b, c, h, w = shape
    esize = torch.finfo(dtype).bits // 8
    problems = []
    if plan.variant not in ("on-chip", "streaming"):
        problems.append(f"unknown variant {plan.variant!r}")
    if plan.tile < 1 or c % plan.tile or plan.tile * esize not in (16, SECTOR, 2 * SECTOR, LINE):
        problems.append(f"tile {plan.tile} for C={c} {dtype}")
    if not 1 <= plan.cluster <= min(MAX_CLUSTER, h * w):
        problems.append(f"cluster {plan.cluster}")
    elif plan.pixels_per_cta != math.ceil(h * w / plan.cluster):
        problems.append(f"{plan.pixels_per_cta} pixels per block")
    on_chip = plan.variant == "on-chip"
    if plan.register_vectors not in ((0, REG_VECTORS) if on_chip else (0,)):
        problems.append(f"{plan.register_vectors} vectors per thread in registers")
    elif on_chip:
        need = _smem_beyond_registers(plan.pixels_per_cta, plan.tile * esize,
                                      plan.register_vectors)
        if plan.smem_bytes != need or need > SMEM_PER_BLOCK - STATIC_SMEM:
            problems.append(f"{plan.smem_bytes} bytes of shared memory")
    elif plan.smem_bytes:
        problems.append(f"{plan.smem_bytes} bytes of shared memory")
    if plan.tile >= 1 and tuple(plan.grid) != (plan.cluster * c // plan.tile, b):
        problems.append(f"grid {plan.grid}")
    if problems:
        raise ValueError(f"modnorm: the instance kernel cannot take {plan} for "
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
    lib.modnorm_instance_clusters.argtypes = [i32, i64, i32, i32, i32, i32, i32, i32, i32,
                                              i32, i32]
    lib.modnorm_instance_clusters.restype = ctypes.c_int
    lib.modnorm_batch_stats.argtypes = [p, p, p, p, p, i64, i32, i32, i32, i64, f32, i32, p]
    lib.modnorm_batch_stats.restype = ctypes.c_int
    lib.modnorm_backward.argtypes = [p, p, p, p, p, p, p, p, p, i32, i64, i32, i32, i32,
                                     i64, i32, i32, i32, f32, p]
    lib.modnorm_backward.restype = ctypes.c_int
    return lib


def clusters_in_flight(shape: Tuple[int, int, int, int], dtype: torch.dtype,
                       with_mod: bool, lrelu: bool) -> int:
    """How many clusters of the instance mode's launch for this shape the
    current card holds at once (cudaOccupancyMaxActiveClusters); -1 where the
    query fails.  A measurement aid: the plan does not read it."""
    b, c, h, w = shape
    plan = instance_plan(shape, dtype)
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
            plan = instance_plan((b, c, h, w), x.dtype)
            check_instance_plan(plan, (b, c, h, w), x.dtype)
            err = _lib().modnorm_instance(
                x.data_ptr(), mod_ptr, out.data_ptr(), None, None, b, h * w, c, plan.tile,
                plan.cluster, plan.smem_bytes, int(plan.variant == "streaming"),
                plan.register_vectors, eps, code, int(lrelu), LRELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"modnorm ({stats}) launch failed with CUDA error {err}")
    launches[stats] += 1
    return out


@_modnorm_op.register_fake
def _modnorm_fake(x, mod, mean, var, stats, eps, lrelu):
    """Shape, type and layout of the output, for tracing (torch.export)."""
    return torch.empty_like(x, memory_format=torch.channels_last)


# -- training: batch statistics and the backward ------------------------------

TRAIN_STATS = ("batch", "instance")
REDUCE_BLOCKS = 8 * SMS       # one wave of 256-thread blocks, 8 per SM


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    lanes: int                # 8-channel vectors per block: 1, 2, 4 or 8
    chunks: int               # blocks along each statistics set's pixels
    chunk: int                # pixels per chunk (the last may have fewer)
    grid: Tuple[int, int, int]  # (chunks, C / (8 * lanes), sets)


def reduce_plan(sets: int, hw: int, c: int) -> ReducePlan:
    """The launch of the training reductions (batch statistics; the
    backward's sums) over `sets` statistics sets of `hw` pixels and `c`
    channels: the widest channel tile up to 64 channels, and enough chunks
    of each set's pixels for one wave of blocks, each chunk at least 8
    pixels per thread."""
    if c % 8 or c < 8 or sets < 1 or hw < 1:
        raise ValueError(f"modnorm: training needs C % 8 == 0 and a nonempty x, got "
                         f"{sets} sets of {hw} pixels x {c} channels")
    if sets > 65535:
        raise ValueError("modnorm: training takes at most 65535 statistics sets")
    lanes = next(n for n in (8, 4, 2, 1) if (c // 8) % n == 0)
    rows = THREADS // lanes
    groups = c // (8 * lanes)
    chunks = max(1, min(math.ceil(REDUCE_BLOCKS / (sets * groups)),
                        math.ceil(hw / (8 * rows))))
    chunk = math.ceil(hw / chunks)
    chunks = math.ceil(hw / chunk)
    return ReducePlan(lanes, chunks, chunk, (chunks, groups, sets))


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
    dims = _set_dims(stats)
    mgy = gy.mean(dims, keepdim=True)
    mgyx = (gy * xh).mean(dims, keepdim=True)
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
            plan = reduce_plan(1, b * h * w, c)
            part = torch.empty(3 * plan.chunks * c, **f32)
            shift = torch.empty(c, **f32)
            err = _lib().modnorm_batch_stats(
                x.data_ptr(), part.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                shift.data_ptr(), b * h * w, c, plan.lanes, plan.chunks, plan.chunk,
                eps, code, stream)
            if err == 0:
                err = _lib().modnorm_affine(x.data_ptr(), mod_ptr, rstd.data_ptr(),
                                            shift.data_ptr(), out.data_ptr(), b * h * w, c,
                                            code, int(lrelu), LRELU_SLOPE, stream)
        else:
            plan = instance_plan((b, c, h, w), x.dtype)
            check_instance_plan(plan, (b, c, h, w), x.dtype)
            err = _lib().modnorm_instance(
                x.data_ptr(), mod_ptr, out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b,
                h * w, c, plan.tile, plan.cluster, plan.smem_bytes,
                int(plan.variant == "streaming"), plan.register_vectors, eps, code,
                int(lrelu), LRELU_SLOPE, stream)
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
    sets, hw = (1, b * h * w) if stats == "batch" else (b, h * w)
    for name, v in (("mean", mean), ("rstd", rstd)):
        if (v.device != x.device or v.dtype != torch.float32
                or tuple(v.shape) != _stats_shape(x, stats) or not v.is_contiguous()):
            raise ValueError(f"modnorm: {name} must be contiguous float32 "
                             f"{_stats_shape(x, stats)} on {x.device}")
    plan = reduce_plan(sets, hw, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty(2 * sets * plan.chunks * c, **f32)
    coef = torch.empty(2 * sets * c, **f32)
    gx = torch.empty_like(x, memory_format=torch.channels_last)
    gmod = (torch.empty_like(mod, memory_format=torch.channels_last) if mod is not None
            else x.new_empty(0))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib().modnorm_backward(
            x.data_ptr(), None if mod is None else mod.data_ptr(), gout.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part.data_ptr(), coef.data_ptr(),
            gx.data_ptr(), None if mod is None else gmod.data_ptr(), sets, hw, c,
            plan.lanes, plan.chunks, plan.chunk, int(stats == "instance"),
            _DTYPE_CODE[x.dtype], int(lrelu), LRELU_SLOPE, stream)
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
