"""`modnorm`: normalize -> modulate -> leaky ReLU in one kernel launch.

The epilogue of every SPADE/SEAN norm block and the encoder's instance norm:

    out = lrelu?( norm(x) * mod[:, :C] + mod[:, C:] )

norm(x) is either the eval-mode batch norm from running statistics
(stats="affine", the generator's main path) or the instance norm over H*W
(stats="instance").  `mod` is the 2C-channel modulation-conv output as the
conv returns it (scale first, its +1 already in the conv bias); mod=None
means scale 1 and offset 0.

On a CUDA tensor `modnorm` launches the hand-written kernel in
deepsee_torch/csrc/modnorm.cu (the port of the TPU kernel
modulated_instance_norm) or raises; on a CPU tensor it computes
`modnorm_plain`, the same float32 arithmetic in eager torch.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deepsee_torch.ops import _build
from deepsee_torch.ops.norms import instance_norm_2d

__all__ = ["modnorm", "modnorm_plain", "launches", "reset_launches"]

LRELU_SLOPE = 0.2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per stats mode; the wrapper adds one per launch and nowhere
# else, so a caller can show that a run went through the kernel.
launches = {"affine": 0, "instance": 0}


def reset_launches() -> None:
    for mode in launches:
        launches[mode] = 0


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
    lib.modnorm_instance.argtypes = [p, p, p, i32, i64, i32, f32, i32, i32, f32, p]
    lib.modnorm_instance.restype = ctypes.c_int
    return lib


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
    stats="affine".  Returns a new channels_last tensor of x's type."""
    if stats not in ("affine", "instance"):
        raise ValueError(f"stats must be 'affine' or 'instance', got {stats!r}")
    if stats == "affine" and (mean is None or var is None):
        raise ValueError("stats='affine' needs the running mean and var")
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
            if b > 65535:
                raise ValueError("modnorm: instance mode takes at most 65535 samples")
            err = _lib().modnorm_instance(x.data_ptr(), mod_ptr, out.data_ptr(), b,
                                          h * w, c, eps, code, int(lrelu),
                                          LRELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"modnorm ({stats}) launch failed with CUDA error {err}")
    launches[stats] += 1
    return out
