"""The native host image codec: ctypes bindings over the port's own build of
`deepsee_torch/csrc/codec.cpp` (a copy of deepsee_tpu/native/codec.cpp), the
bindings of deepsee_tpu/native/__init__.py and native/codec.py in one module.

The library fuses decode -> center crop -> PIL-exact resample -> crop ->
flip -> normalize into one C call that releases the GIL, so the threaded
DataLoader (data/loader.py) decodes on every core.  Its pixels are Pillow's
bit for bit (the same libjpeg-turbo decode, Pillow's fixed-point resampler
re-implemented, the float32 normalize compiled without FMA).

`load()` builds the library with g++ at first use (deepsee_torch/ops/
_build.py; libjpeg, libpng and zlib headers needed) and returns the
configured handle, or None where it cannot be built or fails its ABI or
JPEG self-check; callers then decode with Pillow.  The numpy functions
return None where the library is missing or the input lies outside the
exact envelope (an unsupported color type, an out-of-bounds crop, bytes that
are neither JPEG nor PNG); a missing file raises, as Pillow's path does.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

ABI_VERSION = 3

OK = 0
ERR_IO = -1
ERR_FORMAT = -2
ERR_DECODE = -3
ERR_DIMS = -4
ERR_UNSUPPORTED = -5
ERR_BOUNDS = -6
ERR_CAP = -7

NEAREST, BILINEAR, BICUBIC = 0, 1, 2

_FALLBACK = (ERR_FORMAT, ERR_DECODE, ERR_UNSUPPORTED, ERR_BOUNDS, ERR_DIMS)


class DsnOps(ctypes.Structure):
    """Mirror of codec.cpp's DsnOps (pipeline order: center_crop -> resize ->
    crop -> flip, as data/transforms.py:_apply_pil)."""

    _fields_ = [
        ("center_crop", ctypes.c_int32),
        ("resize_w", ctypes.c_int32),
        ("resize_h", ctypes.c_int32),
        ("crop_x", ctypes.c_int32),
        ("crop_y", ctypes.c_int32),
        ("crop_w", ctypes.c_int32),
        ("crop_h", ctypes.c_int32),
        ("flip", ctypes.c_int32),
        ("resample", ctypes.c_int32),
        ("scaled_decode", ctypes.c_int32),
    ]


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None  # why the library is unavailable, once known


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    opsp = ctypes.POINTER(DsnOps)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.dsn_decode_image.restype = i32
    lib.dsn_decode_image.argtypes = [u8p, i64, opsp, i32, i32, f32p]
    lib.dsn_decode_image_file.restype = i32
    lib.dsn_decode_image_file.argtypes = [ctypes.c_char_p, opsp, i32, i32, f32p]
    lib.dsn_decode_label.restype = i32
    lib.dsn_decode_label.argtypes = [u8p, i64, opsp, i32, i32, i32, i32p]
    lib.dsn_decode_label_file.restype = i32
    lib.dsn_decode_label_file.argtypes = [ctypes.c_char_p, opsp, i32, i32, i32, i32p]
    lib.dsn_decode_u8.restype = i32
    lib.dsn_decode_u8.argtypes = [u8p, i64, opsp, i32, i32, i32, u8p]
    lib.dsn_probe.restype = i32
    lib.dsn_probe.argtypes = [u8p, i64, i32p, i32p]
    lib.dsn_encode_png.restype = i64
    lib.dsn_encode_png.argtypes = [u8p, i32, i32, i32, i32, u8p, i64]


def _open() -> ctypes.CDLL:
    """Build (if needed), open, check the ABI and bind the library; raises
    RuntimeError or OSError with the reason where that fails."""
    from deepsee_torch.ops import _build

    lib = ctypes.CDLL(str(_build.build(["codec"])["codec"]))
    lib.dsn_abi_version.restype = ctypes.c_int32
    lib.dsn_abi_version.argtypes = []
    if lib.dsn_abi_version() != ABI_VERSION:
        raise RuntimeError(f"codec ABI {lib.dsn_abi_version()} != {ABI_VERSION}")
    _bind(lib)
    if not _selfcheck(lib):
        raise RuntimeError("JPEG parity self-check against Pillow failed (the system libjpeg "
                           "differs from Pillow's)")
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The library (built at the first call of the process), or None where
    it cannot be built or checked; the reason is in `unavailable_reason()`
    and in one RuntimeWarning."""
    global _lib, _failure
    if _lib is not None or _failure is not None:
        return _lib
    with _lock:
        if _lib is None and _failure is None:
            try:
                _lib = _open()
            except (RuntimeError, OSError) as e:
                _failure = str(e)
                warnings.warn(f"native codec unavailable, decoding with Pillow: {_failure[:800]}",
                              RuntimeWarning, stacklevel=2)
        return _lib


def available() -> bool:
    return load() is not None


def unavailable_reason() -> Optional[str]:
    """None where the library loaded (or load() was not called yet)."""
    return _failure


def _selfcheck(lib) -> bool:
    """Decode a small in-memory JPEG through the library and through Pillow
    and compare: the bit-exact guarantee assumes the libjpeg the library
    links decodes as the one bundled with Pillow.  True where Pillow is not
    installed (nothing to compare against or fall back to).
    DEEPSEE_NATIVE_NO_SELFCHECK=1 skips it."""
    if os.environ.get("DEEPSEE_NATIVE_NO_SELFCHECK") == "1":
        return True
    try:
        import io

        from PIL import Image
    except ImportError:
        return True
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, size=(24, 24, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(src).save(buf, format="JPEG", quality=85)
    data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = np.empty_like(want)
    rc = lib.dsn_decode_u8(_u8p(data), len(data), ctypes.byref(DsnOps()), 3, want.shape[1],
                           want.shape[0], got.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return rc == OK and bool((got == want).all())


# -- the numpy API (deepsee_tpu/native/codec.py) --------------------------------

def _u8p(buf: bytes):
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


def _check(rc: int, path: Optional[str] = None) -> bool:
    """True = success; False = fall back to Pillow; raises on IO errors."""
    if rc == OK:
        return True
    if rc == ERR_IO:
        raise FileNotFoundError(path or "native codec: unreadable input")
    if rc in _FALLBACK:
        return False
    raise RuntimeError(f"native codec: unexpected status {rc}")


def decode_image(src, ops: DsnOps, out_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """JPEG/PNG (path or bytes) -> float32 (H, W, 3) in [-1, 1]."""
    lib = load()
    if lib is None:
        return None
    h, w = out_hw
    out = np.empty((h, w, 3), dtype=np.float32)
    outp = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if isinstance(src, (str, os.PathLike)):
        rc = lib.dsn_decode_image_file(os.fspath(src).encode(), ops, w, h, outp)
    else:
        rc = lib.dsn_decode_image(_u8p(src), len(src), ops, w, h, outp)
    return out if _check(rc, src if isinstance(src, str) else None) else None


def decode_label(src, ops: DsnOps, out_hw: Tuple[int, int],
                 map255_to: int) -> Optional[np.ndarray]:
    """PNG/JPEG label map (path or bytes) -> int32 (H, W); 255 -> map255_to."""
    lib = load()
    if lib is None:
        return None
    h, w = out_hw
    out = np.empty((h, w), dtype=np.int32)
    outp = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if isinstance(src, (str, os.PathLike)):
        rc = lib.dsn_decode_label_file(os.fspath(src).encode(), ops, map255_to, w, h, outp)
    else:
        rc = lib.dsn_decode_label(_u8p(src), len(src), ops, map255_to, w, h, outp)
    return out if _check(rc, src if isinstance(src, str) else None) else None


def decode_u8(data: bytes, ops: DsnOps, out_hw: Tuple[int, int],
              channels: int = 3) -> Optional[np.ndarray]:
    """Decode to raw uint8 (the serving wire; no normalization)."""
    lib = load()
    if lib is None:
        return None
    h, w = out_hw
    out = np.empty((h, w, 3) if channels == 3 else (h, w), dtype=np.uint8)
    rc = lib.dsn_decode_u8(_u8p(data), len(data), ops, channels, w, h,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if _check(rc) else None


def probe(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) of a JPEG/PNG byte stream, or None."""
    lib = load()
    if lib is None:
        return None
    w, h = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.dsn_probe(_u8p(data), len(data), ctypes.byref(w), ctypes.byref(h))
    return (w.value, h.value) if rc == OK else None


def encode_png(arr: np.ndarray, level: int = 6) -> Optional[bytes]:
    """uint8 (H, W, 3) or (H, W) -> PNG bytes.  Levels <= 2 skip row
    filtering (larger bytes, much less zlib: the fast serving setting)."""
    lib = load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    channels = 3 if arr.ndim == 3 else 1
    h, w = arr.shape[:2]
    # one filter byte per row, deflate's worst-case expansion of ~5 bytes
    # per stored block of <= 16383 bytes, and the zlib / PNG chunk headers
    raw = arr.nbytes + h
    cap = raw + 5 * (raw // 16383 + 1) + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib.dsn_encode_png(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, channels,
                           level, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    return out[:n].tobytes() if n >= 0 else None


def make_ops(center_crop: int = 0, resize: Optional[Tuple[int, int]] = None,
             crop: Optional[Tuple[int, int, int, int]] = None, flip: bool = False,
             resample: int = BICUBIC, scaled_decode: bool = False) -> DsnOps:
    """resize = (w, h); crop = (x, y, w, h)."""
    ops = DsnOps()
    ops.center_crop = center_crop
    if resize:
        ops.resize_w, ops.resize_h = resize
    if crop:
        ops.crop_x, ops.crop_y, ops.crop_w, ops.crop_h = crop
    ops.flip = int(flip)
    ops.resample = resample
    ops.scaled_decode = int(scaled_decode)
    return ops
