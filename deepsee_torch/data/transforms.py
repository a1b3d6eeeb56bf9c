"""Host-side decode-time transforms, an own copy of
deepsee_tpu/data/transforms.py (reference: data/base_dataset.py:149-251).

One `TransformParams` (crop position and flip coin) is drawn per sample and
shared between the image and label transforms; images resize with PIL
BICUBIC and normalize to [-1, 1]; labels resize with PIL NEAREST and map
255 -> label_nc.  The native codec (data/codec.py) computes the same pixels
bit for bit where the mode's output size is known before decoding; Pillow
does the rest (scale_width, scale_shortside, fixed) and is the fallback.
Pillow is imported only where it is used, so the codec's paths run without
it.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from deepsee_torch.config import DataConfig, ModelConfig
from deepsee_torch.data import codec


@dataclass(frozen=True)
class TransformParams:
    crop_pos: Tuple[int, int]
    flip: bool


def scaled_size(preprocess_mode: str, load_size: int,
                size: Tuple[int, int]) -> Tuple[int, int]:
    """New (w, h) before cropping (base_dataset.py:150-162)."""
    w, h = size
    if preprocess_mode == "resize_and_crop":
        return load_size, load_size
    if preprocess_mode == "scale_width_and_crop":
        return load_size, load_size * h // w
    if preprocess_mode == "scale_shortside_and_crop":
        ss, ls = min(w, h), max(w, h)
        ls = int(load_size * ls / ss)
        return (ss, ls) if w == ss else (ls, ss)
    return w, h


def get_params(data_cfg: DataConfig, model_cfg: ModelConfig, size: Tuple[int, int],
               rng: Optional[_random.Random] = None) -> TransformParams:
    """Random crop position and flip coin (base_dataset.py:149-168)."""
    rng = rng or _random
    new_w, new_h = scaled_size(data_cfg.preprocess_mode, model_cfg.load_size, size)
    x = rng.randint(0, max(0, new_w - model_cfg.crop_size))
    y = rng.randint(0, max(0, new_h - model_cfg.crop_size))
    flip = rng.random() > 0.5
    return TransformParams(crop_pos=(x, y), flip=flip)


def _pil(mode: str):
    """PIL.Image, or an ImportError naming the preprocess mode that needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"preprocess mode {mode!r} (or an input outside the native codec's "
                          "envelope) needs Pillow, which is not installed") from e
    return Image


def _apply_pil(img, data_cfg: DataConfig, model_cfg: ModelConfig, params: TransformParams,
               method, is_train: bool, preprocess_mode: Optional[str] = None):
    """The PIL pipeline of get_transform (base_dataset.py:171-201)."""
    mode = preprocess_mode or data_cfg.preprocess_mode
    Image = _pil(mode)
    load, crop = model_cfg.load_size, model_cfg.crop_size

    if "center_crop" in mode:
        cc = data_cfg.center_crop_size
        w, h = img.size
        left = int(round((w - cc) / 2.0))
        top = int(round((h - cc) / 2.0))
        img = img.crop((left, top, left + cc, top + cc))
    if "resize" in mode:
        img = img.resize((load, load), method)
    elif "scale_width" in mode:
        if img.size[0] != load:
            img = img.resize((load, int(load * img.size[1] / img.size[0])), method)
    elif "scale_shortside" in mode:
        w, h = img.size
        ss = min(w, h)
        if ss != load:
            ls = int(load * max(w, h) / ss)
            img = img.resize((load, ls) if w == ss else (ls, load), method)

    if "crop" in mode and "center_crop" not in mode:
        x, y = params.crop_pos
        img = img.crop((x, y, x + crop, y + crop))

    if mode == "fixed":
        h = round(crop / model_cfg.aspect_ratio)
        img = img.resize((crop, h), method)

    if is_train and not data_cfg.no_flip and params.flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def apply_image_transform(img, data_cfg: DataConfig, model_cfg: ModelConfig,
                          params: TransformParams, is_train: bool,
                          preprocess_mode: Optional[str] = None) -> np.ndarray:
    """PIL image -> float32 HWC RGB in [-1, 1]."""
    Image = _pil(preprocess_mode or data_cfg.preprocess_mode)
    method = Image.BILINEAR if model_cfg.downsampling_method == "bilinear" else Image.BICUBIC
    img = _apply_pil(img.convert("RGB"), data_cfg, model_cfg, params, method, is_train,
                     preprocess_mode)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0  # Normalize((0.5,)*3, (0.5,)*3)


def apply_label_transform(label, data_cfg: DataConfig, model_cfg: ModelConfig,
                          params: TransformParams, is_train: bool,
                          preprocess_mode: Optional[str] = None) -> np.ndarray:
    """PIL label map -> int32 HW; 255 ('unknown') -> label_nc
    (base_dataset.py:93-95)."""
    Image = _pil(preprocess_mode or data_cfg.preprocess_mode)
    lab = _apply_pil(label, data_cfg, model_cfg, params, Image.NEAREST, is_train,
                     preprocess_mode)
    arr = np.asarray(lab).astype(np.int32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr[arr == 255] = model_cfg.label_nc
    return arr


# -- the native codec's path: the same semantics, fused in C -------------------

def _native_plan(data_cfg: DataConfig, model_cfg: ModelConfig, params: TransformParams,
                 is_train: bool, for_label: bool, preprocess_mode: Optional[str]):
    """(DsnOps, (h, w)) mirroring _apply_pil for the modes whose output size
    is known before decoding, or None where the mode needs Pillow
    (scale_width, scale_shortside and fixed depend on the decoded size)."""
    mode = preprocess_mode or data_cfg.preprocess_mode
    if ("scale_width" in mode or "scale_shortside" in mode or mode == "fixed"
            or ("resize" not in mode and "center_crop" not in mode and "crop" not in mode)):
        return None
    load, crop = model_cfg.load_size, model_cfg.crop_size

    center_crop = (data_cfg.center_crop_size or 0) if "center_crop" in mode else 0
    resize = (load, load) if "resize" in mode else None
    crop_box = None
    if "crop" in mode and "center_crop" not in mode:
        x, y = params.crop_pos
        crop_box = (x, y, crop, crop)
        out_hw = (crop, crop)
    elif resize:
        out_hw = (load, load)
    else:
        out_hw = (center_crop, center_crop)
    flip = is_train and not data_cfg.no_flip and params.flip
    if for_label:
        resample = codec.NEAREST
    else:
        resample = codec.BILINEAR if model_cfg.downsampling_method == "bilinear" else codec.BICUBIC
    ops = codec.make_ops(center_crop=center_crop, resize=resize, crop=crop_box, flip=flip,
                         resample=resample,
                         scaled_decode=not for_label and data_cfg.native_scaled_decode)
    return ops, out_hw


def _native_mode(data_cfg: DataConfig) -> str:
    mode = data_cfg.native_codec
    if mode == "on" and not codec.available():
        raise RuntimeError(f"native_codec='on' but the native codec is unavailable "
                           f"({codec.unavailable_reason()}); use native_codec='auto'")
    return mode


def load_image(path: str, data_cfg: DataConfig, model_cfg: ModelConfig,
               params: TransformParams, is_train: bool,
               preprocess_mode: Optional[str] = None) -> np.ndarray:
    """Decode and transform an image file: the native codec where enabled
    and applicable (bit-exact), Pillow otherwise."""
    if _native_mode(data_cfg) != "off":
        plan = _native_plan(data_cfg, model_cfg, params, is_train, False, preprocess_mode)
        if plan is not None:
            arr = codec.decode_image(path, *plan)
            if arr is not None:
                return arr
    Image = _pil(preprocess_mode or data_cfg.preprocess_mode)
    with Image.open(path) as img:
        return apply_image_transform(img, data_cfg, model_cfg, params, is_train,
                                     preprocess_mode)


def load_label(path: str, data_cfg: DataConfig, model_cfg: ModelConfig,
               params: TransformParams, is_train: bool,
               preprocess_mode: Optional[str] = None) -> np.ndarray:
    """Decode and transform a label file (NEAREST, 255 -> label_nc)."""
    if _native_mode(data_cfg) != "off":
        plan = _native_plan(data_cfg, model_cfg, params, is_train, True, preprocess_mode)
        if plan is not None:
            arr = codec.decode_label(path, *plan, model_cfg.label_nc)
            if arr is not None:
                return arr
    Image = _pil(preprocess_mode or data_cfg.preprocess_mode)
    with Image.open(path) as lab:
        return apply_label_transform(lab, data_cfg, model_cfg, params, is_train,
                                     preprocess_mode)
