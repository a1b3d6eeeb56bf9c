"""Seeded inputs of the port's step tests that import no JAX, so that
worker processes (tests/_torch_dist_worker.py) can make the same numbers as
the test that spawned them: the batch, the coins, and noise as a function
of the draw's shape (tests/torch_step_parity.py feeds the same to both
packages)."""

from __future__ import annotations

import zlib

import numpy as np

SGD_LR = 0.05
# (use_full, no_noise) of the G step's encode and of the D step's
COINS = ((True, False), (False, True))


def batch_for(cfg, guided: bool, seed: int = 0, batch: int = 2):
    rng = np.random.RandomState(seed)
    size = (batch, cfg.crop_size, cfg.crop_size)
    out = {"image_hr": np.tanh(1.5 * rng.randn(*size, 3)).astype(np.float32),
           "label": rng.randint(0, cfg.label_nc, size).astype(np.int32)}
    if guided:
        out["guiding_image"] = np.tanh(1.5 * rng.randn(*size, 3) + 0.3).astype(np.float32)
        out["guiding_label"] = rng.randint(0, cfg.label_nc, size).astype(np.int32)
    return out


def _seeded(shape, salt: int) -> np.random.RandomState:
    shape = tuple(int(d) for d in shape)
    return np.random.RandomState((zlib.crc32(repr(shape).encode()) + salt) % 2 ** 31)


def normal_for(shape) -> np.ndarray:
    return _seeded(shape, 1).randn(*tuple(int(d) for d in shape)).astype(np.float32)


def uniform_for(shape) -> np.ndarray:
    return _seeded(shape, 2).rand(*tuple(int(d) for d in shape)).astype(np.float32)
