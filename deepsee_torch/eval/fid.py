"""FID: the FID variant of InceptionV3 and the Frechet distance, port of
deepsee_tpu/eval/fid.py (reference: evaluator/pytorch_fid/inception.py,
fid_score.py, evaluator/inception_util.py).

  * The network is the TF-ported pt_inception-2015-12-05 topology: the
    A, C and E blocks average-pool without counting the padding, the last
    E block (Mixed_7c) max-pools in its pool branch (inception.py:193-310).
    `FIDInception` is a channels_last module whose state-dict keys are
    pt_inception's (`{name}.conv.weight`, `{name}.bn.{weight,bias,
    running_mean,running_var}`), so a real weights file loads strictly
    (its 1008-class `fc` head is not used).
  * `inception_pool3`: [-1, 1] -> [0, 1] (inception_util.py:19), bilinear
    resize to 299 (half-pixel centres, no antialiasing) through
    ops/resize.py, back to [-1, 1] (inception.py:146-153), the network, and
    the global mean: (B, 2048) pool3 activations in float32.
  * The statistics and the distance run on the host in numpy and scipy:
    own copies of the JAX module's `calculate_statistics`,
    `_trace_sqrtm_product`, `frechet_distance`, `_fid_from_grams` and
    `fid_from_activations` (that module imports jax).

Without a weights file `load_inception` draws He-normal convs and an
identity batch norm from a seeded generator, as the JAX package does, and
returns exact=False: FIDs are then comparable only with each other.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from scipy import linalg

from deepsee_torch.ops.resize import resize2d
from deepsee_torch.weights import reference_state_dict

__all__ = ["POOL3_DIM", "FIDInception", "load_inception", "inception_pool3",
           "calculate_statistics", "frechet_distance", "fid_from_activations"]

POOL3_DIM = 2048  # Mixed_7c's channels, the FID feature width

Spec = Tuple[str, int, int, Tuple[int, int], int, Tuple[int, int]]


def _conv_specs() -> List[Spec]:
    """(name, cin, cout, (kh, kw), stride, (ph, pw)) of every BasicConv2d."""
    specs = [
        ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
        ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
        ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
        ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
        ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
    ]

    def a_block(name, cin, pf):
        return [
            (f"{name}.branch1x1", cin, 64, (1, 1), 1, (0, 0)),
            (f"{name}.branch5x5_1", cin, 48, (1, 1), 1, (0, 0)),
            (f"{name}.branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
            (f"{name}.branch3x3dbl_1", cin, 64, (1, 1), 1, (0, 0)),
            (f"{name}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            (f"{name}.branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
            (f"{name}.branch_pool", cin, pf, (1, 1), 1, (0, 0)),
        ]

    specs += a_block("Mixed_5b", 192, 32)
    specs += a_block("Mixed_5c", 256, 64)
    specs += a_block("Mixed_5d", 288, 64)

    specs += [  # InceptionB (Mixed_6a)
        ("Mixed_6a.branch3x3", 288, 384, (3, 3), 2, (0, 0)),
        ("Mixed_6a.branch3x3dbl_1", 288, 64, (1, 1), 1, (0, 0)),
        ("Mixed_6a.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
        ("Mixed_6a.branch3x3dbl_3", 96, 96, (3, 3), 2, (0, 0)),
    ]

    def c_block(name, c7):
        return [
            (f"{name}.branch1x1", 768, 192, (1, 1), 1, (0, 0)),
            (f"{name}.branch7x7_1", 768, c7, (1, 1), 1, (0, 0)),
            (f"{name}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            (f"{name}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            (f"{name}.branch7x7dbl_1", 768, c7, (1, 1), 1, (0, 0)),
            (f"{name}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            (f"{name}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            (f"{name}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            (f"{name}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            (f"{name}.branch_pool", 768, 192, (1, 1), 1, (0, 0)),
        ]

    specs += c_block("Mixed_6b", 128)
    specs += c_block("Mixed_6c", 160)
    specs += c_block("Mixed_6d", 160)
    specs += c_block("Mixed_6e", 192)

    specs += [  # InceptionD (Mixed_7a)
        ("Mixed_7a.branch3x3_1", 768, 192, (1, 1), 1, (0, 0)),
        ("Mixed_7a.branch3x3_2", 192, 320, (3, 3), 2, (0, 0)),
        ("Mixed_7a.branch7x7x3_1", 768, 192, (1, 1), 1, (0, 0)),
        ("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
        ("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
        ("Mixed_7a.branch7x7x3_4", 192, 192, (3, 3), 2, (0, 0)),
    ]

    def e_block(name, cin):
        return [
            (f"{name}.branch1x1", cin, 320, (1, 1), 1, (0, 0)),
            (f"{name}.branch3x3_1", cin, 384, (1, 1), 1, (0, 0)),
            (f"{name}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
            (f"{name}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
            (f"{name}.branch3x3dbl_1", cin, 448, (1, 1), 1, (0, 0)),
            (f"{name}.branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
            (f"{name}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
            (f"{name}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
            (f"{name}.branch_pool", cin, 192, (1, 1), 1, (0, 0)),
        ]

    specs += e_block("Mixed_7b", 1280)
    specs += e_block("Mixed_7c", 2048)
    return specs


class _EvalBatchNorm(nn.Module):
    """Batch norm with running statistics, eps 1e-3, and exactly the keys
    weight, bias, running_mean, running_var (no num_batches_tracked)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-3)


class BasicConv2d(nn.Module):
    """Conv without bias, eval batch norm (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int], stride: int,
                 pad: Tuple[int, int]):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)
        self.bn = _EvalBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_tf(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(3, 1, 1) without counting the padding (the TF-parity FID
    patch).  Only the forward runs here: the channels_last CUDA bug that
    ops/pooling.py works around is in the backward."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class FIDInception(nn.Module):
    """The FID Inception through Mixed_7c on (B, 3, 299, 299) in [-1, 1],
    returning (B, 2048, 8, 8)."""

    def __init__(self):
        super().__init__()
        self._convs: Dict[str, BasicConv2d] = {}
        for name, cin, cout, kernel, stride, pad in _conv_specs():
            parent = self
            *blocks, leaf = name.split(".")
            for block in blocks:
                if not hasattr(parent, block):
                    parent.add_module(block, nn.Module())
                parent = getattr(parent, block)
            conv = BasicConv2d(cin, cout, kernel, stride, pad)
            parent.add_module(leaf, conv)
            self._convs[name] = conv

    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's fallback: He-normal convs (variance 2 / fan_in),
        an identity batch norm.  `generator` is a CPU generator."""
        with torch.no_grad():
            for conv in self._convs.values():
                w = conv.conv.weight
                w.copy_(torch.randn(w.shape, generator=generator) * np.sqrt(2.0 / w[0].numel()))
                conv.bn.weight.fill_(1.0)
                conv.bn.bias.zero_()
                conv.bn.running_mean.zero_()
                conv.bn.running_var.fill_(1.0)

    def _bc(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self._convs[name](x)

    def _block_a(self, x, name):
        b1 = self._bc(x, f"{name}.branch1x1")
        b5 = self._bc(self._bc(x, f"{name}.branch5x5_1"), f"{name}.branch5x5_2")
        b3 = self._bc(x, f"{name}.branch3x3dbl_1")
        b3 = self._bc(b3, f"{name}.branch3x3dbl_2")
        b3 = self._bc(b3, f"{name}.branch3x3dbl_3")
        bp = self._bc(_avg_pool_tf(x), f"{name}.branch_pool")
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _block_b(self, x):  # Mixed_6a
        b3 = self._bc(x, "Mixed_6a.branch3x3")
        bd = self._bc(x, "Mixed_6a.branch3x3dbl_1")
        bd = self._bc(bd, "Mixed_6a.branch3x3dbl_2")
        bd = self._bc(bd, "Mixed_6a.branch3x3dbl_3")
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)

    def _block_c(self, x, name):
        b1 = self._bc(x, f"{name}.branch1x1")
        b7 = self._bc(x, f"{name}.branch7x7_1")
        b7 = self._bc(b7, f"{name}.branch7x7_2")
        b7 = self._bc(b7, f"{name}.branch7x7_3")
        bd = self._bc(x, f"{name}.branch7x7dbl_1")
        for i in (2, 3, 4, 5):
            bd = self._bc(bd, f"{name}.branch7x7dbl_{i}")
        bp = self._bc(_avg_pool_tf(x), f"{name}.branch_pool")
        return torch.cat([b1, b7, bd, bp], dim=1)

    def _block_d(self, x):  # Mixed_7a
        b3 = self._bc(self._bc(x, "Mixed_7a.branch3x3_1"), "Mixed_7a.branch3x3_2")
        b7 = self._bc(x, "Mixed_7a.branch7x7x3_1")
        for i in (2, 3, 4):
            b7 = self._bc(b7, f"Mixed_7a.branch7x7x3_{i}")
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)

    def _block_e(self, x, name, pool_max: bool):
        b1 = self._bc(x, f"{name}.branch1x1")
        b3 = self._bc(x, f"{name}.branch3x3_1")
        b3 = torch.cat([self._bc(b3, f"{name}.branch3x3_2a"),
                        self._bc(b3, f"{name}.branch3x3_2b")], dim=1)
        bd = self._bc(x, f"{name}.branch3x3dbl_1")
        bd = self._bc(bd, f"{name}.branch3x3dbl_2")
        bd = torch.cat([self._bc(bd, f"{name}.branch3x3dbl_3a"),
                        self._bc(bd, f"{name}.branch3x3dbl_3b")], dim=1)
        pool = F.max_pool2d(x, 3, 1, 1) if pool_max else _avg_pool_tf(x)
        bp = self._bc(pool, f"{name}.branch_pool")
        return torch.cat([b1, b3, bd, bp], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._bc(x, "Conv2d_1a_3x3")
        x = self._bc(x, "Conv2d_2a_3x3")
        x = self._bc(x, "Conv2d_2b_3x3")
        x = F.max_pool2d(x, 3, 2)
        x = self._bc(x, "Conv2d_3b_1x1")
        x = self._bc(x, "Conv2d_4a_3x3")
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(x, name)
        x = self._block_b(x)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(x, name)
        x = self._block_d(x)
        x = self._block_e(x, "Mixed_7b", pool_max=False)
        return self._block_e(x, "Mixed_7c", pool_max=True)


def inception_pool3(module: FIDInception, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images in [-1, 1] -> (B, 2048) float32 pool3 activations
    (inception_util.get_batch_activations: [-1, 1] -> [0, 1], then the
    model's bilinear resize to 299 and the return to [-1, 1])."""
    x = images.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = resize2d((x + 1.0) / 2.0, (299, 299), method="bilinear")
    return torch.mean(module(2.0 * x - 1.0), dim=(2, 3))


def load_inception(path: Optional[str] = None, seed: int = 0,
                   device: str | torch.device = "cuda") -> Tuple[FIDInception, bool]:
    """The FID Inception in eval mode on `device`, and `exact`: True when
    `path` (a pt_inception-2015-12-05 state dict) was read, False for the
    seeded random fallback."""
    module = FIDInception()
    exact = bool(path) and os.path.exists(path)
    if exact:
        sd = reference_state_dict(path)
        module.load_state_dict({k: v for k, v in sd.items() if not k.startswith("fc.")},
                               strict=True)
    else:
        module.init_params(torch.Generator().manual_seed(seed))
    return module.to(device).eval().requires_grad_(False), exact


# ---------------------------------------------------------------------------
# statistics and distance (host-side numpy and scipy, like the reference)
# ---------------------------------------------------------------------------

def calculate_statistics(activations: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 2048) -> (mu, sigma) (inception_util.py:12-15)."""
    act = np.asarray(activations, dtype=np.float64)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def _trace_sqrtm_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """tr sqrtm(sigma1 @ sigma2) without forming the matrix square root.

    For PSD sigma2 = C C^T, eig(sigma1 sigma2) = eig(C^T sigma1 C), a
    symmetric PSD problem: the trace of the principal square root is the
    sum of the square roots of those eigenvalues.  When sigma2 is
    numerically rank-deficient (fewer samples than features; the Cholesky
    fails), the symmetric square root B = sigma2^{1/2} gives
    eig(B sigma1 B) instead.  Negative eigenvalue noise is clipped at zero,
    as the reference's `.real` of the principal square root does
    (fid_score.py:185-189)."""
    try:
        chol = linalg.cholesky(sigma2, lower=True)
        inner = chol.T @ sigma1 @ chol
    except linalg.LinAlgError:
        w2, v2 = linalg.eigh(sigma2)
        root = (v2 * np.sqrt(np.clip(w2, 0.0, None))) @ v2.T
        inner = root @ sigma1 @ root
    eigs = linalg.eigvalsh((inner + inner.T) * 0.5)
    return float(np.sqrt(np.clip(eigs, 0.0, None)).sum())


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6,
                     method: str = "fast") -> float:
    """Stable Frechet distance (fid_score.py:138-192).  method="fast"
    computes tr sqrtm(s1 s2) from symmetric eigenvalues
    (`_trace_sqrtm_product`); method="scipy" is the reference's literal
    `linalg.sqrtm` route, with its eps re-offset and imaginary-component
    guard."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    if method == "fast":
        tr_covmean = _trace_sqrtm_product(sigma1, sigma2)
    else:
        covmean = linalg.sqrtm(sigma1.dot(sigma2))  # may be complex or non-finite
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
            covmean = covmean.real
        tr_covmean = float(np.trace(covmean))
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def _fid_from_grams(act_fake: np.ndarray, act_real: np.ndarray) -> float:
    """FID straight from the activations, without D x D covariances: with
    centred activations A_i (n_i x D), tr sqrtm(sigma1 sigma2) is the
    nuclear norm of the n1 x n2 cross-Gram A1 A2^T / sqrt((n1-1)(n2-1)) and
    tr sigma_i a Frobenius norm (the cyclic property of the eigenvalues).
    The same quantity as fid_score.py:138-192, from one small SVD when
    n << 2048."""
    a = np.asarray(act_fake, dtype=np.float64)
    b = np.asarray(act_real, dtype=np.float64)
    mu1, mu2 = a.mean(axis=0), b.mean(axis=0)
    ac, bc = a - mu1, b - mu2
    c1, c2 = a.shape[0] - 1.0, b.shape[0] - 1.0
    diff = mu1 - mu2
    tr1 = float((ac * ac).sum()) / c1
    tr2 = float((bc * bc).sum()) / c2
    sv = np.linalg.svd(ac @ bc.T, compute_uv=False)
    tr_covmean = float(sv.sum()) / np.sqrt(c1 * c2)
    return float(diff.dot(diff) + tr1 + tr2 - 2.0 * tr_covmean)


def fid_from_activations(act_fake: np.ndarray, act_real: np.ndarray,
                         method: str = "fast") -> float:
    """FID of two (N, D) activation sets: the Gram route whenever its SVD is
    no bigger than the covariance eigenproblem it replaces (and the sample
    counts admit n - 1 divisors), else `frechet_distance`."""
    act_fake = np.atleast_2d(np.asarray(act_fake))
    act_real = np.atleast_2d(np.asarray(act_real))
    n1, n2 = act_fake.shape[0], act_real.shape[0]
    dim = act_fake.shape[1]
    if method == "fast" and 2 <= min(n1, n2) and max(n1, n2) <= dim:
        return _fid_from_grams(act_fake, act_real)
    mu1, s1 = calculate_statistics(act_fake)
    mu2, s2 = calculate_statistics(act_real)
    return frechet_distance(mu1, s1, mu2, s2, method=method)
