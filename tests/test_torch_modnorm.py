"""The modnorm epilogue: its plain version against the JAX package's norm +
modulation line, the CPU routing of the wrapper, the instance mode's launch
plan, and the kernel's chunked statistics emulated in numpy.  The kernel itself is
held against the plain version on the card by tests/test_torch_kernels.py,
which imports no JAX package so that it runs where flax is not installed.

JAX side: ParamFreeNorm (normalization.py:163-176) with random running
stats or instance_norm_2d, then `normalized * mod[..., :C] + mod[..., C:]`
(normalization.py:212,310) and leaky_relu (blocks.py:67,72).
Tolerance on CPU: 1e-5 absolute, float32 summation order (instance stats).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.models.normalization import ParamFreeNorm as JaxParamFreeNorm
from deepsee_tpu.ops.norms import instance_norm_2d as jax_instance_norm_2d
from deepsee_tpu.ops.norms import leaky_relu as jax_leaky_relu
from deepsee_torch.ops import modnorm as mn

B, C, H, W = 2, 16, 8, 8


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _inputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    x = (0.7 + 1.5 * rng.randn(B, H, W, C)).astype(np.float32)
    mod = rng.randn(B, H, W, 2 * C).astype(np.float32)
    mean = (0.5 * rng.randn(C)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    return x, mod, mean, var


def _jax_reference(x, mod, mean, var, stats, lrelu):
    kind = "syncbatch" if stats == "affine" else "instance"
    pfn = JaxParamFreeNorm(C, kind)
    variables = ({"batch_stats": {"param_free_norm": {"mean": mean, "var": var}}}
                 if stats == "affine" else {})
    y = pfn.apply(variables, jnp.asarray(x), train=False)
    if mod is not None:
        y = y * mod[..., :C] + mod[..., C:]
    return np.asarray(jax_leaky_relu(y) if lrelu else y)


@pytest.mark.parametrize("stats", ["affine", "instance"])
@pytest.mark.parametrize("with_mod", [False, True])
@pytest.mark.parametrize("lrelu", [False, True])
def test_modnorm_plain_matches_jax(stats, with_mod, lrelu):
    x, mod, mean, var = _inputs()
    mod = mod if with_mod else None
    got = mn.modnorm_plain(_nchw(x), None if mod is None else _nchw(mod), stats=stats,
                           mean=torch.from_numpy(mean), var=torch.from_numpy(var),
                           lrelu=lrelu)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = _jax_reference(x, mod, mean, var, stats, lrelu)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stats", ["affine", "instance"])
def test_wrapper_takes_plain_version_on_cpu(stats):
    x, mod, mean, var = _inputs(1)
    kw = dict(stats=stats, mean=torch.from_numpy(mean), var=torch.from_numpy(var),
              lrelu=True)
    before = dict(mn.launches)
    got = mn.modnorm(_nchw(x), _nchw(mod), **kw)
    assert mn.launches == before  # nothing launched
    torch.testing.assert_close(got, mn.modnorm_plain(_nchw(x), _nchw(mod), **kw),
                               rtol=0, atol=0)


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(1, 8, 2, 2)
    with pytest.raises(ValueError):
        mn.modnorm(x, stats="batch")
    with pytest.raises(ValueError):
        mn.modnorm(x, stats="affine")  # running stats missing


# -- the instance mode's launch plan (pure Python, as the kernel reads it) --

SMEM_PER_BLOCK = 232448  # bytes of shared memory a Hopper block may use
MAIN_PATH = [(32, 32, 32, 32), (32, 64, 32, 32), (32, 128, 32, 32), (32, 256, 64, 64),
             (32, 128, 64, 64)]
BATCH_1 = [(1,) + s[1:] for s in MAIN_PATH]
FULL_256 = [(32, 32, 256, 256), (32, 64, 128, 128), (32, 128, 64, 64),
            (32, 256, 128, 128), (32, 128, 128, 128)]
FULL_512 = [(8, 32, 512, 512), (8, 64, 256, 256), (8, 128, 128, 128),
            (8, 256, 256, 256), (8, 128, 256, 256)]
GENERATOR = [(32, 512, 64, 64)]
EDGES = [(1, 32, 1, 1), (3, 8, 1, 1), (2, 64, 37, 41), (1, 8, 16, 16), (2, 24, 16, 16),
         (1, 1024, 16, 16), (1, 16, 512, 512)]
DTYPES = [torch.bfloat16, torch.float32]


def _dtype_id(dtype):
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape", MAIN_PATH + BATCH_1 + FULL_256 + FULL_512 + GENERATOR
                         + EDGES, ids=str)
def test_instance_plan_covers_each_slab_once_and_fits(shape, dtype):
    b, c, h, w = shape
    hw, esize = h * w, torch.finfo(dtype).bits // 8
    plan = mn.instance_plan(shape, dtype)
    mn.check_instance_plan(plan, shape, dtype)
    # on-chip: one 32-byte sector of channels (16 bytes only where C forces
    # it), or two for slabs within WIDE_SLAB; streaming: up to a 128-byte line
    tile_bytes = plan.tile * esize
    if plan.variant == "on-chip":
        assert tile_bytes in (32, 64) or (tile_bytes == 16 and c % (32 // esize))
        assert tile_bytes != 64 or hw * tile_bytes <= mn.WIDE_SLAB
    else:
        assert tile_bytes in (16, 32, 64, 128)
    assert 1 <= plan.cluster <= 16
    assert plan.smem_bytes + mn.STATIC_SMEM <= SMEM_PER_BLOCK
    if plan.variant == "on-chip":
        # the chunk, in shared memory or partly in registers; two blocks per
        # SM wherever registers hold part of it
        held = plan.smem_bytes + plan.register_vectors * mn.THREADS * 16
        assert held >= plan.pixels_per_cta * plan.tile * esize
        assert plan.register_vectors == 0 or plan.smem_bytes <= mn.TWO_BLOCKS_SMEM
    else:
        assert plan.smem_bytes == plan.register_vectors == 0
    # the kernel's blocks: x = rank + cluster * tile index, y = sample
    chunks = mn.instance_chunks(hw, plan.cluster)
    covered = {}
    for bx in range(plan.grid[0]):
        tile_index, rank = divmod(bx, plan.cluster)
        assert tile_index < c // plan.tile
        for by in range(plan.grid[1]):
            covered.setdefault((by, tile_index), []).append(chunks[rank])
    assert len(covered) == b * c // plan.tile
    for ranges in covered.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == hw
        assert all(r0[1] == r1[0] for r0, r1 in zip(ranges, ranges[1:]))
        assert all(0 < e - s <= plan.pixels_per_cta for s, e in ranges)
    # one wave of 132 blocks wherever B * (C / tile) * H * W allows it
    slabs = b * c // plan.tile
    if slabs * min(16, hw) >= 132:
        assert plan.grid[0] * plan.grid[1] >= 132


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape,variant", [(s, "on-chip") for s in MAIN_PATH + FULL_256]
                         + [((8, 32, 512, 512), "streaming")], ids=str)
def test_instance_plan_variant(shape, variant, dtype):
    assert mn.instance_plan(shape, dtype).variant == variant


@pytest.mark.parametrize("change", [dict(cluster=17), dict(cluster=0), dict(tile=24),
                                    dict(smem_bytes=SMEM_PER_BLOCK), dict(variant="split"),
                                    dict(pixels_per_cta=1), dict(grid=(1, 2)),
                                    dict(register_vectors=4)], ids=str)
def test_check_instance_plan_refuses_what_the_kernel_cannot_take(change):
    shape = (2, 64, 64, 64)
    plan = dataclasses.replace(mn.instance_plan(shape, torch.bfloat16), **change)
    with pytest.raises(ValueError):
        mn.check_instance_plan(plan, shape, torch.bfloat16)


def test_instance_plan_refuses_what_no_plan_covers():
    for shape, dtype in [((2, 12, 8, 8), torch.float32), ((2, 16, 8, 8), torch.float16),
                         ((70000, 8, 2, 2), torch.float32), ((1, 8, 0, 4), torch.float32)]:
        with pytest.raises(ValueError):
            mn.instance_plan(shape, dtype)


def _chunked_instance_norm(x: np.ndarray, cluster: int, eps: float = 1e-5) -> np.ndarray:
    """The kernel's arithmetic in float32 numpy, x: (B, H, W, C).  Each
    cluster rank's chunk: its sum, its mean, the squared deviations from that
    mean (two passes); then Chan's merge of the chunks in rank order."""
    b, h, w, c = x.shape
    xs = x.reshape(b, h * w, c)
    f32 = np.float32
    n, mean, m2 = f32(0), np.zeros((b, c), f32), np.zeros((b, c), f32)
    for s, e in mn.instance_chunks(h * w, cluster):
        nb = f32(e - s)
        mb = xs[:, s:e].sum(axis=1, dtype=f32) / nb
        m2b = ((xs[:, s:e] - mb[:, None]) ** 2).sum(axis=1, dtype=f32)
        nn = n + nb
        fb = nb / nn
        d = mb - mean
        mean = mean + d * fb
        m2 = m2 + m2b + d * d * (n * fb)
        n = nn
    inv = f32(1) / np.sqrt(m2 / f32(h * w) + f32(eps))
    return ((xs - mean[:, None]) * inv[:, None]).reshape(b, h, w, c)


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape", [(2, 16, 8, 8), (1, 24, 37, 41), (2, 32, 32, 32),
                                   (1, 64, 64, 64), (1, 8, 1, 1)], ids=str)
def test_chunked_statistics_match_jax_instance_norm(shape, dtype):
    """The merge order of the kernel, over the chunks instance_plan gives,
    against the JAX package's instance norm: float32, 1e-5."""
    b, c, h, w = shape
    plan = mn.instance_plan(shape, dtype)
    rng = np.random.RandomState(3)
    x = (0.7 + 1.5 * rng.randn(b, h, w, c)).astype(np.float32)
    got = _chunked_instance_norm(x, plan.cluster)
    assert got.dtype == np.float32
    want = np.asarray(jax_instance_norm_2d(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stats", ["affine", "instance"])
def test_export_records_the_op_not_its_plain_version(stats):
    """torch.export of a module that calls modnorm keeps one
    deepsee::modnorm node (a fake implementation gives its output's shape
    and layout) and none of the plain version's arithmetic; the exported
    program computes what the module does."""
    x, mod, mean, var = _inputs(2)

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("mean", torch.from_numpy(mean))
            self.register_buffer("var", torch.from_numpy(var))

        def forward(self, x, mod):
            return mn.modnorm(x, mod, stats=stats, mean=self.mean, var=self.var, lrelu=True)

    args = (_nchw(x), _nchw(mod))
    program = torch.export.export(Block(), args)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets == ["deepsee.modnorm.default"]
    out = program.module()(*args)
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out, Block()(*args), rtol=0, atol=0)
