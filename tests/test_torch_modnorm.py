"""The modnorm epilogue: its plain version against the JAX package's norm +
modulation line, the CPU routing of the wrapper, the launch plans of the
instance mode, the batch-statistics forward and the instance backward, and
the kernels' chunked statistics emulated in numpy.  The kernel itself is
held against the plain version on the card by tests/test_torch_kernels.py,
which imports no JAX package so that it runs where flax is not installed.

JAX side: ParamFreeNorm (normalization.py:163-176) with random running
stats or instance_norm_2d, then `normalized * mod[..., :C] + mod[..., C:]`
(normalization.py:212,310) and leaky_relu (blocks.py:67,72).
Tolerance on CPU: 1e-5 absolute, float32 summation order (instance stats).
"""

import dataclasses
import math

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
    _check_covers_each_slab_once(plan, shape)
    tile_bytes = plan.tile * esize
    if plan.variant == "grid":
        _check_grid_plan_fits(plan, shape, dtype)
        wide = mn._widest(c, esize, 2 * mn.SECTOR, mn.SECTOR, mn.SECTOR // 2)
        assert plan.tile == wide and hw * tile_bytes > mn.GRID_SLAB
        return
    # on-chip: one 32-byte sector of channels (16 bytes only where C forces
    # it), or two for slabs within WIDE_SLAB; streaming: up to a 128-byte line
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
    # on-chip: MIN_CLUSTER blocks a slab or more, up to FEW_SLABS_CLUSTER
    # where the slabs are fewer than SLAB_BLOCKS / MIN_CLUSTER (H*W allowing)
    slabs = b * c // plan.tile
    if plan.variant == "on-chip":
        least = min(mn.FEW_SLABS_CLUSTER, max(mn.MIN_CLUSTER, -(-mn.SLAB_BLOCKS // slabs)))
        assert plan.cluster >= min(least, hw)


def _check_covers_each_slab_once(plan, shape):
    """The kernel's blocks cover every (sample, channel tile) slab's H*W
    pixels once, in chunks of at most pixels_per_cta: the cluster kernels'
    block x = rank + cluster * tile index, y = sample; the grid kernel's one
    dimension, block i = (sample * runs + run) * tiles + tile index."""
    b, c, h, w = shape
    hw, tiles = h * w, c // plan.tile
    chunks = mn.instance_chunks(hw, plan.cluster)
    covered = {}
    if plan.variant == "grid":
        for i in range(plan.grid[0] * plan.grid[1]):
            r, tile_index = divmod(i, tiles)
            sample, run = divmod(r, plan.cluster)
            covered.setdefault((sample, tile_index), []).append(chunks[run])
    else:
        for bx in range(plan.grid[0]):
            tile_index, rank = divmod(bx, plan.cluster)
            assert tile_index < tiles
            for by in range(plan.grid[1]):
                covered.setdefault((by, tile_index), []).append(chunks[rank])
    assert len(covered) == b * tiles
    for ranges in covered.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == hw
        assert all(r0[1] == r1[0] for r0, r1 in zip(ranges, ranges[1:]))
        assert all(0 < e - s <= plan.pixels_per_cta for s, e in ranges)


def _check_grid_plan_fits(plan, shape, dtype, sms=mn.SMS):
    """The grid variant: its resident pixels within two blocks' share of an
    SM, every block resident at once where runs merge across the barrier,
    no run longer than GRID_RUN_VECTORS vectors."""
    b, c, h, w = shape
    pixel_bytes = plan.tile * torch.finfo(dtype).bits // 8
    assert plan.register_vectors == 0
    assert plan.smem_bytes % pixel_bytes == 0
    assert 0 < plan.smem_bytes // pixel_bytes <= plan.pixels_per_cta
    assert plan.smem_bytes + mn.STATIC_SMEM + 1024 <= SMEM_PER_SM // 2
    assert plan.cluster == 1 or plan.grid[0] * plan.grid[1] <= 2 * sms
    assert plan.pixels_per_cta * pixel_bytes // 16 <= mn.GRID_RUN_VECTORS


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape,variant", [(s, "on-chip") for s in MAIN_PATH + FULL_256]
                         + [((8, 32, 512, 512), "streaming"), ((8, 64, 65, 65), "on-chip")],
                         ids=str)
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


def _step_instance_shapes(b):
    """The step's instance norms at batch b: both trunks, and D on 2b."""
    return [(b, 32, 256, 256), (b, 64, 128, 128), (b, 128, 64, 64), (b, 256, 128, 128),
            (b, 128, 128, 128), (b, 32, 32, 32), (b, 64, 32, 32), (b, 128, 32, 32),
            (b, 256, 64, 64), (b, 128, 64, 64), (2 * b, 64, 65, 65), (2 * b, 128, 33, 33),
            (2 * b, 256, 34, 34), (2 * b, 64, 33, 33), (2 * b, 128, 17, 17),
            (2 * b, 256, 18, 18)]


# the instance forward with statistics out at the faithful b4 step's shapes
# (both trunks, D on 2B) and the main path's five inference shapes at b32
STEP_B4 = sorted(set(_step_instance_shapes(4)))


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape", STEP_B4 + MAIN_PATH, ids=str)
def test_instance_plan_at_step_and_encoder_shapes(shape, dtype):
    """The plan `instance_plan` chooses, and the grid variant at one run per
    slab, two, and as many as fill the card (each where the check takes it),
    cover every slab and pixel once and fit the kernel."""
    b, c, h, w = shape
    esize = torch.finfo(dtype).bits // 8
    plan = mn.instance_plan(shape, dtype)
    mn.check_instance_plan(plan, shape, dtype)
    _check_covers_each_slab_once(plan, shape)
    wide = mn._widest(c, esize, 2 * mn.SECTOR, mn.SECTOR, mn.SECTOR // 2)
    fill = mn.BATCH_BLOCKS_PER_SM * mn.SMS // (b * c // wide)
    taken = 0
    for grid in mn._instance_candidates(shape, dtype, "grid", wide, sorted({1, 2, max(1, fill)})):
        try:
            mn.check_instance_plan(grid, shape, dtype)
        except ValueError:
            assert (grid.pixels_per_cta * wide * esize // 16 > mn.GRID_RUN_VECTORS
                    or grid.grid[0] * grid.grid[1] > 2 * mn.SMS)
            continue
        taken += 1
        _check_covers_each_slab_once(grid, shape)
        _check_grid_plan_fits(grid, shape, dtype)
    assert taken


def test_instance_plan_at_the_step_shapes_chooses_as_measured():
    """bf16, the choices the H100 measured fastest among the kernel's
    variants (scripts/instance_plans.py): the grid variant for the trunks'
    128^2 and 256^2 slabs at b4, runs filling the card; clusters of 2 for
    the discriminator's and the mini trunk's slabs, 4 for the fewest."""
    bf16 = torch.bfloat16
    for shape in [(4, 32, 256, 256), (4, 64, 128, 128), (4, 256, 128, 128),
                  (4, 128, 128, 128)]:
        assert mn.instance_plan(shape, bf16).variant == "grid"
    for shape, cluster in [((4, 32, 32, 32), 4), ((4, 64, 32, 32), 4), ((4, 128, 32, 32), 2),
                           ((8, 128, 17, 17), 2), ((8, 256, 18, 18), 2), ((8, 64, 33, 33), 2)]:
        plan = mn.instance_plan(shape, bf16)
        assert (plan.variant, plan.cluster) == ("on-chip", cluster)


@pytest.mark.parametrize("change", [dict(cluster=1), dict(smem_bytes=200_000),
                                    dict(pixels_per_cta=4), dict(grid=(32, 4)), dict(tile=24),
                                    dict(register_vectors=8)], ids=str)
def test_check_instance_plan_refuses_a_grid_plan_the_kernel_cannot_take(change):
    """A run longer than GRID_RUN_VECTORS (one run per 256^2 slab), shared
    memory beyond two blocks' share, a wrong run length, grid or tile,
    registers."""
    shape = (4, 32, 256, 256)
    plan = mn.instance_plan(shape, torch.bfloat16)
    assert plan.variant == "grid"
    if "cluster" in change:
        change = dict(change, pixels_per_cta=256 * 256, grid=(1, 4))
    with pytest.raises(ValueError):
        mn.check_instance_plan(dataclasses.replace(plan, **change), shape, torch.bfloat16)


def test_check_instance_plan_refuses_more_runs_than_the_card_holds():
    shape = (4, 64, 128, 128)
    plan = mn._instance_candidates(shape, torch.bfloat16, "grid", 32, [32])[0]
    mn.check_instance_plan(plan, shape, torch.bfloat16, sms=132)
    with pytest.raises(ValueError):
        mn.check_instance_plan(plan, shape, torch.bfloat16, sms=63)


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


# -- training: the batch forward's and the instance backward's plans ---------

SMEM_PER_SM = 233472  # bytes of shared memory on a Hopper SM
# the 8x 256^2 step's generator norms at b4 and b16 (batch statistics), and
# edges: an 8-channel tile, odd H*W, one pixel, a C that needs 16-byte tiles
BATCH_SHAPES = [(b, 512, s, s) for b in (4, 16) for s in (32, 64, 128, 256)]
BATCH_EDGES = [(1, 8, 1, 1), (3, 24, 7, 9), (2, 64, 37, 41), (1, 8, 512, 512), (4, 40, 5, 5)]


INSTANCE_BWD_SHAPES = sorted(set(_step_instance_shapes(4) + _step_instance_shapes(16)))
INSTANCE_BWD_EDGES = [(1, 8, 1, 1), (3, 24, 7, 9), (2, 64, 37, 41), (1, 16, 512, 512),
                      (8, 32, 512, 512)]


@pytest.mark.parametrize("blocks_per_sm", [2, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape", BATCH_SHAPES + BATCH_EDGES, ids=str)
def test_batch_plan_covers_every_pixel_once_and_fits(shape, dtype, blocks_per_sm):
    b, c, h, w = shape
    p, esize = b * h * w, torch.finfo(dtype).bits // 8
    plan = mn.batch_plan(shape, dtype, blocks_per_sm)
    mn.check_batch_plan(plan, shape, dtype)
    assert plan.tile * esize in (16, 32, 64, 128) and c % plan.tile == 0
    assert plan.tile * esize == 128 or c % (2 * plan.tile)  # the widest tile C allows
    # every (channel tile, run) pair once, all blocks resident at once
    tiles = c // plan.tile
    assert plan.grid == tiles * plan.runs <= blocks_per_sm * 132
    runs = mn.instance_chunks(p, plan.runs)
    assert runs[0][0] == 0 and runs[-1][1] == p
    assert all(r0[1] == r1[0] for r0, r1 in zip(runs, runs[1:]))
    assert all(0 < e - s <= plan.pixels_per_run for s, e in runs)
    # the blocks' shared memory (dynamic, the kernel's static arrays, the
    # runtime's 1 KB) fits an SM blocks_per_sm times over
    assert blocks_per_sm * (plan.smem_bytes + mn.STATIC_SMEM + 1024) <= SMEM_PER_SM
    assert plan.smem_bytes + mn.STATIC_SMEM <= SMEM_PER_BLOCK
    assert plan.smem_bytes == plan.resident_pixels * plan.tile * esize
    # on-chip wherever the run fits the block's share of the SM
    room = SMEM_PER_SM // blocks_per_sm - mn.STATIC_SMEM - 1024
    fits = plan.pixels_per_run * plan.tile * esize <= room
    assert plan.variant == ("on-chip" if fits else "re-read")
    assert plan.resident_pixels == min(plan.pixels_per_run, room // (plan.tile * esize))
    # the card is filled wherever there are pixels enough
    if p >= blocks_per_sm * 132 // tiles * (256 // (plan.tile * esize // 16)):
        assert plan.grid > (blocks_per_sm * 132) - tiles


@pytest.mark.parametrize("shape,variant", [((4, 512, 32, 32), "on-chip"),
                                           ((4, 512, 64, 64), "on-chip"),
                                           ((16, 512, 32, 32), "on-chip"),
                                           ((4, 512, 128, 128), "re-read"),
                                           ((4, 512, 256, 256), "re-read"),
                                           ((16, 512, 64, 64), "re-read")], ids=str)
def test_batch_plan_keeps_x_on_chip_where_it_fits(shape, variant):
    """bf16 at 2 blocks per SM: x leaves device memory once at 32^2 and 64^2
    b4 (4.2 and 16.8 MB) and at 32^2 b16, not at 128^2 or 256^2."""
    assert mn.batch_plan(shape, torch.bfloat16).variant == variant


@pytest.mark.parametrize("change", [dict(tile=24), dict(runs=0), dict(runs=4097),
                                    dict(grid=7), dict(pixels_per_run=1),
                                    dict(smem_bytes=SMEM_PER_BLOCK), dict(blocks_per_sm=0),
                                    dict(resident_pixels=10 ** 6), dict(sms=1)], ids=str)
def test_check_batch_plan_refuses_what_the_kernel_cannot_take(change):
    shape = (4, 64, 32, 32)
    plan = dataclasses.replace(mn.batch_plan(shape, torch.bfloat16), **change)
    with pytest.raises(ValueError):
        mn.check_batch_plan(plan, shape, torch.bfloat16)


def test_batch_plan_refuses_what_no_plan_covers():
    # C % 8, float16, no pixels, more channel tiles than the card holds blocks
    for shape, dtype in [((2, 12, 8, 8), torch.float32), ((2, 16, 8, 8), torch.float16),
                         ((1, 8, 0, 4), torch.float32), ((1, 64 * 265, 1, 1), torch.bfloat16)]:
        with pytest.raises(ValueError):
            mn.batch_plan(shape, dtype)
    with pytest.raises(ValueError):
        mn.batch_plan((1, 64 * 133, 1, 1), torch.bfloat16, blocks_per_sm=1)
    with pytest.raises(ValueError):
        mn.batch_plan((1, 64 * 229, 1, 1), torch.bfloat16, sms=114)


@pytest.mark.parametrize("shape", BATCH_SHAPES + BATCH_EDGES, ids=str)
def test_batch_plan_fits_the_sms_of_the_card(shape):
    """Sized for a card of fewer SMs (the PCIe H100's 114), the grid still
    fits it at once and fills it; a plan sized for 132 SMs is refused for
    114 wherever its grid is larger than 114 SMs hold."""
    dtype = torch.bfloat16
    plan = mn.batch_plan(shape, dtype, 2, sms=114)
    mn.check_batch_plan(plan, shape, dtype)
    assert plan.sms == 114 and plan.grid <= 2 * 114
    b, c, h, w = shape
    tiles, lanes = c // plan.tile, plan.tile * 2 // 16
    if b * h * w >= 2 * 114 // tiles * (256 // lanes):
        assert plan.grid > 2 * 114 - tiles
    sxm = mn.batch_plan(shape, dtype, 2)
    if sxm.grid > 2 * 114:
        with pytest.raises(ValueError):
            mn.check_batch_plan(dataclasses.replace(sxm, sms=114), shape, dtype)


def _batch_kernel_statistics(x: np.ndarray, runs: int, groups: int, pilot: int,
                             eps: float = 1e-5):
    """The batch kernel's arithmetic in float32 numpy, x: (P, C).  Each run:
    sums of d = x - K and d * d with K the mean of `pilot` pixels spread
    evenly over the run, each of the `pilot` threads of a channel summing
    pixels q, q + pilot, ... in turn, then the threads' sums added; turned
    into the run's mean and centred M2; then Chan's merge of the runs,
    `groups` contiguous groups in order, then the groups in order."""
    f32 = np.float32
    p, c = x.shape
    parts = []
    for s, e in mn.instance_chunks(p, runs):
        n = e - s
        k = x[s + np.arange(pilot) * n // pilot].sum(axis=0, dtype=f32) / f32(pilot)
        d = np.zeros((-(-n // pilot) * pilot, c), f32)
        d[:n] = x[s:e] - k
        a, q = np.zeros((pilot, c), f32), np.zeros((pilot, c), f32)
        for row in d.reshape(-1, pilot, c):
            a, q = a + row, q + row * row
        a, q = a.sum(axis=0, dtype=f32), q.sum(axis=0, dtype=f32)
        n = f32(n)
        parts.append((n, k + a / n, np.maximum(q - a * (a / n), f32(0))))

    def merge(items):
        n, mean, m2 = f32(0), np.zeros(x.shape[1], f32), np.zeros(x.shape[1], f32)
        for nb, mb, m2b in items:
            if nb == 0:
                continue
            nn = n + nb
            fb = nb / nn
            dm = mb - mean
            mean = mean + dm * fb
            m2 = m2 + m2b + dm * dm * (n * fb)
            n = nn
        return n, mean, m2

    bounds = [(g * runs // groups, (g + 1) * runs // groups) for g in range(groups)]
    _, mean, m2 = merge([merge(parts[s:e]) for s, e in bounds])
    rstd = f32(1) / np.sqrt(m2 / f32(p) + f32(eps))
    return mean, rstd, x * rstd + (-mean * rstd)


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape", [(4, 64, 16, 16), (3, 24, 7, 9), (2, 16, 37, 41),
                                   (1, 8, 1, 1), (8, 32, 33, 33)], ids=str)
def test_batch_kernel_statistics_match_jax(shape, dtype):
    """The batch kernel's shifted sums and merge order, over the runs and
    groups its plan gives, against JAX's mean and variance over N*H*W and
    the normalization x * rstd + (-mean * rstd): float32, 1e-5."""
    b, c, h, w = shape
    plan = mn.batch_plan(shape, dtype)
    rng = np.random.RandomState(4)
    x = (3.0 + 1.5 * rng.randn(b, h, w, c)).astype(np.float32)
    _check_batch_kernel_statistics(x, plan, dtype)


def _check_batch_kernel_statistics(x: np.ndarray, plan, dtype):
    b, h, w, c = x.shape
    lanes = plan.tile * (torch.finfo(dtype).bits // 8) // 16
    mean, rstd, y = _batch_kernel_statistics(x.reshape(-1, c), plan.runs,
                                             mn.THREADS // plan.tile, mn.THREADS // lanes)
    jx = jnp.asarray(x)
    jmean = jnp.mean(jx, axis=(0, 1, 2))
    jrstd = jax.lax.rsqrt(jnp.var(jx, axis=(0, 1, 2)) + 1e-5)
    np.testing.assert_allclose(mean, np.asarray(jmean), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rstd, np.asarray(jrstd), rtol=1e-5, atol=0)
    np.testing.assert_allclose(y.reshape(b, h, w, c), np.asarray((jx - jmean) * jrstd),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape", [(4, 64, 16, 16), (2, 16, 37, 41), (8, 32, 33, 33),
                                   (4, 512, 32, 32)], ids=str)
def test_batch_kernel_statistics_hold_far_from_the_mean(shape, dtype):
    """As above, with |mean| >> sigma and the first pixel of every run and
    of every image 20 sigma off the mean (a corner after zero padding): the
    shift K is a mean of pixels spread over the run, not one pixel, whose
    distance would cost ((K - mean) / sigma)^2 in precision."""
    b, c, h, w = shape
    plan = mn.batch_plan(shape, dtype)
    rng = np.random.RandomState(5)
    x = (50.0 + 1.5 * rng.randn(b, h, w, c)).astype(np.float32)
    x[:, 0, 0] = 80.0
    flat = x.reshape(-1, c)
    for s, _ in mn.instance_chunks(b * h * w, plan.runs):
        flat[s] = 80.0
    lanes = plan.tile * (torch.finfo(dtype).bits // 8) // 16
    mean, rstd, _ = _batch_kernel_statistics(flat, plan.runs, mn.THREADS // plan.tile,
                                             mn.THREADS // lanes)
    _check_against_float64(flat, mean, rstd)


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape", [(2, 32, 128, 128), (1, 64, 96, 96), (2, 16, 37, 41)],
                         ids=str)
def test_grid_instance_statistics_match_jax(shape, dtype):
    """The grid variant's arithmetic (the batch kernel's shifted sums and
    merge, over each sample's runs) at the plan's runs, against the JAX
    package's instance norm: the mean and rstd per (sample, channel) and
    (x - mean) * rstd, float32, 1e-5."""
    b, c, h, w = shape
    esize = torch.finfo(dtype).bits // 8
    tile = mn._widest(c, esize, 2 * mn.SECTOR, mn.SECTOR, mn.SECTOR // 2)
    runs = 8 if h * w > 2000 else 1
    plan = mn._instance_candidates(shape, dtype, "grid", tile, [runs])[0]
    mn.check_instance_plan(plan, shape, dtype)
    lanes = plan.tile * esize // 16
    rng = np.random.RandomState(8)
    x = (0.7 + 1.5 * rng.randn(b, h, w, c)).astype(np.float32)
    got = np.stack([_batch_kernel_statistics(x[i].reshape(-1, c), plan.cluster,
                                             mn.THREADS // plan.tile, mn.THREADS // lanes)[:2]
                    for i in range(b)], axis=1)          # (2, B, C): mean, rstd
    mean, rstd = got[0], got[1]
    y = (x - mean[:, None, None]) * rstd[:, None, None]
    jx = jnp.asarray(x)
    jmean = jnp.mean(jx, axis=(1, 2))
    jrstd = jax.lax.rsqrt(jnp.var(jx, axis=(1, 2)) + 1e-5)
    np.testing.assert_allclose(mean, np.asarray(jmean), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rstd, np.asarray(jrstd), rtol=1e-5, atol=0)
    np.testing.assert_allclose(y, np.asarray(jax_instance_norm_2d(jx)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("run", [7944, 31775], ids=["256^2 b4", "256^2 b16"])
def test_batch_kernel_statistics_hold_far_from_the_mean_over_long_runs(run):
    """The b4 and b16 steps' 256^2 runs (4 * 256^2 / 33 and 16 * 256^2 / 33
    pixels of a 64-channel bf16 tile, 32 threads per channel), two of them,
    each starting 20 sigma off a mean of 50."""
    rng = np.random.RandomState(6)
    x = (50.0 + 1.5 * rng.randn(2 * run, 16)).astype(np.float32)
    x[[0, run]] = 80.0
    mean, rstd, _ = _batch_kernel_statistics(x, 2, 8, 32)
    _check_against_float64(x, mean, rstd)


def _check_against_float64(x: np.ndarray, mean: np.ndarray, rstd: np.ndarray):
    """The mean to a few float32 ulps, rstd to 1e-5."""
    var = x.astype(np.float64).var(axis=0)
    np.testing.assert_allclose(mean, x.astype(np.float64).mean(axis=0), rtol=1e-6, atol=0)
    np.testing.assert_allclose(rstd, 1 / np.sqrt(var + 1e-5), rtol=1e-5, atol=0)


@pytest.mark.parametrize("with_mod", [False, True], ids=["x,gout", "x,gout,mod"])
@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape", INSTANCE_BWD_SHAPES + INSTANCE_BWD_EDGES, ids=str)
def test_instance_backward_plan_covers_each_slab_once_and_fits(shape, dtype, with_mod):
    b, c, h, w = shape
    hw, esize = h * w, torch.finfo(dtype).bits // 8
    tensors = 4 if with_mod else 2
    plan = mn.instance_backward_plan(shape, dtype, with_mod)
    mn.check_instance_backward_plan(plan, shape, dtype, with_mod)
    assert plan.register_vectors == 0 and 1 <= plan.cluster <= 16
    assert plan.smem_bytes + mn.STATIC_SMEM <= SMEM_PER_BLOCK
    lanes = plan.tile * esize // 16

    def widest(*sizes):  # channels of the first size (bytes) with 8 or more dividing C
        return next(n // esize for n in sizes if n // esize >= 8 and c % (n // esize) == 0)

    # two sectors of a pixel for slabs up to 512 KB per tensor, else one
    wide, sector = widest(64, 32, 16), widest(32, 16)
    tiles = ([wide] if hw * wide * esize <= 2 * mn.WIDE_SLAB else []) + [sector]

    def fits(tile):  # each tensor's chunk split 16 ways, padded to whole
        # rounds of 256 vectors, within a block's share of an SM with two
        vectors = math.ceil(hw / min(16, hw)) * tile * esize // 16
        return tensors * math.ceil(vectors / 256) * 256 * 16 <= mn.TWO_BLOCKS_SMEM

    assert plan.variant == ("on-chip" if any(map(fits, tiles)) else "streaming")
    if plan.variant == "on-chip":
        # every tensor's chunk in shared memory, two blocks per SM
        assert plan.tile == next(t for t in tiles if fits(t))
        assert plan.smem_bytes >= tensors * plan.pixels_per_cta * plan.tile * esize
        assert plan.smem_bytes <= mn.TWO_BLOCKS_SMEM
    else:
        # the widest tile up to a line that gives 66 blocks, where one does
        assert plan.smem_bytes == 0 and plan.tile * esize in (16, 32, 64, 128)
        assert b * c // plan.tile * plan.cluster >= 66 or plan.tile * esize <= 16 or (
            plan.tile == 8 and esize == 4)
        wider = plan.tile * 2
        assert (wider * esize > 128 or c % wider
                or b * c // wider * plan.cluster < 66)
    chunks = mn.instance_chunks(hw, plan.cluster)
    covered = {}
    for bx in range(plan.grid[0]):
        tile_index, rank = divmod(bx, plan.cluster)
        for by in range(plan.grid[1]):
            covered.setdefault((by, tile_index), []).append(chunks[rank])
    assert len(covered) == b * c // plan.tile
    for ranges in covered.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == hw
        assert all(r0[1] == r1[0] for r0, r1 in zip(ranges, ranges[1:]))
        assert all(0 < e - s <= plan.pixels_per_cta for s, e in ranges)
    assert lanes in (1, 2, 4, 8)


@pytest.mark.parametrize("shape", INSTANCE_BWD_SHAPES, ids=str)
def test_instance_backward_plan_variant_at_the_steps_bf16_shapes(shape):
    """Every instance backward of the b4 and b16 steps (no mod) keeps x and
    gout on chip in bf16, at a 32-channel tile up to 8192 pixels (64^2,
    the discriminator's) and a 16-channel one at 128^2; but the full
    trunk's (B, 32, 256, 256): its slab needs 16-byte tiles and a block per
    SM to fit a cluster, so it streams, at a 16-channel tile at b4 (128
    blocks) and a whole pixel at b16."""
    plan = mn.instance_backward_plan(shape, torch.bfloat16, False)
    if shape[1:] == (32, 256, 256):
        tile = 16 if shape[0] == 4 else 32
        assert (plan.variant, plan.tile, plan.cluster) == ("streaming", tile, 16)
    else:
        tile = 32 if shape[2] * shape[3] <= 8192 else 16
        assert plan.variant == "on-chip" and plan.tile == min(tile, shape[1])


@pytest.mark.parametrize("change", [dict(cluster=17), dict(cluster=0), dict(tile=24),
                                    dict(smem_bytes=SMEM_PER_BLOCK), dict(variant="split"),
                                    dict(pixels_per_cta=1), dict(grid=(1, 2)),
                                    dict(register_vectors=8), dict(smem_bytes=16)], ids=str)
def test_check_instance_backward_plan_refuses_what_the_kernel_cannot_take(change):
    shape = (2, 64, 64, 64)
    plan = dataclasses.replace(mn.instance_backward_plan(shape, torch.bfloat16, True), **change)
    with pytest.raises(ValueError):
        mn.check_instance_backward_plan(plan, shape, torch.bfloat16, True)


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
