"""The plans of K1's instance split statistics launches, and their merge
orders emulated in numpy, on the CPU.

Under spatial sharding each rank holds a stripe of every map, so the
instance norm's (sample, channel) statistics are partials: the partials
launch (count, mean, M2) and the backward's sums launch (sums of gy and
gy * x_hat) each stream a (sample, channel tile) slab once through the
blocks of one thread-block cluster (`mn.split_plan`).  Here:

  * the plans at every stripe shape of the 32x 512^2 spatial step at two
    ranks (rank 0's and rank 1's) and at edge shapes: every pixel in one
    block's chunk, none empty, cluster <= 16 and <= H*W, nothing held in
    shared memory or registers beyond the kernels' ring, the blocks the
    H100 measured fastest (64 to 96), many small slabs in small clusters;
    and the checker's refusals;
  * numpy emulations of each kernel's order of operations (a thread's
    vectors in groups, the inner sums flushed into outer ones, the shuffle
    tree within a warp, the warps in order, the cluster's blocks merged in
    rank order by Chan's formula or added) held against the plain versions
    at the card tests' tolerances.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from deepsee_torch.ops import modnorm as mn

# the kernels' constants (csrc/modnorm.cu)
THREADS, WARPS, MAX_TILE = 256, 8, 64
RING_LOADS, SPLIT_FLUSH = 4, 16
STATIC_SMEM_FLOATS = {"partials": 2 * WARPS * MAX_TILE + 2 * MAX_TILE + MAX_TILE + 2 * MAX_TILE
                      + 2 * 16, "sums": 2 * WARPS * MAX_TILE + 2 * MAX_TILE}

# (B, C, H, W) of every instance-split call of the spatial step's ranks
# (rank 0's stripe, rank 1's), and whether it has a modulation: none does
STEP_SHAPES = [
    ((2, 32, 256, 512), (2, 32, 256, 512)), ((2, 64, 128, 256), (2, 64, 128, 256)),
    ((2, 128, 64, 128), (2, 128, 64, 128)), ((2, 256, 128, 256), (2, 256, 128, 256)),
    ((2, 128, 128, 256), (2, 128, 128, 256)), ((4, 64, 64, 129), (4, 64, 65, 129)),
    ((4, 128, 32, 65), (4, 128, 33, 65)), ((4, 256, 32, 66), (4, 256, 34, 66)),
    ((4, 64, 32, 65), (4, 64, 33, 65)), ((4, 128, 16, 33), (4, 128, 17, 33)),
    ((4, 256, 16, 34), (4, 256, 18, 34))]
EDGE_SHAPES = [(1, 8, 1, 1), (3, 16, 1, 7), (1, 8, 2, 1), (65535, 8, 1, 2), (2, 24, 9, 7),
               (1, 8, 4096, 4096), (16, 512, 4, 4), (1, 1024, 3, 3)]
# the largest stripes and their plans' (tile, cluster) in bf16: the fastest
# of every plan on the H100 (scripts/split_plans.py)
LARGE = {(2, 256, 128, 256): (32, 6), (2, 32, 256, 512): (16, 16)}
DTYPES = [torch.bfloat16, torch.float32]


def _all_shapes():
    return sorted({s for pair in STEP_SHAPES for s in pair}) + EDGE_SHAPES


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", _all_shapes())
def test_split_plan_covers_every_pixel_once(shape, dtype):
    b, c, h, w = shape
    plan = mn.split_plan(shape, dtype)
    mn.check_split_plan(plan, shape, dtype)
    esize = torch.finfo(dtype).bits // 8
    assert plan.variant == "ring" and plan.register_vectors == 0
    assert plan.smem_bytes == mn.SPLIT_RING_BYTES
    assert 1 <= plan.cluster <= min(16, h * w)
    assert c % plan.tile == 0 and plan.tile * esize in (16, 32, 64, 128) and plan.tile <= MAX_TILE
    assert tuple(plan.grid) == (plan.cluster * c // plan.tile, b)
    covered = np.zeros(h * w, dtype=np.int64)
    for s, e in mn.instance_chunks(h * w, plan.cluster):
        assert e > s
        covered[s:e] += 1
    assert (covered == 1).all()
    assert plan.pixels_per_cta == max(e - s for s, e in mn.instance_chunks(h * w, plan.cluster))
    lanes = plan.tile * esize // 16
    assert THREADS % lanes == 0   # every thread keeps one lane's channels
    # the ring and either kernel's static arrays, two blocks, fit one SM
    static = max(STATIC_SMEM_FLOATS.values()) * 4
    assert 2 * (plan.smem_bytes + static + 1024) <= mn.SMEM_PER_SM


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_stripes_take_64_to_96_blocks(dtype):
    """Every stripe of the spatial step: at least SPLIT_MIN_BLOCKS blocks,
    the fewest clusters' blocks that reach SPLIT_BLOCKS (the H100's fastest
    lay at 64 to 96), the largest stripes at their measured best."""
    for pair in STEP_SHAPES:
        for shape in pair:
            plan = mn.split_plan(shape, dtype)
            slabs = shape[0] * shape[1] // plan.tile
            assert mn.SPLIT_MIN_BLOCKS <= slabs * plan.cluster
            # the fewest clusters' blocks that reach SPLIT_BLOCKS, or
            # SPLIT_MIN_BLOCKS in clusters of at most PORTABLE_CLUSTER
            assert (plan.cluster - 1) * slabs < mn.SPLIT_BLOCKS or (
                plan.cluster == mn.PORTABLE_CLUSTER)
            assert plan.cluster <= mn.PORTABLE_CLUSTER or (
                slabs * mn.PORTABLE_CLUSTER < mn.SPLIT_MIN_BLOCKS)
    for shape, (tile, cluster) in LARGE.items():
        plan = mn.split_plan(shape, torch.bfloat16)
        assert (plan.tile, plan.cluster) == (tile, cluster), (shape, plan)


def test_small_slabs_take_small_clusters():
    """Many slabs share the blocks: SPLIT_BLOCKS / slabs a cluster, no more
    than 16 and than the slab has pixels (8 where that reaches
    SPLIT_MIN_BLOCKS)."""
    for pair in STEP_SHAPES:
        for shape in pair:
            plan = mn.split_plan(shape, torch.bfloat16)
            slabs = shape[0] * shape[1] // plan.tile
            want = min(16, shape[2] * shape[3], math.ceil(mn.SPLIT_BLOCKS / slabs))
            if want > 8 and slabs * 8 >= mn.SPLIT_MIN_BLOCKS:
                want = 8
            assert plan.cluster == want
    assert mn.split_plan((4, 256, 16, 34), torch.bfloat16).cluster == 3
    assert mn.split_plan((1, 8, 2, 1), torch.float32).cluster == 2


def test_split_plan_refusals():
    plan = mn.split_plan((2, 64, 16, 16), torch.bfloat16)
    shape = (2, 64, 16, 16)
    bad = [dataclasses.replace(plan, cluster=17, grid=(17 * 64 // plan.tile, 2)),
           dataclasses.replace(plan, cluster=0),
           dataclasses.replace(plan, tile=48),
           dataclasses.replace(plan, grid=(plan.grid[0] + 1, 2)),
           dataclasses.replace(plan, variant="on-chip"),
           dataclasses.replace(plan, variant="streaming"),
           dataclasses.replace(plan, smem_bytes=1024),
           dataclasses.replace(plan, smem_bytes=2 * mn.SPLIT_RING_BYTES),
           dataclasses.replace(plan, register_vectors=8),
           dataclasses.replace(plan, pixels_per_cta=plan.pixels_per_cta + 1)]
    for p in bad:
        with pytest.raises(ValueError):
            mn.check_split_plan(p, shape, torch.bfloat16)
    tiny = mn.split_plan((1, 8, 2, 1), torch.float32)
    with pytest.raises(ValueError):  # more blocks than pixels
        mn.check_split_plan(dataclasses.replace(tiny, cluster=3, pixels_per_cta=1,
                                                grid=(3, 1)), (1, 8, 2, 1), torch.float32)
    with pytest.raises(ValueError):
        mn.check_split_plan(plan, (65536, 64, 16, 16), torch.bfloat16)
    for call in (lambda: mn.split_plan((2, 12, 4, 4), torch.float32),
                 lambda: mn.split_plan((65536, 8, 4, 4), torch.float32),
                 lambda: mn.split_plan((2, 8, 4, 4), torch.float16)):
        with pytest.raises(ValueError):
            call()


# -- the merge orders, emulated ----------------------------------------------------

f32 = np.float32


def _tree(acc, lanes):
    """[THREADS, V] per-thread sums of one lane's V channels -> [tile]: the
    shuffle tree within each warp (xor 16, 8, ... down to the lanes), then
    the warps in order."""
    acc = acc.reshape(WARPS, 32, -1)
    off = 16
    while off >= lanes:
        acc = (acc + acc[:, np.arange(32) ^ off]).astype(f32)
        off //= 2
    total = np.zeros(lanes * acc.shape[2], f32)
    for w in range(WARPS):
        total = (total + acc[w, :lanes].reshape(-1)).astype(f32)
    return total


def _block_sums(arrays, lanes, per_step, element):
    """One block's pair of sums over its chunk as the kernels take them:
    `arrays` [npix, tile] float32 of the chunk, `element(inner, vecs)` the
    thread's inner pair after one vector (each array's V values at the
    thread's lane); a thread's vectors tid + k * THREADS (pixel v // lanes,
    lane v % lanes), its inner sums flushed into its outer ones after every
    SPLIT_FLUSH groups of `per_step` vectors; then `_tree`."""
    npix, tile = arrays[0].shape
    v_per = tile // lanes
    tid = np.arange(THREADS)
    cols = (tid % lanes)[:, None] * v_per + np.arange(v_per)[None]
    inner = [np.zeros((THREADS, v_per), f32) for _ in range(2)]
    outer = [np.zeros((THREADS, v_per), f32) for _ in range(2)]
    nvec = npix * lanes
    for k in range(-(-nvec // THREADS)):
        v = tid + k * THREADS
        ok = v < nvec
        pix = np.minimum(v // lanes, npix - 1)[:, None]
        new = element(inner, [arr[pix, cols] for arr in arrays])
        for a, n in zip(inner, new):
            a[ok] = n[ok]
        if k % per_step == per_step - 1 and (k // per_step + 1) % SPLIT_FLUSH == 0:
            for o, a in zip(outer, inner):
                o += a
                a[:] = 0
    for o, a in zip(outer, inner):
        o += a
    return [_tree(o, lanes) for o in outer]


def _chan(n, m, q, nb, mb, qb):
    """chan_merge<1> of the kernels, in float32."""
    nn = f32(n + nb)
    if nb > 0:
        fb = f32(nb / nn)
        fab = f32(n * fb)
        d = (mb - m).astype(f32)
        m = (m + (d * fb).astype(f32)).astype(f32)
        q = (q + (qb + ((d * d).astype(f32) * fab).astype(f32))).astype(f32)
    return nn, m, q


def _slabs(t, tile):
    """(sample, tile index, [H*W, tile] float32 slab) of a (B, C, H, W) tensor."""
    b, c, h, w = t.shape
    flat = t.permute(0, 2, 3, 1).reshape(b, h * w, c).numpy().astype(f32)
    for n in range(b):
        for i in range(c // tile):
            yield n, i, flat[n, :, i * tile:(i + 1) * tile]


def _emulated_partials(x, plan):
    """The partials launch's (count, mean, M2) [3, B, C] for float32 x."""
    b, c, h, w = x.shape
    lanes = plan.tile // 4
    tid = np.arange(THREADS)
    out = np.zeros((3, b, c), f32)
    for n, i, slab in _slabs(x, plan.tile):
        cnt, mean, m2 = f32(0), np.zeros(plan.tile, f32), np.zeros(plan.tile, f32)
        for s, e in mn.instance_chunks(h * w, plan.cluster):
            chunk = slab[s:e]
            # P: the mean of the chunk's first THREADS / lanes pixels (each
            # thread's first vector; threads past the chunk add nothing)
            cols = (tid % lanes)[:, None] * 4 + np.arange(4)[None]
            first = np.where((tid < (e - s) * lanes)[:, None],
                             chunk[np.minimum(tid // lanes, e - s - 1)[:, None], cols], f32(0))
            P = (_tree(first.astype(f32), lanes) / f32(min(e - s, THREADS // lanes))).astype(f32)
            p_thread = P[cols]

            def element(inner, vecs, p_thread=p_thread):
                d = (vecs[0] - p_thread).astype(f32)
                return [(inner[0] + d).astype(f32),
                        (d.astype(np.float64) ** 2 + inner[1]).astype(f32)]  # fmaf

            a, sq = _block_sums([chunk], lanes, RING_LOADS, element)
            nb = f32(e - s)
            da = (a / nb).astype(f32)
            qb = np.maximum((sq - (a * da).astype(f32)).astype(f32), f32(0))
            cnt, mean, m2 = _chan(cnt, mean, m2, nb, (P + da).astype(f32), qb)
        cols = slice(i * plan.tile, (i + 1) * plan.tile)
        out[0, n, cols], out[1, n, cols], out[2, n, cols] = cnt, mean, m2
    return torch.from_numpy(out)


def _emulated_sums(gy, gyx, plan, with_mod):
    """The sums launch's [2, B, C] from the float32 terms gy and gy * x_hat
    (B, C, H, W), added per block as the kernel adds them, then over the
    cluster's blocks in rank order."""
    b, c, h, w = gy.shape
    lanes = plan.tile // 4
    per_step = RING_LOADS // (4 if with_mod else 2)
    out = np.zeros((2, b, c), f32)
    for (n, i, sa_slab), (_, _, sb_slab) in zip(_slabs(gy, plan.tile), _slabs(gyx, plan.tile)):
        sa, sb = np.zeros(plan.tile, f32), np.zeros(plan.tile, f32)
        for s, e in mn.instance_chunks(h * w, plan.cluster):
            a, bb = _block_sums([sa_slab[s:e], sb_slab[s:e]], lanes, per_step,
                                lambda inner, vecs: [(inner[0] + vecs[0]).astype(f32),
                                                     (inner[1] + vecs[1]).astype(f32)])
            sa, sb = (sa + a).astype(f32), (sb + bb).astype(f32)
        cols = slice(i * plan.tile, (i + 1) * plan.tile)
        out[0, n, cols], out[1, n, cols] = sa, sb
    return torch.from_numpy(out)


def _force(plan, shape, cluster):
    """`plan` with `cluster` blocks per slab (long chunks: several flushes
    per thread)."""
    b, c, h, w = shape
    return dataclasses.replace(plan, cluster=cluster, pixels_per_cta=-(-h * w // cluster),
                               grid=(cluster * c // plan.tile, b))


# (shape, cluster or None for the plan's own): small slabs in the plan's own
# clusters, and long chunks (each thread past several flushes), uneven
EMULATED = {"plan": ((2, 16, 24, 40), None), "one block": ((1, 8, 7, 9), 1),
            "long chunks": ((1, 8, 181, 233), 3), "uneven 5": ((2, 32, 33, 31), 5)}


def _x(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 2 + 0.7 + 3 * rng.standard_normal((shape[0], shape[1], 1, 1))
    return torch.from_numpy(x.astype(np.float32)).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("case", list(EMULATED))
def test_partials_merge_order_matches_plain(case):
    """The emulated partials launch against the plain version: the counts
    exact, the means and M2s within the card tests' 1e-5 (relative and
    absolute)."""
    shape, cluster = EMULATED[case]
    x = _x(shape)
    plan = mn.split_plan(shape, torch.float32)
    if cluster is not None:
        plan = _force(plan, shape, cluster)
    mn.check_split_plan(plan, shape, torch.float32)
    got = _emulated_partials(x, plan)
    want = mn.modnorm_instance_partials_plain(x)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1:], want[1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_mod", [False, True])
@pytest.mark.parametrize("case", list(EMULATED))
def test_sums_merge_order_matches_plain(case, with_mod):
    """The emulated sums launch against the plain version within the card
    tests' tolerance (1e-5 relative, 1e-5 of the largest sum absolute)."""
    shape, cluster = EMULATED[case]
    x = _x(shape)
    g = _x(shape, seed=1) - 0.7
    mod = (_x((shape[0], 2 * shape[1]) + shape[2:], seed=2) * 0.3 if with_mod else None)
    _, mean, rstd = mn.modnorm_train_plain(x, mod, stats="instance", lrelu=True)
    plan = mn.split_plan(shape, torch.float32)
    if cluster is not None:
        plan = _force(plan, shape, cluster)
    xh, _, gy = mn._backward_terms(x, mod, g, mean, rstd, "instance", True)
    got = _emulated_sums(gy, gy * xh, plan, with_mod)
    want = mn.modnorm_instance_backward_sums_plain(x, mod, g, mean, rstd, lrelu=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
