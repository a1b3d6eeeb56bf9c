"""Spatial sharding's pieces against one process, float32 on the CPU:

  * K1's split plain versions (no processes): the instance split's partials,
    merge-and-apply, backward sums and backward apply, and the batch split's,
    on a map cut into uneven stripes (3 and 5 rows), against the one-launch
    plain versions on the whole map;
  * the halo windows over gloo ranks in processes of their own
    (tests/_torch_dist_worker.py, task "sp_ops"), laid out 1 x 2 and 1 x 4:
    every (k, s, p) of the presets (3x3 at stride 1 and 2, D's 4x4 at stride
    2 and 1), the 3x3 stride-2 pool between D's scales, the pool and D's
    four windows in a row (uneven stripes; at 1 x 4 stripes of one row under
    a 4-row window, a halo wider than one neighbour) and the tiny model's
    multiscale discriminator in train mode (its instance norms across the
    stripes): the output, the input's gradient and the parameters'
    gradients against one process within 1e-5 relative L2;
  * each planted fault (zero halos: each rank pads its own edges;
    statistics per stripe) moves the discriminator's outputs by more than
    1e-3 relative L2.
"""

import functools

import pytest
import torch

import _torch_dist_worker as worker
from deepsee_torch.ops import modnorm as mn
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = {"1x2": 2, "1x4": 4}
REL = 1e-5
CASES = list(worker.SP_WINDOWS) + ["discriminator"]


def _rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


@functools.cache
def _runs(tmp):
    spawned = {}
    for layout, world in LAYOUTS.items():
        spawned[layout] = worker.Spawned(f"{tmp}_{layout}", ["sp_ops"], world=world)
    one = {case: worker.window_run(case) for case in CASES}
    return one, {layout: [r["sp_ops"] for r in s.results(timeout=240.0)[0]]
                 for layout, s in spawned.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_ops")
    for layout in LAYOUTS:
        (tmp.parent / f"{tmp.name}_{layout}").mkdir()
    return _runs(str(tmp))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", CASES)
def test_window_matches_one_process(runs, layout, case):
    one, ranks = runs
    want = one[case]
    for rank in ranks[layout]:
        got = rank[case]
        assert len(got["outs"]) == len(want["outs"])
        for a, b in zip(got["outs"], want["outs"]):
            assert a.shape == b.shape and _rel(a, b) <= REL, (a.shape, _rel(a, b))
        assert _rel(got["x_grad"], want["x_grad"]) <= REL
        for a, b in zip(got["grads"], want["grads"]):
            assert _rel(a, b) <= REL


def test_stripes_are_uneven_and_a_halo_spans_ranks(runs):
    """The layouts the cases ran: D's windows leave the last rank the extra
    rows, and at 1 x 4 the pooled maps end in stripes of one row under a
    4-row window."""
    _, ranks = runs
    assert ranks["1x2"][0]["d_chain"]["rows"] == [(0, 2, 7)]
    assert ranks["1x4"][0]["d_chain"]["rows"] == [(0, 1, 2, 3, 7)]
    assert ranks["1x4"][0]["discriminator"]["rows"] == [
        (0, 8, 16, 24, 33), (0, 4, 8, 12, 17), (0, 2, 4, 6, 9), (0, 2, 4, 6, 10),
        (0, 2, 4, 6, 11), (0, 4, 8, 12, 17), (0, 2, 4, 6, 9), (0, 1, 2, 3, 5), (0, 1, 2, 3, 6),
        (0, 1, 2, 3, 7)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_halos_and_statistics_ran_alike_on_every_rank(runs, layout):
    _, ranks = runs
    counts = [r["counts"] for r in ranks[layout]]
    assert all(c == counts[0] for c in counts)
    for kind in ("halo", "halo_grad", "stats", "stats_grad", "grads", "gather"):
        assert counts[0][kind]["calls"] > 0, (kind, counts[0])


@pytest.mark.parametrize("fault", worker.SP_PLANTED)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_planted_faults_break_the_discriminator(runs, layout, fault):
    one, ranks = runs
    got = ranks[layout][0][fault]["outs"]
    assert max(_rel(a, b) for a, b in zip(got, one["discriminator"]["outs"])) > 1e-3


def _uneven(x, cuts=(3,)):
    bounds = (0,) + cuts + (x.shape[2],)
    return [x[:, :, a:b].contiguous(memory_format=torch.channels_last)
            for a, b in zip(bounds[:-1], bounds[1:])]


def _case(seed=3, shape=(2, 16, 8, 6), mod=True):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(shape, generator=g) + 0.5).contiguous(memory_format=torch.channels_last)
    m = (torch.randn((shape[0], 2 * shape[1]) + shape[2:], generator=g).contiguous(
        memory_format=torch.channels_last) if mod else None)
    gout = torch.randn(shape, generator=g).contiguous(memory_format=torch.channels_last)
    return x, m, gout


@pytest.mark.parametrize("mod", [True, False])
@pytest.mark.parametrize("lrelu", [True, False])
def test_instance_split_plain_versions_on_uneven_stripes(mod, lrelu):
    x, m, gout = _case(mod=mod)
    want, mean, rstd = mn.modnorm_train_plain(x, m, stats="instance", lrelu=lrelu)
    want_gx, want_gm = mn.modnorm_backward_plain(x, m, gout, mean, rstd, stats="instance",
                                                 lrelu=lrelu)
    xs, gs = _uneven(x), _uneven(gout)
    ms = _uneven(m) if mod else [None, None]
    partials = torch.stack([mn.modnorm_instance_partials_plain(xi) for xi in xs])
    outs = [mn.modnorm_instance_apply_plain(xi, mi, partials, lrelu=lrelu)
            for xi, mi in zip(xs, ms)]
    torch.testing.assert_close(torch.cat([o[0] for o in outs], 2), want, rtol=1e-5, atol=1e-5)
    for _, got_mean, got_rstd in outs:
        torch.testing.assert_close(got_mean, mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got_rstd, rstd, rtol=1e-5, atol=1e-6)
    sums = sum(mn.modnorm_instance_backward_sums_plain(xi, mi, gi, mean, rstd, lrelu=lrelu)
               for xi, mi, gi in zip(xs, ms, gs))
    count = x.shape[2] * x.shape[3]
    grads = [mn.modnorm_instance_backward_apply_plain(xi, mi, gi, mean, rstd, sums, count,
                                                      lrelu=lrelu)
             for xi, mi, gi in zip(xs, ms, gs)]
    torch.testing.assert_close(torch.cat([g[0] for g in grads], 2), want_gx, rtol=1e-5,
                               atol=1e-5)
    if mod:
        torch.testing.assert_close(torch.cat([g[1] for g in grads], 2), want_gm, rtol=1e-5,
                                   atol=1e-5)


def test_instance_split_ops_take_the_ranks_rows():
    """The registered ops on CPU tensors: the partials buffer holds zeros
    but for the rank's row, the apply merges every row."""
    x, m, _ = _case()
    part = mn.modnorm_instance_partials(x, 1, 3)
    assert part.shape == (3, 3, 2, 16) and not part[0].any() and not part[2].any()
    torch.testing.assert_close(part[1], mn.modnorm_instance_partials_plain(x))
    out, mean, rstd = mn.modnorm_instance_apply(x, m, part, lrelu=True)
    want, want_mean, want_rstd = mn.modnorm_train_plain(x, m, stats="instance", lrelu=True)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert mean.shape == rstd.shape == (2, 16)


@pytest.mark.parametrize("lrelu", [True, False])
def test_batch_split_plain_versions_on_uneven_stripes(lrelu):
    x, m, gout = _case(seed=4)
    want, mean, rstd = mn.modnorm_train_plain(x, m, stats="batch", lrelu=lrelu)
    want_gx, want_gm = mn.modnorm_backward_plain(x, m, gout, mean, rstd, stats="batch",
                                                 lrelu=lrelu)
    xs, ms, gs = _uneven(x, (5,)), _uneven(m, (5,)), _uneven(gout, (5,))
    partials = torch.stack([mn.modnorm_batch_partials_plain(xi) for xi in xs])
    outs = [mn.modnorm_batch_apply_plain(xi, mi, partials, lrelu=lrelu)
            for xi, mi in zip(xs, ms)]
    torch.testing.assert_close(torch.cat([o[0] for o in outs], 2), want, rtol=1e-5, atol=1e-5)
    b_mean, b_rstd = outs[0][1], outs[0][2]
    torch.testing.assert_close(b_mean, mean, rtol=1e-5, atol=1e-6)
    sums = sum(mn.modnorm_backward_sums_plain(xi, mi, gi, b_mean, b_rstd, lrelu=lrelu)
               for xi, mi, gi in zip(xs, ms, gs))
    count = x.shape[0] * x.shape[2] * x.shape[3]
    grads = [mn.modnorm_backward_apply_plain(xi, mi, gi, b_mean, b_rstd, sums, count,
                                             lrelu=lrelu)
             for xi, mi, gi in zip(xs, ms, gs)]
    torch.testing.assert_close(torch.cat([g[0] for g in grads], 2), want_gx, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(torch.cat([g[1] for g in grads], 2), want_gm, rtol=1e-4,
                               atol=1e-5)


def test_plans_of_the_instance_split():
    """The partials and sums launches split each (sample, channel tile) slab
    over one cluster of 1 to 16 blocks, none empty, their chunks covering
    every pixel of every sample (tests/test_torch_sp_plans.py holds them at
    the spatial step's shapes)."""
    for shape, dtype in (((1, 64, 256, 512), torch.bfloat16), ((2, 16, 64, 128), torch.float32),
                         ((8, 512, 8, 16), torch.bfloat16)):
        b, c, h, w = shape
        for plan in (mn.split_plan(shape, dtype),):
            mn.check_split_plan(plan, shape, dtype)
            assert 1 <= plan.cluster <= min(16, h * w) and tuple(plan.grid)[1] == b
            assert plan.pixels_per_cta == -(-h * w // plan.cluster)
            chunks = mn.instance_chunks(h * w, plan.cluster)
            assert chunks[0][0] == 0 and chunks[-1][1] == h * w and all(
                e > s_ and s_ == prev for (s_, e), (_, prev) in zip(chunks, [(0, 0)] + chunks))
