"""The metric arithmetic on synthetic events: the union of device
intervals and the idle gaps by host range, the p95 over every batch, the
rooflines and the whole step's share from counted work."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import peaks, spec, work
from portbench.tests.conftest import make_tree
from portbench.trace import Tracer, merge


def _tracer(ops, ranges=(), window=(0.0, 10.0)) -> Tracer:
    t = Tracer(False)
    t.ops, t.ranges, t.window = list(ops), list(ranges), window
    return t


def test_busy_is_the_union_of_overlapping_intervals():
    t = _tracer([("k1", 1.0, 3.0), ("copy", 2.0, 4.0), ("k2", 6.0, 7.0), ("k3", 6.5, 6.8)])
    assert merge([(1, 3), (2, 4), (6, 7)]) == [(1, 4), (6, 7)]
    assert t.busy_s == pytest.approx(4.0)
    assert t.window_s == 10.0
    idle = spec.load_module(spec.HERE / "metrics" / "idle_share.infer.py")
    assert idle.read(SimpleNamespace(trace=t)) == pytest.approx(60.0)


def test_idle_gaps_take_the_innermost_host_range():
    ranges = [("loop", -1.0, 9.0), ("preprocess", -0.5, 1.5), ("generate", 3.5, 6.2),
              ("loop", 9.2, 9.4)]
    t = _tracer([("k", 1.0, 4.0), ("k", 6.0, 7.0), ("k", 7.5, 9.5)], ranges)
    gaps = dict(t.idle_gaps())
    # each gap goes to the range open when it began: (0, 1) preprocess,
    # (4, 6) generate, (7, 7.5) loop, (9.5, 10) none
    assert gaps == pytest.approx({"preprocess": 1.0, "generate": 2.0, "loop": 0.5,
                                  "other": 0.5})


def test_kernel_seconds_match_whole_identifiers():
    t = _tracer([("void (anonymous namespace)::modnorm_affine_kernel<bf16>(x)", 0.0, 1.0),
                 ("void instance_backward_apply_kernel<float>()", 1.0, 1.5),
                 ("backward_apply_kernel", 2.0, 2.25), ("sm90_xmma_fprop", 3.0, 4.0)])
    assert t.seconds_of(("modnorm_affine_kernel",)) == 1.0
    assert t.seconds_of(("backward_apply_kernel",)) == 0.25


def _record(trace, **kw):
    cfg = {"start_size": 32, "crop_size": 256, "ngf": 32, "nef": 32,
           "regional_style_size": 128, "norm_g": "spectrallateseansyncbatch3x3",
           "net_e": "combinedstyle", "num_d": 2, "n_layers_d": 4, "ndf": 32}
    base = dict(trace=trace, cfg=cfg, batch=32, units=10, full_trunk=False, elt_bytes=2,
                work=SimpleNamespace(bf16_flops=55e12, int8_ops=0.0, k4_convs=[]),
                stage_ms={"encode": [3.0, 5.0], "generate": [100.0, 140.0]})
    base.update(kw)
    return SimpleNamespace(**base)


def _read(metric, record):
    return spec.load_module(spec.HERE / "metrics" / f"{metric}.py").read(record)


def test_k1_roofline_from_shapes_over_kernel_time():
    bound_ms = work.infer_k1_bound_ms(_record(None).cfg, 32, False, 2)
    # the main path's K1 launches: ten generator norms and five trunk norms
    assert sum(n for *_, n in work.path_norms(_record(None).cfg, 32, False)) == 15
    trace = _tracer([("modnorm_affine_kernel", 0.0, 0.05), ("modnorm_instance_kernel", 1, 1.05)])
    got = _read("k1_roofline.infer", _record(trace))
    assert got == pytest.approx(100.0 * bound_ms * 1e-3 * 10 / 0.1)
    assert _read("k1_roofline.infer", _record(_tracer([("other", 0, 1)]))) is None


def test_k4_roofline_and_mfu_from_counted_work():
    convs = [((32, 256, 64, 64), (1024, 256, 3, 3), 1, 1)]
    macs = 32 * 64 * 64 * 1024 * 256 * 9
    assert work.k4_ops(convs) == 2 * macs
    by_ops = 2 * macs / peaks.INT8_OPS_PER_S
    nbytes = (32 * 256 * 64 * 64 * 2 + 1024 * 256 * 9 * 4 + 1024 * 4 + 32 * 1024 * 64 * 64 * 2)
    assert work.k4_bound_ms(convs, 2) == pytest.approx(
        1e3 * max(by_ops, nbytes / peaks.HBM_BYTES_PER_S))
    rec = _record(_tracer([("igemm_kernel", 0.0, 2.0)]),
                  work=SimpleNamespace(bf16_flops=10e12, int8_ops=4e12, k4_convs=convs))
    assert _read("k4_roofline.int8", rec) == pytest.approx(
        100.0 * work.k4_bound_ms(convs, 2) * 1e-3 * 10 / 2.0)
    least = 10e12 / peaks.BF16_FLOPS_PER_S + 4e12 / peaks.INT8_OPS_PER_S
    assert _read("mfu.infer", rec) == pytest.approx(100.0 * least * 10 / 10.0)


def test_stage_and_optimizer_ms_are_means_per_unit():
    rec = _record(_tracer([]), optimizer_ms=[2.0, 4.0])
    assert _read("stage_ms.encode.infer", rec) == 4.0
    assert _read("stage_ms.generate.infer", rec) == 120.0
    assert _read("optimizer_ms.train", rec) == 3.0
    assert _read("optimizer_ms.train", _record(_tracer([]), optimizer_ms=[])) is None


def test_train_k1_bound_counts_forward_and_backward():
    cfg = dict(_record(None).cfg, start_size=16, crop_size=512, net_e="fullstyle")
    rows = work.train_norms(cfg, 8, True)
    fwd = sum(r[4] for r in rows)
    bwd = sum(r[5] for r in rows)
    # G: 14 norms forward twice (G update, regeneration), backward once;
    # the full trunk 5 twice / once; D 6 layers x 2 calls forward and backward
    assert (fwd, bwd) == (2 * 14 + 2 * 5 + 12, 14 + 5 + 12)
    assert work.train_k1_bound_ms(cfg, 8, 2) > 0


def test_p95_is_over_every_batch_of_the_window(tmp_path):
    """The tail covers every batch the window submitted (the run's note
    names their count), and the rate every image over the window."""
    from portbench import harness

    bench = make_tree(tmp_path)
    cell = spec.load_cell("tiny.infer", bench, tmp_path / "portbench")
    notes = []
    result = harness.run(cell, 2 ** 31 + 3, 0.5, False, "cpu", log=notes.append)
    line = next(n for n in notes if n.startswith("infer_p95_ms over"))
    assert f"over {result.attempted} batches" in line
    assert float(line.split(": ")[1].split(" ms")[0]) == pytest.approx(
        result.metrics["infer_p95_ms"]["value"])
    assert math.isfinite(result.metrics["infer_img_per_s"]["value"])
    assert np.percentile([1.0, 2.0, 3.0, 100.0], 95) > 3.0
