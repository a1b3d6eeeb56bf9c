"""The port's CUDA kernels on the card; every test here is marked `cuda` and
skips where no CUDA device is present.  The file imports no JAX package, so
it runs where only torch is installed:

    python -m pytest tests/test_torch_kernels.py -m cuda

float32 comparisons run with TF32 off.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepsee_torch.config import tiny_test_experiment
from deepsee_torch.ops import int8conv as ic
from deepsee_torch.ops import modnorm as mn
from deepsee_torch.system import SRSystem
from deepsee_torch.weights import randomize_weights


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _inputs(device, dtype, shape=(4, 64, 24, 40), with_mod=True, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    b, c, h, w = shape
    x = (torch.randn(shape, generator=g, device=device) * 1.5 + 0.7).to(dtype)
    mod = torch.randn((b, 2 * c, h, w), generator=g, device=device).to(dtype)
    mean = torch.randn(c, generator=g, device=device) * 0.5
    var = torch.rand(c, generator=g, device=device) * 1.5 + 0.5
    cl = torch.channels_last
    return (x.contiguous(memory_format=cl),
            mod.contiguous(memory_format=cl) if with_mod else None, mean, var)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", ["affine", "instance"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mod", [False, True])
@pytest.mark.parametrize("lrelu", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, stats, dtype, with_mod, lrelu):
    """Both compute in float32 and round once: the affine mode does the same
    operations in the same order (exact); the instance mode's chunked
    two-pass statistics differ from the plain version's reductions by a few
    float32 ulps (2e-6 of max|out|), and in bf16 the one rounding may then
    fall on either side (1 bf16 ulp of |out|)."""
    x, mod, mean, var = _inputs(cuda_device, dtype, with_mod=with_mod)
    kw = dict(stats=stats, mean=mean, var=var, lrelu=lrelu)
    before = mn.launches[stats]
    got = mn.modnorm(x, mod, **kw)
    torch.cuda.synchronize()
    assert mn.launches[stats] == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == dtype
    want = mn.modnorm_plain(x, mod, **kw)
    slack = 0.0 if stats == "affine" else 2e-6 * float(want.float().abs().max())
    if dtype == torch.bfloat16:
        slack = slack + torch.finfo(torch.bfloat16).eps * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= slack).all())


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, mod, mean, var = _inputs(cuda_device, torch.bfloat16)
    kw = dict(stats="affine", mean=mean, var=var)
    bad_calls = [
        (x.contiguous(), mod),                        # NCHW memory: no silent copy
        (x, mod[:, :64].contiguous(memory_format=torch.channels_last)),  # not 2C
        (x, mod.float()),                             # mixed dtypes
        (x.half(), mod.half()),                       # float16
        (x[:, :60].contiguous(memory_format=torch.channels_last), None),  # C % 8
    ]
    for args in bad_calls:
        with pytest.raises(ValueError):
            mn.modnorm(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("norm_g", ["spectrallateseansyncbatch3x3",
                                    "spectrallateseaninstance3x3"])
def test_tiny_slice_on_card_matches_cpu(cuda_device, norm_g):
    """The tiny float32 slice on the card (kernels, cuDNN) against the same
    weights on the CPU (plain versions): 1e-4, float32 summation order.
    nef=8, because the kernel takes channel counts that are multiples of 8."""
    exp = tiny_test_experiment().replace(is_train=False)
    exp = exp.replace(model=dataclasses.replace(exp.model, norm_g=norm_g, nef=8))
    cpu = SRSystem(exp, device="cpu")
    cpu.init(torch.Generator().manual_seed(0))
    randomize_weights(cpu.networks().values(), torch.Generator().manual_seed(1))
    card = SRSystem(exp, device=cuda_device)
    for name, net in card.networks().items():
        net.load_state_dict(cpu.networks()[name].state_dict())
    rng = np.random.RandomState(0)
    batch = {"image_hr": np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32),
             "label": rng.randint(0, 19, (2, 32, 32)).astype(np.int32)}
    mn.reset_launches()
    got, _ = card.generate(card.preprocess(batch), use_full=False)
    torch.cuda.synchronize()
    # two norms in each of the 2 + n_blocks generator blocks, five in the encoder
    assert sum(mn.launches.values()) == 2 * (2 + exp.model.n_blocks) + 5
    want, _ = cpu.generate(cpu.preprocess(batch), use_full=False)
    assert 0.1 < float(want.std()) < 0.9  # neither flat nor saturated
    assert float((got.cpu() - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_tiny_guided_slice_on_card_matches_cpu(cuda_device):
    """The guided tiny slice (the full trunk on a guiding image) on the card
    against the CPU: 1e-4, as above."""
    exp = tiny_test_experiment().replace(is_train=False)
    exp = exp.replace(model=dataclasses.replace(
        exp.model, nef=8, net_e="fullstyle", guiding_style_image=True,
        noisy_style_scale=0.05))
    cpu = SRSystem(exp, device="cpu")
    cpu.init(torch.Generator().manual_seed(0))
    randomize_weights(cpu.networks().values(), torch.Generator().manual_seed(1))
    card = SRSystem(exp, device=cuda_device)
    for name, net in card.networks().items():
        net.load_state_dict(cpu.networks()[name].state_dict())
    rng = np.random.RandomState(0)
    batch = {"image_hr": np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32),
             "label": rng.randint(0, 19, (2, 32, 32)).astype(np.int32),
             "guiding_image": np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32),
             "guiding_label": rng.randint(0, 19, (2, 32, 32)).astype(np.int32)}
    mn.reset_launches()
    got, _ = card.generate(card.preprocess(batch))
    torch.cuda.synchronize()
    assert {k: n for k, n in mn.launches.items() if n} == {
        "affine": 2 * (2 + exp.model.n_blocks), "instance": 5}
    want, _ = cpu.generate(cpu.preprocess(batch))
    assert 0.1 < float(want.std()) < 0.9
    assert float((got.cpu() - want).abs().max()) <= 1e-4


# generator cases: an ablation variant, or the 32x tail at 512^2 (ngf=1:
# 16 channels, the PureSEAN block at 512^2 on maps capped at 256^2)
GENERATOR_CASES = {"nostyle": {}, "nospade": {}, "puresean": {},
                   "32x": dict(start_size=16, crop_size=512, load_size=512, ngf=1,
                               regional_style_size=128, max_fm_size=256, add_noise=False),
                   "32x fold": dict(start_size=16, crop_size=512, load_size=512, ngf=1,
                                    regional_style_size=128, max_fm_size=256,
                                    add_noise=False, fold_upsampled_mod_conv=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GENERATOR_CASES))
def test_generator_on_card_matches_cpu(cuda_device, case):
    """Generators beyond the main path's, float32, on the card (kernels,
    cuDNN, the folded conv as a cuDNN transposed conv) against the CPU:
    1e-4, float32 summation order."""
    from deepsee_torch.models.generator import DeepSEEGenerator

    cfg = dataclasses.replace(tiny_test_experiment().model, **GENERATOR_CASES[case])
    variant = case if case in ("nostyle", "nospade", "puresean") else "deepsee"
    cpu = DeepSEEGenerator(cfg, variant=variant).eval()
    for m in cpu.modules():
        if hasattr(m, "init_params"):
            m.init_params(torch.Generator().manual_seed(0))
    randomize_weights([cpu], torch.Generator().manual_seed(1))
    card = DeepSEEGenerator(cfg, variant=variant).to(cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    s, h = cfg.start_size, cfg.crop_size
    lr = torch.from_numpy(np.tanh(rng.randn(1, 3, s, s)).astype(np.float32))
    seg = torch.from_numpy(np.eye(19, dtype=np.float32)[rng.randint(0, 19, (1, h, h))])
    seg = seg.permute(0, 3, 1, 2)
    style = torch.from_numpy(np.tanh(rng.randn(1, 19, cfg.regional_style_size))
                             .astype(np.float32))
    cl = torch.channels_last
    args = [lr.contiguous(memory_format=cl), seg.contiguous(memory_format=cl), style]
    with torch.inference_mode():
        got = card(*[a.to(cuda_device) for a in args])
        want = cpu(*args)
    assert float(want.std()) > 0.05
    assert float((got.cpu() - want).abs().max()) <= 1e-4


# one shape per variant (and the on-chip one with registers), batch 1, a
# prime H*W, and C=24 (an 8-channel tile)
INSTANCE_SHAPES = {"on-chip": (2, 64, 64, 64), "registers": (1, 32, 256, 256),
                   "streaming": (1, 16, 512, 512), "batch 1": (1, 32, 32, 32),
                   "prime H*W": (2, 64, 37, 41), "C=24": (2, 24, 20, 20)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(INSTANCE_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mod", [False, True])
@pytest.mark.parametrize("lrelu", [False, True])
def test_instance_kernel_matches_plain_on_card(cuda_device, case, dtype, with_mod, lrelu):
    shape = INSTANCE_SHAPES[case]
    plan = mn.instance_plan(shape, dtype)
    if case in ("on-chip", "streaming"):
        assert plan.variant == case
    if case == "registers":
        assert plan.variant == "on-chip" and plan.register_vectors > 0
    x, mod, _, _ = _inputs(cuda_device, dtype, shape=shape, with_mod=with_mod)
    before = mn.launches["instance"]
    got = mn.modnorm(x, mod, stats="instance", lrelu=lrelu)
    torch.cuda.synchronize()
    assert mn.launches["instance"] == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == dtype
    want = mn.modnorm_plain(x, mod, stats="instance", lrelu=lrelu)
    slack = 2e-6 * float(want.float().abs().max())
    if dtype == torch.bfloat16:
        slack = slack + torch.finfo(torch.bfloat16).eps * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= slack).all())


@pytest.mark.cuda
def test_instance_kernel_refuses_a_plan_it_cannot_take(cuda_device, monkeypatch):
    """A plan the kernel cannot take raises before any launch; nothing falls
    back to the plain version or to the other variant."""
    x, _, _, _ = _inputs(cuda_device, torch.bfloat16, with_mod=False, shape=(2, 64, 64, 64))
    good = mn.instance_plan(tuple(x.shape), x.dtype)
    for change in (dict(cluster=32), dict(smem_bytes=300_000), dict(tile=24),
                   dict(variant="split")):
        bad = dataclasses.replace(good, **change)
        monkeypatch.setattr(mn, "instance_plan", lambda shape, dtype, plan=bad: plan)
        before = mn.launches["instance"]
        with pytest.raises(ValueError):
            mn.modnorm(x, stats="instance")
        assert mn.launches["instance"] == before


# -- training: batch statistics, statistics out, the backward -----------------

# (B, C, H, W): the discriminator's odd sizes (65^2, 17^2, 18^2), a
# generator-like batch shape, an 8-channel tile; the b4 step's generator at
# 64^2 (the batch forward on chip) and 256^2 (re-read), and the full trunk
# at 256^2 (the instance backward at an 8-channel bf16 tile)
TRAIN_SHAPES = {"65x65": (4, 64, 65, 65), "17x17": (4, 128, 17, 17), "18x18": (2, 256, 18, 18),
                "generator": (2, 512, 32, 32), "C=24": (3, 24, 20, 20),
                "generator 64^2": (4, 512, 64, 64), "generator 256^2": (4, 512, 256, 256),
                "full trunk": (4, 32, 256, 256)}


def _train_within(got, want, dtype, rel=1e-5):
    """Both sides compute in float32 from the same inputs and round once;
    the statistics and the backward's sums are taken in other orders (chunk
    partials merged with Chan's formula against the plain version's
    reductions): 1e-5 of max|want|; bf16 adds 1 bf16 ulp of |want|."""
    want = want.float()
    slack = rel * float(want.abs().max())
    if dtype == torch.bfloat16:
        slack = slack + torch.finfo(torch.bfloat16).eps * want.abs()
    return bool(((got.float() - want).abs() <= slack).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRAIN_SHAPES))
@pytest.mark.parametrize("stats", ["batch", "instance"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mod,lrelu", [(False, True), (True, True), (True, False)])
def test_train_kernels_match_plain_on_card(cuda_device, case, stats, dtype, with_mod, lrelu):
    shape = TRAIN_SHAPES[case]
    x, mod, _, _ = _inputs(cuda_device, dtype, shape=shape, with_mod=with_mod)
    gout = _inputs(cuda_device, dtype, shape=shape, with_mod=False, seed=1)[0]
    key = "batch" if stats == "batch" else "instance_train"
    before = dict(mn.launches)
    out, mean, rstd = mn.modnorm_train(x, mod, stats=stats, lrelu=lrelu)
    torch.cuda.synchronize()
    assert mn.launches[key] == before[key] + 1
    assert out.is_contiguous(memory_format=torch.channels_last) and out.dtype == dtype
    want, wmean, wrstd = mn.modnorm_train_plain(x, mod, stats=stats, lrelu=lrelu)
    assert mean.shape == wmean.shape and rstd.shape == wrstd.shape
    torch.testing.assert_close(mean, wmean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, wrstd, rtol=1e-5, atol=0)
    assert _train_within(out, want, dtype)
    # the backward on the plain version's statistics, against its plain version
    gx, gmod = mn.modnorm_backward(x, mod, gout, wmean, wrstd, stats=stats, lrelu=lrelu)
    torch.cuda.synchronize()
    assert mn.launches["backward_" + stats] == before["backward_" + stats] + 1
    wgx, wgmod = mn.modnorm_backward_plain(x, mod, gout, wmean, wrstd, stats=stats,
                                           lrelu=lrelu)
    assert gx.is_contiguous(memory_format=torch.channels_last) and gx.dtype == dtype
    assert _train_within(gx, wgx, dtype)
    assert (gmod is None) == (not with_mod)
    if with_mod:
        assert _train_within(gmod, wgmod, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", ["batch", "instance"])
def test_train_autograd_on_card_matches_cpu(cuda_device, stats):
    """A conv -> modnorm_train -> loss graph, float32: the gradients of x,
    the conv weight and mod on the card (kernels) against the CPU (plain
    versions), 1e-4 of the largest; an incoming gradient in NCHW memory is
    copied into channels_last and counted."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 8, 17, 17).astype(np.float32))
    w = torch.from_numpy(0.2 * rng.randn(16, 8, 3, 3).astype(np.float32))
    mod = torch.from_numpy(rng.randn(2, 32, 17, 17).astype(np.float32))
    target = torch.from_numpy(rng.randn(2, 16, 17, 17).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        cl = torch.channels_last
        xs, ws, ms = [t.to(dev).contiguous(memory_format=cl).requires_grad_()
                      for t in (x, w, mod)]
        y = torch.nn.functional.conv2d(xs, ws, padding=1).contiguous(memory_format=cl)
        out, _, _ = mn.modnorm_train(y, ms, stats=stats, lrelu=True)
        mn.reset_launches()
        loss = ((out.contiguous() - target.to(dev)) ** 2).sum()  # NCHW gradient
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(loss, [xs, ws, ms])]
    assert mn.launches["backward_" + stats] == 1 and mn.layout_copies["backward"] == 1
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_train_kernels_refuse_what_they_do_not_take(cuda_device):
    x, mod, _, _ = _inputs(cuda_device, torch.bfloat16, shape=(2, 64, 9, 9))
    out, mean, rstd = mn.modnorm_train(x, mod, stats="batch")
    bad = [
        lambda: mn.modnorm_train(x.contiguous(), mod, stats="batch"),        # NCHW memory
        lambda: mn.modnorm_train(x, mod.float(), stats="instance"),          # mixed dtypes
        lambda: mn.modnorm_backward(x, mod, out.contiguous(), mean, rstd, stats="batch"),
        lambda: mn.modnorm_backward(x, mod, out, mean[:32], rstd[:32], stats="batch"),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("case,variant", [("generator 64^2", "on-chip"),
                                          ("generator 256^2", "re-read")])
def test_batch_forward_plan_on_card(cuda_device, case, variant):
    """The card holds the planned blocks per SM, and the b4 step's 64^2
    shape keeps x on chip while the 256^2 one reads it again."""
    assert mn.batch_blocks_per_sm(torch.bfloat16, True, True) == mn.BATCH_BLOCKS_PER_SM
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert mn.card_sms(cuda_device) == sms
    plan = mn.batch_plan(TRAIN_SHAPES[case], torch.bfloat16,
                         mn.batch_blocks_per_sm(torch.bfloat16, True, True), sms)
    assert plan.variant == variant and plan.grid <= plan.blocks_per_sm * sms


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["generator 64^2", "generator 256^2"])
def test_batch_forward_statistics_hold_far_from_the_mean_on_card(cuda_device, case, dtype):
    """x = 50 + 1.5 randn with the first pixel of every image and of every
    run of the plan 20 sigma off: mean and rstd against float64 on the same
    values (the mean to 1e-6 of |mean|, rstd to 1e-5), and the output against
    the plain version."""
    shape = TRAIN_SHAPES[case]
    b, c, h, w = shape
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = (torch.randn((b, h, w, c), generator=g, device=cuda_device) * 1.5 + 50.0).to(dtype)
    x[:, 0, 0] = 80.0
    plan = mn.batch_plan(shape, dtype, mn.batch_blocks_per_sm(dtype, False, False),
                         mn.card_sms(cuda_device))
    flat = x.view(-1, c)
    for start, _ in mn.instance_chunks(b * h * w, plan.runs):
        flat[start] = 80.0
    x = x.permute(0, 3, 1, 2)  # (B, C, H, W) in channels_last memory
    out, mean, rstd = mn.modnorm_train(x, None, stats="batch")
    torch.cuda.synchronize()
    xd = flat.double()
    torch.testing.assert_close(mean.double(), xd.mean(0), rtol=1e-6, atol=0)
    want_rstd = torch.rsqrt(xd.var(0, unbiased=False) + 1e-5)
    torch.testing.assert_close(rstd.double(), want_rstd, rtol=1e-5, atol=0)
    want, _, _ = mn.modnorm_train_plain(x, None, stats="batch")
    assert _train_within(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["generator 64^2", "generator 256^2", "full trunk", "65x65"])
def test_train_kernels_are_deterministic_on_card(cuda_device, case, dtype):
    """Two calls of the batch forward and of the instance backward give
    bit-identical outputs, statistics and gradients (fixed merge orders, no
    float atomics)."""
    shape = TRAIN_SHAPES[case]
    stats = "instance" if case in ("full trunk", "65x65") else "batch"
    x, mod, _, _ = _inputs(cuda_device, dtype, shape=shape, with_mod=stats == "batch")
    gout = _inputs(cuda_device, dtype, shape=shape, with_mod=False, seed=1)[0]
    if stats == "batch":
        first = mn.modnorm_train(x, mod, stats=stats, lrelu=True)
        second = mn.modnorm_train(x, mod, stats=stats, lrelu=True)
    else:
        _, mean, rstd = mn.modnorm_train(x, mod, stats=stats, lrelu=True)
        first = mn.modnorm_backward(x, mod, gout, mean, rstd, stats=stats, lrelu=True)
        second = mn.modnorm_backward(x, mod, gout, mean, rstd, stats=stats, lrelu=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_train_kernels_refuse_a_plan_they_cannot_take(cuda_device, monkeypatch):
    """A plan the batch forward or the instance backward cannot take raises
    before any launch, from the Python check or, past it, from the C entry;
    nothing falls back to the plain version or to another kernel."""
    x, mod, _, _ = _inputs(cuda_device, torch.bfloat16, shape=(4, 64, 32, 32))
    gout = _inputs(cuda_device, torch.bfloat16, shape=(4, 64, 32, 32), with_mod=False)[0]
    _, mean, rstd = mn.modnorm_train(x, mod, stats="instance")
    good = mn.batch_plan(tuple(x.shape), x.dtype)
    bad_batch = [dataclasses.replace(good, runs=good.runs * 40, grid=good.grid * 40),
                 dataclasses.replace(good, tile=24)]
    good_bwd = mn.instance_backward_plan(tuple(x.shape), x.dtype, True)
    bad_bwd = [dataclasses.replace(good_bwd, smem_bytes=16), dataclasses.replace(good_bwd,
                                                                                 cluster=32)]
    for checked in (True, False):
        if not checked:  # past the Python check, the C entry refuses
            monkeypatch.setattr(mn, "check_batch_plan", lambda *a: None)
            monkeypatch.setattr(mn, "check_instance_backward_plan", lambda *a: None)
        for bad in bad_batch:
            monkeypatch.setattr(mn, "batch_plan", lambda *a, plan=bad: plan)
            before = dict(mn.launches)
            with pytest.raises(ValueError if checked else RuntimeError):
                mn.modnorm_train(x, mod, stats="batch")
            assert mn.launches == before
        for bad in bad_bwd:
            monkeypatch.setattr(mn, "instance_backward_plan", lambda *a, plan=bad: plan)
            before = dict(mn.launches)
            with pytest.raises(ValueError if checked else RuntimeError):
                mn.modnorm_backward(x, mod, gout, mean, rstd, stats="instance")
            assert mn.launches == before


@pytest.mark.cuda
def test_avg_pool_gradient_on_card_matches_float64(cuda_device):
    """The discriminator's 3x3 / 2 pooling (count_include_pad=False) from a
    channels_last float32 input on the card: output and input gradient
    against float64 on the CPU, 1e-6 relative L2 (PyTorch's channels_last
    CUDA backward of this pooling is wrong; the port pools contiguous
    memory)."""
    from deepsee_torch.ops.pooling import avg_pool_3x3_s2

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 22, 128, 128))
    r = torch.from_numpy(rng.randn(2, 22, 64, 64))
    xd = x.clone().requires_grad_()
    want = torch.nn.functional.avg_pool2d(xd, 3, 2, 1, count_include_pad=False)
    (gwant,) = torch.autograd.grad((want * r).sum(), [xd])
    xc = x.float().to(cuda_device).contiguous(memory_format=torch.channels_last)
    xc.requires_grad_()
    got = avg_pool_3x3_s2(xc)
    (gx,) = torch.autograd.grad((got * r.float().to(cuda_device)).sum(), [xc])
    for a, b in ((got.detach(), want.detach()), (gx, gwant)):
        assert float((a.double().cpu() - b).norm() / b.norm()) <= 1e-6


# -- the copy of host batches to the card (deepsee_torch/data/device.py) ---------

@pytest.mark.cuda
def test_staging_buffer_is_not_refilled_before_its_copy_lands(cuda_device):
    """The copy stream is held back by a sleep, so every copy is still
    pending when the host stages the batches after it (the pinned allocator
    must not hand a pending copy's block out again), and each host array is
    overwritten once staged: every batch on the card must still hold its
    own values."""
    from deepsee_torch.data import DevicePrefetcher

    feed = DevicePrefetcher(cuda_device)
    n, shape = 6, (4, 256, 256, 3)

    def host_batches():
        for i in range(n):
            arr = np.full(shape, float(i), np.float32)
            yield {"image_hr": arr, "path": [f"{i}.jpg"]}
            arr[...] = -1.0  # the loader reuses its memory once the batch is staged

    with torch.cuda.stream(feed.stream):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of the copy stream
    seen = []
    for i, batch in enumerate(feed(host_batches())):
        assert batch["path"] == [f"{i}.jpg"] and batch["image_hr"].is_cuda
        torch.cuda._sleep(20_000_000)  # the consumer's work on the batch
        seen.append(bool((batch["image_hr"] == float(i)).all()))
    torch.cuda.synchronize()
    assert seen == [True] * n


@pytest.mark.cuda
def test_prefetched_batches_equal_blocking_copies(cuda_device):
    """A loader's batches through the prefetcher and through the one-batch
    pinned copy equal a blocking copy of the same arrays, keys, dtypes and
    host lists included."""
    from deepsee_torch.data import DataLoader, DevicePrefetcher, SyntheticDataset, to_device

    exp = tiny_test_experiment()
    exp = exp.replace(model=dataclasses.replace(exp.model, net_e="fullstyle",
                                                guiding_style_image=True))
    loader = DataLoader(SyntheticDataset(exp, length=12), 3, shuffle=False)
    host = list(loader)
    for got in (list(DevicePrefetcher(cuda_device)(host)),
                [to_device(b, cuda_device) for b in host]):
        torch.cuda.synchronize()
        assert len(got) == len(host) == 4
        for g, h in zip(got, host):
            assert set(g) == set(h) and g["path"] == h["path"]
            for key in ("image_hr", "label", "guiding_image", "guiding_label"):
                want = torch.from_numpy(h[key]).to(cuda_device)
                assert g[key].dtype == want.dtype and g[key].is_cuda
                assert torch.equal(g[key], want), key


# K1's batch modes split around the cross-rank collective: launch A (the
# statistics), launch B (the merge of the ranks' rows and the apply), the
# backward's sums and its elementwise pass, at the generator's batch shapes
# of the b16 step (16 rows of 512 channels at 32^2 .. 256^2) and of the
# two-rank b8 step, cut into two "ranks" of 8 or 4 rows in one process; the
# rows' sum stands for the all-reduce.
SPLIT_SHAPES = {f"b{b} {hw}^2": (b, 512, hw, hw) for b in (16, 8) for hw in (32, 64, 128, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SPLIT_SHAPES))
def test_split_kernels_match_plain_on_card(cuda_device, case, dtype):
    """Each launch against its plain version on the same inputs (the
    statistics 1e-5 relative, the outputs as `_train_within`), and the
    merged statistics against the one-launch kernel's over the whole batch."""
    shape = SPLIT_SHAPES[case]
    x, mod, _, _ = _inputs(cuda_device, dtype, shape=shape)
    gout = _inputs(cuda_device, dtype, shape=shape, with_mod=False, seed=1)[0]
    xs, ms, gs = x.chunk(2), mod.chunk(2), gout.chunk(2)
    before = dict(mn.launches)
    partials = sum(mn.modnorm_batch_partials(s, r, 2) for r, s in enumerate(xs))
    torch.cuda.synchronize()
    want_partials = torch.stack([mn.modnorm_batch_partials_plain(s) for s in xs])
    assert torch.equal(partials[:, 0], want_partials[:, 0])  # the counts
    torch.testing.assert_close(partials[:, 1:], want_partials.to(cuda_device)[:, 1:],
                               rtol=1e-5, atol=1e-6)
    whole = mn.modnorm_train(x, mod, stats="batch", lrelu=True)
    for s, m in zip(xs, ms):
        out, mean, rstd = mn.modnorm_batch_apply(s, m, partials, lrelu=True)
        torch.cuda.synchronize()
        want, wmean, wrstd = mn.modnorm_batch_apply_plain(s, m, partials, lrelu=True)
        # the same merge in the same order; the card may contract a multiply
        # and an add into one fma
        torch.testing.assert_close(mean, wmean, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(rstd, wrstd, rtol=1e-6, atol=0)
        torch.testing.assert_close(mean, whole[1], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(rstd, whole[2], rtol=1e-5, atol=0)
        assert out.is_contiguous(memory_format=torch.channels_last) and out.dtype == dtype
        assert _train_within(out, want, dtype)
        del out, want
    _, mean, rstd = mn.modnorm_batch_apply(xs[0], ms[0], partials, lrelu=True)
    sums = sum(mn.modnorm_backward_sums(s, m, g, mean, rstd, lrelu=True)
               for s, m, g in zip(xs, ms, gs))
    torch.cuda.synchronize()
    want_sums = sum(mn.modnorm_backward_sums_plain(s, m, g, mean, rstd, lrelu=True)
                    for s, m, g in zip(xs, ms, gs))
    torch.testing.assert_close(sums, want_sums, rtol=1e-5,
                               atol=1e-5 * float(want_sums.abs().max()))
    count = shape[0] * shape[2] * shape[3]
    for s, m, g in zip(xs, ms, gs):
        gx, gmod = mn.modnorm_backward_apply(s, m, g, mean, rstd, sums, count, lrelu=True)
        torch.cuda.synchronize()
        wgx, wgmod = mn.modnorm_backward_apply_plain(s, m, g, mean, rstd, sums, count,
                                                     lrelu=True)
        assert _train_within(gx, wgx, dtype) and _train_within(gmod, wgmod, dtype)
        del gx, gmod, wgx, wgmod
    launched = {k: mn.launches[k] - before[k] for k in mn.launches}
    assert launched == dict.fromkeys(mn.launches, 0) | {
        "batch_partials": 2, "batch_apply": 3, "backward_sums": 2, "backward_apply": 2,
        "batch": 1}
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_statistics_hold_for_shards_far_apart_on_card(cuda_device, dtype):
    """Two shards whose means lie 50 sigma apart (N(0, 1.5) and N(75, 1.5)):
    the merged mean and rstd against float64 over the whole batch (the mean
    to 1e-6 of its size, rstd to 1e-5): Chan's merge of the shards keeps
    the digits that E[x^2] - E[x]^2 in float32 would lose."""
    b, c, h, w = SPLIT_SHAPES["b16 64^2"]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((b, h, w, c), generator=g, device=cuda_device) * 1.5
    x[b // 2:] += 75.0
    x = x.to(dtype)
    flat = x.view(-1, c)
    x = x.permute(0, 3, 1, 2)  # (B, C, H, W) in channels_last memory
    xs = x.chunk(2)
    partials = sum(mn.modnorm_batch_partials(s, r, 2) for r, s in enumerate(xs))
    out, mean, rstd = mn.modnorm_batch_apply(xs[1], None, partials)
    torch.cuda.synchronize()
    xd = flat.double()
    torch.testing.assert_close(mean.double(), xd.mean(0), rtol=1e-6, atol=0)
    want_rstd = torch.rsqrt(xd.var(0, unbiased=False) + 1e-5)
    torch.testing.assert_close(rstd.double(), want_rstd, rtol=1e-5, atol=0)
    want = mn.modnorm_batch_apply_plain(xs[1], None, partials)[0]
    assert _train_within(out, want, dtype)


@pytest.mark.cuda
def test_split_kernels_at_one_rank_are_the_one_process_kernels(cuda_device):
    """World 1: the backward's sums and pass give the one-process backward bit
    for bit (the same reduction, sums divided by the same count), and A + B
    the one-launch forward within its statistics' sum order."""
    x, mod, _, _ = _inputs(cuda_device, torch.bfloat16, shape=(4, 512, 64, 64))
    gout = _inputs(cuda_device, torch.bfloat16, shape=(4, 512, 64, 64), with_mod=False,
                   seed=1)[0]
    out, mean, rstd = mn.modnorm_train(x, mod, stats="batch", lrelu=True)
    got = mn.modnorm_batch_apply(x, mod, mn.modnorm_batch_partials(x), lrelu=True)
    torch.testing.assert_close(got[1], mean, rtol=1e-6, atol=1e-6)
    assert _train_within(got[0], out, torch.bfloat16)
    sums = mn.modnorm_backward_sums(x, mod, gout, mean, rstd, lrelu=True)
    split = mn.modnorm_backward_apply(x, mod, gout, mean, rstd, sums, 4 * 64 * 64, lrelu=True)
    whole = mn.modnorm_backward(x, mod, gout, mean, rstd, stats="batch", lrelu=True)
    torch.cuda.synchronize()
    for a, b in zip(split, whole):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_split_kernels_refuse_what_they_do_not_take(cuda_device):
    x, mod, _, _ = _inputs(cuda_device, torch.bfloat16, shape=(2, 64, 9, 9))
    partials = mn.modnorm_batch_partials(x, 0, 2)
    _, mean, rstd = mn.modnorm_batch_apply(x, mod, partials)
    sums = mn.modnorm_backward_sums(x, mod, x, mean, rstd)
    bad = [
        lambda: mn.modnorm_batch_partials(x.contiguous(), 0, 2),           # NCHW memory
        lambda: mn.modnorm_batch_partials(x, 2, 2),                        # no such rank
        lambda: mn.modnorm_batch_apply(x, mod, partials[:, :2]),           # not (world, 3, C)
        lambda: mn.modnorm_batch_apply(x, mod, partials.double()),
        lambda: mn.modnorm_backward_sums(x, mod, x, mean[:32], rstd[:32]),
        lambda: mn.modnorm_backward_apply(x, mod, x, mean, rstd, sums[:1], 162.0),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


# -- the int8 conv (K4) --------------------------------------------------------

# name: (x (B, Cin, H, W), weight (Cout, Cin, k, k), stride, padding)
INT8_SHAPES = {
    "conv 512 64^2": ((4, 512, 64, 64), (512, 512, 3, 3), 1, 1),
    "mod conv 256->1024": ((2, 256, 64, 64), (1024, 256, 3, 3), 1, 1),
    "down1 stride 2": ((4, 64, 128, 128), (128, 64, 3, 3), 2, 1),
    "cin 72": ((3, 72, 19, 23), (40, 72, 3, 3), 1, 1),
    "1x1": ((4, 512, 32, 32), (256, 512, 1, 1), 1, 0),
    "7x5 cp 64 cout 20": ((2, 64, 7, 5), (20, 64, 3, 3), 1, 1),
    "stride 2 19x23": ((2, 128, 19, 23), (256, 128, 3, 3), 2, 1),
}


def _int8_inputs(device, dtype, case, seed=0):
    """Channel ranges over three decades, one channel all zero (its max is 0:
    s_c takes the clamped 1e-8, s_x the unclamped 0), a bias."""
    (b, c, h, w), wshape, stride, pad = INT8_SHAPES[case]
    g = torch.Generator(device=device).manual_seed(seed)
    scales = torch.logspace(-2, 1, c, device=device)[:, None, None]
    x = torch.randn((b, c, h, w), generator=g, device=device) * scales
    x[:, 0] = 0.0
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    weight = torch.randn(wshape, generator=g, device=device) * 0.05
    bias = torch.randn(wshape[0], generator=g, device=device) * 0.1
    return x, weight, bias, stride, pad


def _within_one_ulp(got, want, dtype):
    want = want.float()
    mag = want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag))) * torch.finfo(dtype).eps
    return bool(((got.float() - want).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("case", list(INT8_SHAPES))
def test_int8_kernels_match_plain_on_card(cuda_device, case, smooth, dtype):
    """(a) the channel maxima, (b) s_c, s_k, s_x bit for bit and k_q equal,
    (c) x_q equal (padding channels zero), (d) the output within one ulp of
    the plain float64 product's; the op is (a)-(d)."""
    x, weight, bias, stride, pad = _int8_inputs(cuda_device, dtype, case)
    cin = x.shape[1]
    want = ic.quantize_plain(x, weight, smooth)
    before = dict(ic.launches)
    mx_raw, mx = ic.absmax_channels(x)
    s_c, s_k, s_x, k_q = ic.quantize_weight(weight, mx_raw, mx, smooth)
    x_q = ic.quantize_activation(x, s_c, s_x)
    y = ic.int8_conv_igemm(x_q, k_q, s_x, s_k, bias, stride, pad, dtype)
    torch.cuda.synchronize()
    assert {k: ic.launches[k] - before[k] for k in before} == dict.fromkeys(before, 1)
    for got, ref in ((mx_raw, want.mx_raw), (mx, want.mx), (s_c, want.s_c), (s_k, want.s_k),
                     (s_x, want.s_x)):
        assert torch.equal(got, ref)
    assert torch.equal(k_q[..., :cin].permute(0, 3, 1, 2), want.k_q)
    assert not bool(k_q[..., cin:].any())
    assert torch.equal(x_q[:, :cin], want.x_q) and not bool(x_q[:, cin:].any())
    ref = ic.igemm_plain(want.x_q, want.k_q, want.s_x, want.s_k, bias, stride, pad, dtype)
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    assert y.shape == ref.shape and _within_one_ulp(y, ref, dtype)
    whole = ic.int8_conv(x, weight, bias, stride, pad, smooth)
    torch.cuda.synchronize()
    assert torch.equal(whole, y)


@pytest.mark.cuda
def test_int8_conv_in_a_cuda_graph(cuda_device):
    """The op's four kernels and its allocations captured in a CUDA graph:
    a replay on new inputs equals an eager call on them."""
    x, weight, bias, stride, pad = _int8_inputs(cuda_device, torch.bfloat16, "conv 512 64^2")
    static_x = x.clone(memory_format=torch.channels_last)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ic.int8_conv(static_x, weight, bias, stride, pad)  # warm-up: build and load
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ic.int8_conv(static_x, weight, bias, stride, pad)
    fresh = _int8_inputs(cuda_device, torch.bfloat16, "conv 512 64^2", seed=1)[0]
    static_x.copy_(fresh)
    before = dict(ic.launches)
    graph.replay()
    torch.cuda.synchronize()
    assert ic.launches == before  # a replay launches nothing through the wrappers
    assert torch.equal(out, ic.int8_conv(fresh, weight, bias, stride, pad))


@pytest.mark.cuda
def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x, weight, bias, stride, pad = _int8_inputs(cuda_device, torch.bfloat16, "cin 72")
    mx_raw, mx = ic.absmax_channels(x)
    s_c, s_k, s_x, k_q = ic.quantize_weight(weight, mx_raw, mx, True)
    x_q = ic.quantize_activation(x, s_c, s_x)
    bad = [
        lambda: ic.absmax_channels(x.contiguous()),                        # NCHW memory
        lambda: ic.absmax_channels(x.half()),                              # float16
        lambda: ic.quantize_weight(weight.bfloat16(), mx_raw, mx, True),   # not float32
        lambda: ic.quantize_weight(weight, mx_raw[:8], mx[:8], True),      # not (Cin,)
        lambda: ic.quantize_activation(x, s_c[:8], s_x),
        lambda: ic.int8_conv_igemm(x_q, k_q[..., :72].contiguous(), s_x, s_k, bias, 1, 1,
                                   torch.bfloat16),                        # Cp differs
        lambda: ic.int8_conv_igemm(x_q, k_q, s_x, s_k, bias, 1, 1, torch.float16),
        lambda: ic.int8_conv_igemm(x_q, k_q, s_x, s_k, bias, 9, 1,
                                   torch.bfloat16),                        # TMA: stride <= 8
        lambda: ic.int8_conv(x, weight.cpu(), bias, 1, 1),                 # weight on the CPU
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


# (d) alone at ragged shapes: x (B, Cin, H, W), weight (Cout, Cin, kh, kw),
# stride, padding; the tile's rectangle and N tile stick out of each
IGEMM_SHAPES = {
    "19x23 cin 72 (Cp 80) cout 40": ((3, 72, 19, 23), (40, 72, 3, 3), 1, 1),
    "7x5 Cp 64 cout 20": ((3, 64, 7, 5), (20, 64, 3, 3), 1, 1),
    "stride 2 19x23": ((2, 128, 19, 23), (256, 128, 3, 3), 2, 1),
    "stride 2 Cp 64 cout 40": ((2, 64, 33, 17), (40, 64, 3, 3), 2, 1),
    "1x1 cout 300": ((2, 512, 9, 13), (300, 512, 1, 1), 1, 0),
    "M not a multiple of 128, two N tiles": ((3, 256, 13, 11), (264, 256, 3, 3), 1, 1),
    "Cp 16 cout 36": ((2, 8, 21, 10), (36, 8, 3, 3), 1, 1),
    "a row wider than 128": ((1, 128, 4, 150), (128, 128, 3, 3), 1, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(IGEMM_SHAPES))
def test_int8_igemm_equals_plain_at_ragged_shapes(cuda_device, case, dtype, with_bias):
    """(d) on the plain version's x_q and k_q: the same exact s32 sums and the
    same float epilogue, so the output equals `igemm_plain`'s bit for bit
    (a row of a rectangle outside the image, written, would land on another
    pixel's row)."""
    xshape, wshape, stride, pad = IGEMM_SHAPES[case]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn(xshape, generator=g, device=cuda_device)
         * torch.logspace(-1, 1, xshape[1], device=cuda_device)[:, None, None])
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    weight = torch.randn(wshape, generator=g, device=cuda_device) * 0.05
    bias = torch.randn(wshape[0], generator=g, device=cuda_device) * 0.1 if with_bias else None
    q = ic.quantize_plain(x, weight, True)
    cin, cp = xshape[1], ic.padded_channels(xshape[1])
    x_q = torch.zeros((xshape[0], cp) + xshape[2:], dtype=torch.int8, device=cuda_device)
    x_q[:, :cin] = q.x_q
    x_q = x_q.contiguous(memory_format=torch.channels_last)
    k_q = torch.zeros(wshape[:1] + wshape[2:] + (cp,), dtype=torch.int8, device=cuda_device)
    k_q[..., :cin] = q.k_q.permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    before = ic.launches["igemm"]
    y = ic.int8_conv_igemm(x_q, k_q, q.s_x, q.s_k, bias, stride, pad, dtype)
    torch.cuda.synchronize()
    assert ic.launches["igemm"] == before + 1
    ref = ic.igemm_plain(q.x_q, q.k_q, q.s_x, q.s_k, bias, stride, pad, dtype)
    assert y.shape == ref.shape and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, ref)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.cuda
def test_int8_division_by_reciprocal_equals_fdiv_rn(cuda_device):
    """(c) divides by its per-channel constants through RN(1/b) and two FMA
    corrections where `divisor_ok` and `numerator_ok` hold, and with
    __fdiv_rn elsewhere: over 2^24 random float32 bit patterns (every
    exponent: zeros, subnormals, infinities, NaNs) and 2^20 values at the
    edges of the route's range, against divisors spread over the range s_c
    and s_x take and its ends, the route's quotient equals __fdiv_rn's bit
    for bit wherever (c) takes it, and __fdiv_rn equals the plain version's
    float64 division."""
    rng = np.random.default_rng(11)
    n = 1 << 24
    a = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    edge_exps = np.array([-64.0, -63.0, -62.0, -60.0, -1.0, 0.0, 1.0, 62.0, 63.0, 64.0])
    edges = (np.ldexp(rng.uniform(1.0, 2.0, 1 << 20), rng.choice(edge_exps, 1 << 20).astype(int))
             * rng.choice([-1.0, 1.0], 1 << 20)).astype(np.float32)
    specials = np.array([0.0, -0.0, np.float32(2.0 ** -64), -np.float32(2.0 ** 64),
                         np.nextafter(np.float32(2.0 ** -64), np.float32(0)),
                         np.nextafter(np.float32(2.0 ** 64), np.float32(np.inf)),
                         np.finfo(np.float32).tiny, np.finfo(np.float32).max, 1e-45,
                         np.inf, -np.inf], np.float32)
    a = np.concatenate([a, edges, specials])
    b = np.exp(rng.uniform(np.log(1e-6), np.log(1e6), a.size)).astype(np.float32)
    b_edges = np.array([2.0 ** -60, 2.0 ** 60, np.nextafter(np.float32(2.0), np.float32(0)), 1.0,
                        np.nextafter(np.float32(2.0 ** -60), np.float32(0)),
                        np.nextafter(np.float32(2.0 ** 60), np.float32(np.inf)),
                        7.874016e-11, 3.0], np.float32)
    pick = rng.random(a.size) < 0.05
    b[pick] = rng.choice(b_edges, int(pick.sum()))
    at = torch.from_numpy(a).to(cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    fast, ieee, used = ic.divide_check(at, bt)
    torch.cuda.synchronize()
    assert float(used.float().mean()) > 0.5            # the route is what is tested
    assert torch.equal(_bits(fast[used]), _bits(ieee[used]))
    plain = ic._div_rn(torch.from_numpy(a), torch.from_numpy(b))
    finite = torch.from_numpy(~np.isnan(a))
    assert torch.equal(_bits(ieee.cpu()[finite]), _bits(plain[finite]))


QUANT_CINS = [3, 20, 64, 72, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin", QUANT_CINS)
def test_int8_quantize_activation_equals_plain(cuda_device, cin, dtype):
    """(c) against `quantize_activation_plain` bit for bit (x_q, padding
    channels zero) on SmoothQuant scales, whatever Cin is; then on chosen
    s_c and s_x against the plain float64 divisions, with zeros of both
    signs, subnormals, huge values and infinities among the inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(cin)
    shape = (3, cin, 17, 29)
    x = (torch.randn(shape, generator=g, device=cuda_device)
         * torch.logspace(-2, 1, cin, device=cuda_device)[:, None, None])
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    weight = torch.randn((16, cin, 3, 3), generator=g, device=cuda_device) * 0.05
    mx_raw, mx = ic.absmax_channels_plain(x)
    s_c = ic.smooth_scales_plain(weight, mx, True)
    s_x, want = ic.quantize_activation_plain(x, s_c)
    got = ic.quantize_activation(x, s_c, s_x)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :cin], want) and not bool(got[:, cin:].any())

    special = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e-30, 3e38, -3e38, float("inf"),
                            float("-inf"), 2.0 ** -64, 2.0 ** 64, 1e-5, 0.5, 127.5],
                           device=cuda_device)
    x2 = x.float().clone()
    flat = x2.permute(0, 2, 3, 1).reshape(-1)       # a view: NHWC order
    idx = torch.randint(0, flat.numel(), (4096,), generator=g, device=cuda_device)
    flat[idx] = special[torch.arange(4096, device=cuda_device) % special.numel()]
    x2 = x2.to(dtype).contiguous(memory_format=torch.channels_last)
    s_c2 = torch.exp(torch.empty(cin, device=cuda_device).uniform_(-6, 6, generator=g))
    s_c2[0] = 1.0
    s_x2 = torch.tensor(0.0123, device=cuda_device)
    got2 = ic.quantize_activation(x2, s_c2, s_x2)
    xs = ic._div_rn(x2.float(), s_c2[:, None, None])
    want2 = torch.clamp(torch.round(ic._div_rn(xs, s_x2)), -127, 127).to(torch.int8)
    torch.cuda.synchronize()
    assert torch.equal(got2[:, :cin], want2) and not bool(got2[:, cin:].any())
