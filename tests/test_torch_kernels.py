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
