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


# one shape per variant (and the on-chip one with registers), batch 1 (at
# 256^2 and 512^2 the grid variant), a prime H*W, and C=24 (an 8-channel tile)
INSTANCE_SHAPES = {"on-chip": (2, 64, 64, 64), "registers": (16, 32, 256, 256),
                   "streaming": (8, 32, 512, 512), "batch 1": (1, 32, 32, 32),
                   "batch 1 256^2": (1, 32, 256, 256), "batch 1 512^2": (1, 16, 512, 512),
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
    if case.startswith("batch 1 "):
        assert plan.variant == "grid"
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
        monkeypatch.setattr(mn, "instance_plan", lambda shape, dtype, *_, plan=bad: plan)
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


# (B, C, H, W, lrelu) of the instance forward with statistics out in a
# faithful b4 step of 8x_independent_256x256 (the full and mini trunks, the
# discriminator on 2B = 8), and H*W of 1 and 17^2
STATS_OUT_SHAPES = {
    "full 256^2": (4, 32, 256, 256, True), "full down0": (4, 64, 128, 128, True),
    "full down1": (4, 128, 64, 64, True), "full up": (4, 256, 128, 128, True),
    "full head": (4, 128, 128, 128, False), "mini 32 32": (4, 32, 32, 32, True),
    "mini 64 32": (4, 64, 32, 32, True), "mini 128 32": (4, 128, 32, 32, True),
    "mini 256 64": (4, 256, 64, 64, True), "mini head": (4, 128, 64, 64, False),
    "D 65": (8, 64, 65, 65, True), "D 33": (8, 128, 33, 33, True), "D 34": (8, 256, 34, 34, True),
    "D2 33": (8, 64, 33, 33, True), "D2 17": (8, 128, 17, 17, True),
    "D2 18": (8, 256, 18, 18, True), "H*W 1": (4, 64, 1, 1, True), "17^2": (4, 64, 17, 17, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(STATS_OUT_SHAPES))
def test_instance_stats_out_matches_plain_at_training_shapes(cuda_device, case, dtype):
    """The instance forward with statistics out under the plan `instance_plan`
    chooses: out, mean and rstd within `_train_within` of the plain
    version's, one launch, and a second call bit for bit the first."""
    *shape, lrelu = STATS_OUT_SHAPES[case]
    x, _, _, _ = _inputs(cuda_device, dtype, shape=tuple(shape), with_mod=False)
    before = mn.launches["instance_train"]
    first = mn.modnorm_train(x, stats="instance", lrelu=lrelu)
    second = mn.modnorm_train(x, stats="instance", lrelu=lrelu)
    torch.cuda.synchronize()
    assert mn.launches["instance_train"] == before + 2
    want, wmean, wrstd = mn.modnorm_train_plain(x, stats="instance", lrelu=lrelu)
    out, mean, rstd = first
    assert _train_within(out, want, dtype)
    torch.testing.assert_close(mean, wmean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, wrstd, rtol=1e-5, atol=0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("runs", ["one", "two", "fill"])
@pytest.mark.parametrize("case", ["full 256^2", "mini 256 64", "D 65", "D2 17", "17^2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mod", [False, True])
def test_instance_grid_variant_matches_plain_on_card(cuda_device, monkeypatch, runs, case,
                                                     dtype, with_mod):
    """The grid variant at one run per slab (no grid barrier; as few as
    GRID_RUN_VECTORS allows on a 256^2 slab), two, and as many as fill the
    card (runs merged across the barrier, the rest of a
    long run streamed), whatever `instance_plan` would choose: the training
    forward within `_train_within` of its plain version and the inference
    op within the instance tolerance, each one launch."""
    *shape, lrelu = STATS_OUT_SHAPES[case]
    shape = tuple(shape)
    b, c, h, w = shape
    tile = mn._widest(c, 4 if dtype == torch.float32 else 2, mn.LINE, 2 * mn.SECTOR, mn.SECTOR,
                      16)
    sms = mn.card_sms(cuda_device)
    k = {"one": 1, "two": 2, "fill": max(1, mn.BATCH_BLOCKS_PER_SM * sms // (b * c // tile))}
    # no run longer than GRID_RUN_VECTORS: a 256^2 slab takes several
    least = -(-h * w * tile * (4 if dtype == torch.float32 else 2) // 16 // mn.GRID_RUN_VECTORS)
    plan = mn._instance_candidates(shape, dtype, "grid", tile,
                                   [min(max(k[runs], least), h * w)])[0]
    mn.check_instance_plan(plan, shape, dtype, sms)
    monkeypatch.setattr(mn, "instance_plan", lambda *a, **kw: plan)
    x, mod, _, _ = _inputs(cuda_device, dtype, shape=shape, with_mod=with_mod)
    before = dict(mn.launches)
    out, mean, rstd = mn.modnorm_train(x, mod, stats="instance", lrelu=lrelu)
    got = mn.modnorm(x, mod, stats="instance", lrelu=lrelu)
    torch.cuda.synchronize()
    assert mn.launches["instance_train"] == before["instance_train"] + 1
    assert mn.launches["instance"] == before["instance"] + 1
    want, wmean, wrstd = mn.modnorm_train_plain(x, mod, stats="instance", lrelu=lrelu)
    assert _train_within(out, want, dtype)
    torch.testing.assert_close(mean, wmean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, wrstd, rtol=1e-5, atol=0)
    want = mn.modnorm_plain(x, mod, stats="instance", lrelu=lrelu)
    slack = 2e-6 * float(want.float().abs().max())
    if dtype == torch.bfloat16:
        slack = slack + torch.finfo(torch.bfloat16).eps * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= slack).all())


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


# K1's instance mode split across the stripes of a map (spatial sharding):
# the partials launch, the merge-and-apply launch, the backward's sums and its
# apply, at the shapes of the 32x 512^2 spatial step at two ranks (the full
# trunk's first maps, D's uneven stripes) and a few small ones, each map cut
# into two uneven "ranks" of rows in one process; the rows' sum stands for
# the all-reduce.
SPLIT_INSTANCE_SHAPES = {"E 512^2 b1": ((1, 32, 512, 512), 256),
                         "E 256^2 b1": ((1, 256, 256, 256), 128),
                         "D 129 b2": ((2, 64, 129, 257), 64),
                         "D 66 b4": ((4, 256, 66, 66), 32),
                         "small": ((3, 16, 9, 7), 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mod", [True, False])
@pytest.mark.parametrize("case", list(SPLIT_INSTANCE_SHAPES))
def test_instance_split_kernels_match_plain_on_card(cuda_device, case, with_mod, dtype):
    """Each launch against its plain version on the same inputs, the merged
    statistics against the one-launch instance kernel's over the whole map,
    and one launch per stage and stripe."""
    shape, cut = SPLIT_INSTANCE_SHAPES[case]
    x, mod, _, _ = _inputs(cuda_device, dtype, shape=shape, with_mod=with_mod)
    gout = _inputs(cuda_device, dtype, shape=shape, with_mod=False, seed=1)[0]
    cl = torch.channels_last

    def stripes(t):
        return [] if t is None else [t[:, :, :cut].contiguous(memory_format=cl),
                                     t[:, :, cut:].contiguous(memory_format=cl)]

    xs, gs = stripes(x), stripes(gout)
    ms = stripes(mod) or [None, None]
    before = dict(mn.launches)
    partials = sum(mn.modnorm_instance_partials(s, r, 2) for r, s in enumerate(xs))
    torch.cuda.synchronize()
    want_partials = torch.stack([mn.modnorm_instance_partials_plain(s) for s in xs])
    assert torch.equal(partials[:, 0], want_partials[:, 0])  # the counts
    torch.testing.assert_close(partials[:, 1:], want_partials[:, 1:], rtol=1e-5, atol=1e-5)
    whole = mn.modnorm_train(x, mod, stats="instance", lrelu=True)
    for s, m in zip(xs, ms):
        out, mean, rstd = mn.modnorm_instance_apply(s, m, partials, lrelu=True)
        torch.cuda.synchronize()
        want, wmean, wrstd = mn.modnorm_instance_apply_plain(s, m, partials, lrelu=True)
        torch.testing.assert_close(mean, wmean, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(rstd, wrstd, rtol=1e-6, atol=0)
        torch.testing.assert_close(mean, whole[1], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rstd, whole[2], rtol=1e-5, atol=0)
        assert out.is_contiguous(memory_format=cl) and out.dtype == dtype
        assert _train_within(out, want, dtype)
    _, mean, rstd = mn.modnorm_instance_apply(xs[0], ms[0], partials, lrelu=True)
    sums = sum(mn.modnorm_instance_backward_sums(s, m, g, mean, rstd, lrelu=True)
               for s, m, g in zip(xs, ms, gs))
    torch.cuda.synchronize()
    want_sums = sum(mn.modnorm_instance_backward_sums_plain(s, m, g, mean, rstd, lrelu=True)
                    for s, m, g in zip(xs, ms, gs))
    torch.testing.assert_close(sums, want_sums, rtol=1e-5,
                               atol=1e-5 * float(want_sums.abs().max()))
    count = shape[2] * shape[3]
    for s, m, g in zip(xs, ms, gs):
        gx, gmod = mn.modnorm_instance_backward_apply(s, m, g, mean, rstd, sums, count,
                                                      lrelu=True)
        torch.cuda.synchronize()
        wgx, wgmod = mn.modnorm_instance_backward_apply_plain(s, m, g, mean, rstd, sums, count,
                                                              lrelu=True)
        assert _train_within(gx, wgx, dtype)
        assert (gmod is None) == (not with_mod)
        if with_mod:
            assert _train_within(gmod, wgmod, dtype)
    launched = {k: mn.launches[k] - before[k] for k in mn.launches}
    assert launched == dict.fromkeys(mn.launches, 0) | {
        "instance_partials": 2, "instance_apply": 3, "instance_backward_sums": 2,
        "instance_backward_apply": 2, "instance_train": 1}
    torch.cuda.empty_cache()


# the instance split at rank 0's stripes of the 32x 512^2 spatial step at two
# ranks (bf16 in the step; the lrelu flag as the step's call), each x one
# stripe: the partials and the backward sums launches
SPLIT_STEP_SHAPES = {"E 2x32x256x512": ((2, 32, 256, 512), True),
                     "E 2x64x128x256": ((2, 64, 128, 256), True),
                     "E 2x128x64x128": ((2, 128, 64, 128), True),
                     "E 2x256x128x256": ((2, 256, 128, 256), True),
                     "E 2x128x128x256": ((2, 128, 128, 256), False),
                     "D 4x64x64x129": ((4, 64, 64, 129), True),
                     "D 4x128x32x65": ((4, 128, 32, 65), True),
                     "D 4x256x32x66": ((4, 256, 32, 66), True),
                     "D 4x64x32x65": ((4, 64, 32, 65), True),
                     "D 4x128x16x33": ((4, 128, 16, 33), True),
                     "D 4x256x16x34": ((4, 256, 16, 34), True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(SPLIT_STEP_SHAPES))
def test_instance_split_statistics_at_the_step_shapes(cuda_device, case, dtype):
    """The partials launch (row 1 of a world of 3: the other rows zeros, no
    memset) and the sums launch (with and without a modulation) against
    their plain versions at the card tests' tolerances, one launch each,
    and a repeat bit for bit."""
    shape, lrelu = SPLIT_STEP_SHAPES[case]
    x, mod, _, _ = _inputs(cuda_device, dtype, shape=shape)
    gout = _inputs(cuda_device, dtype, shape=shape, with_mod=False, seed=1)[0]
    before = dict(mn.launches)
    part = mn.modnorm_instance_partials(x, 1, 3)
    again = mn.modnorm_instance_partials(x, 1, 3)
    torch.cuda.synchronize()
    assert not part[0].any() and not part[2].any()
    want = mn.modnorm_instance_partials_plain(x)
    assert torch.equal(part[1, 0], want[0])
    torch.testing.assert_close(part[1, 1:], want[1:], rtol=1e-5, atol=1e-5)
    assert torch.equal(part, again)
    _, mean, rstd = mn.modnorm_instance_apply(x, mod, part, lrelu=lrelu)
    for m in (None, mod):
        sums = mn.modnorm_instance_backward_sums(x, m, gout, mean, rstd, lrelu=lrelu)
        second = mn.modnorm_instance_backward_sums(x, m, gout, mean, rstd, lrelu=lrelu)
        torch.cuda.synchronize()
        want_sums = mn.modnorm_instance_backward_sums_plain(x, m, gout, mean, rstd, lrelu=lrelu)
        torch.testing.assert_close(sums, want_sums, rtol=1e-5,
                                   atol=1e-5 * float(want_sums.abs().max()))
        assert torch.equal(sums, second)
    launched = {k: mn.launches[k] - before[k] for k in mn.launches}
    assert launched["instance_partials"] == 2 and launched["instance_backward_sums"] == 4
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_instance_split_kernels_are_deterministic_on_card(cuda_device):
    """The partials and sums launches merge their blocks' partials in rank
    order: the same inputs give the same results, bit for bit."""
    x, mod, _, _ = _inputs(cuda_device, torch.bfloat16, shape=(2, 64, 129, 257))
    gout = _inputs(cuda_device, torch.bfloat16, shape=(2, 64, 129, 257), with_mod=False,
                   seed=1)[0]
    part = mn.modnorm_instance_partials(x)
    _, mean, rstd = mn.modnorm_instance_apply(x, mod, part, lrelu=True)
    first = mn.modnorm_instance_backward_sums(x, mod, gout, mean, rstd, lrelu=True)
    for _ in range(5):
        assert torch.equal(mn.modnorm_instance_backward_sums(x, mod, gout, mean, rstd,
                                                             lrelu=True), first)
        assert torch.equal(mn.modnorm_instance_partials(x), part)


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
    assert {k: ic.launches[k] - before[k] for k in before} == dict.fromkeys(before, 0) | \
        dict.fromkeys(("absmax", "quantize_weight", "quantize_activation", "igemm"), 1)
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
@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("case", ["conv 512 64^2", "down1 stride 2", "1x1"])
def test_int8_conv_striped_on_one_stripe_is_the_op(cuda_device, case, smooth):
    """`int8_conv_striped` on a map of one stripe (the MAX all-reduce the
    identity; the halo the padding's zero rows, as int8): one launch of
    each of (a)-(d), (d) at pad_h 0, the output bit for bit the op's."""
    x, weight, bias, stride, pad = _int8_inputs(cuda_device, torch.bfloat16, case)

    def halo(x_q):
        rows = x_q.new_zeros(x_q.shape[:2] + (pad,) + x_q.shape[3:])
        return torch.cat([rows, x_q, rows], 2).contiguous(memory_format=torch.channels_last)

    before = dict(ic.launches)
    y = ic.int8_conv_striped(x, weight, bias, stride, (0, pad), smooth, halo, lambda t: t)
    torch.cuda.synchronize()
    assert {k: ic.launches[k] - before[k] for k in before} == dict.fromkeys(before, 0) | \
        dict.fromkeys(("absmax", "quantize_weight", "quantize_activation", "igemm"), 1)
    assert torch.equal(y, ic.int8_conv(x, weight, bias, stride, pad, smooth))


# (b) alone: (Cout, Cin, kh, kw) of every quantized conv of the int8 main and
# 8x guided paths, chip_smoke.py's ragged weights, one whose threads take
# several units each, a 5x5 (taps at run time) and an odd Cin
INT8_WEIGHTS = {"512x512": (512, 512, 3, 3), "mod 256->1024": (1024, 256, 3, 3),
                "mod 128->1024": (1024, 128, 3, 3), "64->128": (128, 64, 3, 3),
                "128->256": (256, 128, 3, 3), "256->128": (128, 256, 3, 3),
                "cin 72": (40, 72, 3, 3), "cout 20": (20, 64, 3, 3), "1x1": (256, 512, 1, 1),
                "1024x1024": (1024, 1024, 3, 3), "5x5": (48, 40, 5, 5),
                "cin 31": (64, 31, 3, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("case", list(INT8_WEIGHTS))
def test_int8_quantize_weight_matches_plain_on_card(cuda_device, case, smooth):
    """(b) in one launch: s_c, s_k, s_x bit for bit and k_q equal to the plain
    version's, with an all-zero input channel of the weight (mk at the 1e-8
    floor) and of x; a second call gives the same bits."""
    cout, cin, kh, kw = INT8_WEIGHTS[case]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = (torch.randn((2, cin, 5, 6), generator=g, device=cuda_device)
         * torch.logspace(-2, 1, cin, device=cuda_device)[:, None, None])
    x[:, 0] = 0.0
    weight = torch.randn((cout, cin, kh, kw), generator=g, device=cuda_device) * 0.05
    weight[:, 1] = 0.0
    mx_raw, mx = ic.absmax_channels_plain(x)
    want_sc = ic.smooth_scales_plain(weight, mx, smooth)
    want_sk, want_kq = ic.quantize_weight_plain(weight, want_sc)
    want_sx, _ = ic.quantize_activation_plain(x, want_sc)
    before = ic.launches["quantize_weight"]
    first = ic.quantize_weight(weight, mx_raw, mx, smooth)
    second = ic.quantize_weight(weight, mx_raw, mx, smooth)
    torch.cuda.synchronize()
    assert ic.launches["quantize_weight"] == before + 2
    s_c, s_k, s_x, k_q = first
    for got, ref in ((s_c, want_sc), (s_k, want_sk), (s_x, want_sx)):
        assert torch.equal(got, ref)
    assert torch.equal(k_q[..., :cin].permute(0, 3, 1, 2), want_kq)
    assert not bool(k_q[..., cin:].any())
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (b) under a tensor-parallel shard: the column and row blocks of two model
# ranks of the main path's 512-wide trunk convs, of the mini encoder's
# conv2.1.0 and of a modulation conv, beside odd shapes (5x5 taps at run
# time; odd Cin blocks, Cin blocks that 16 does not divide, fewer output
# channels than SMs, one tap, Cin blocks of one channel)
INT8_SPLIT_WEIGHTS = {"512x512": (512, 512, 3, 3), "mod 256->1024": (1024, 256, 3, 3),
                      "encoder 256x128": (256, 128, 3, 3), "5x5": (48, 40, 5, 5),
                      "cin 62": (64, 62, 3, 3), "cin 34": (100, 34, 3, 3),
                      "1x1 cin 400": (40, 400, 1, 1), "cin 2": (64, 2, 3, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("shard", ["column", "row"])
@pytest.mark.parametrize("case", list(INT8_SPLIT_WEIGHTS))
def test_int8_split_quantize_weight_matches_plain_on_card(cuda_device, case, shard, smooth):
    """(b)'s two launches on each of two blocks, the MAX all-reduce as an
    elementwise maximum of the blocks' first launches: every launch's
    outputs bit for bit its plain version's, and the blocks' scales and k_q
    one process's for the whole weight; a repeat gives the same bits."""
    cout, cin, kh, kw = INT8_SPLIT_WEIGHTS[case]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = (torch.randn((2, cin, 5, 6), generator=g, device=cuda_device)
         * torch.logspace(-2, 1, cin, device=cuda_device)[:, None, None])
    x[:, 0] = 0.0
    weight = torch.randn((cout, cin, kh, kw), generator=g, device=cuda_device) * 0.05
    weight[:, 1] = 0.0
    want = ic.quantize_plain(x.contiguous(memory_format=torch.channels_last), weight, smooth)
    dim = 0 if shard == "column" else 1
    ws = [w.contiguous() for w in weight.chunk(2, dim)]
    xs = [x, x] if shard == "column" else [t.contiguous() for t in x.chunk(2, 1)]
    maxima = [ic.absmax_channels_plain(t) for t in xs]

    def run():
        before = dict(ic.launches)
        if shard == "column" and not smooth:
            return [ic.quantize_weight(w, *m, False) for w, m in zip(ws, maxima)], None
        if shard == "column":
            parts = [ic.weight_column_maxima(w) for w in ws]
            torch.cuda.synchronize()
            for w, part in zip(ws, parts):
                assert torch.equal(part, ic.weight_column_maxima_plain(w))
            top = torch.maximum(*parts)
            got = [ic.quantize_weight_columns(w, *m, top) for w, m in zip(ws, maxima)]
            torch.cuda.synchronize()
            for w, m, (s_c, s_k, s_x, k_q) in zip(ws, maxima, got):
                p_sc, p_sk, p_sx, p_kq = ic.quantize_weight_columns_plain(w, *m, top)
                assert torch.equal(s_c, p_sc) and torch.equal(s_k, p_sk)
                assert torch.equal(s_x, p_sx)
                assert torch.equal(k_q[..., :cin].permute(0, 3, 1, 2), p_kq)
        else:
            firsts = [ic.weight_row_maxima(w, *m, smooth) for w, m in zip(ws, maxima)]
            torch.cuda.synchronize()
            for w, m, (s_c, part) in zip(ws, maxima, firsts):
                p_sc, p_part = ic.weight_row_maxima_plain(w, *m, smooth)
                assert part.shape == (ic.row_maxima_plan(*w.shape[:2], kh * kw).parts,
                                      w.shape[0] + 1)
                assert torch.equal(s_c, p_sc) and torch.equal(part.amax(0), p_part)
            top = torch.maximum(firsts[0][1], firsts[1][1])
            rows = [ic.quantize_weight_rows(w, s_c, top) for w, (s_c, _) in zip(ws, firsts)]
            torch.cuda.synchronize()
            for w, (s_c, _), (s_k, s_x, k_q) in zip(ws, firsts, rows):
                p_sk, p_sx, p_kq = ic.quantize_weight_rows_plain(w, s_c, top)
                assert torch.equal(s_k, p_sk) and torch.equal(s_x, p_sx)
                c_blk = w.shape[1]
                assert torch.equal(k_q[..., :c_blk].permute(0, 3, 1, 2), p_kq)
            got = [(s_c, s_k, s_x, k_q) for (s_c, _), (s_k, s_x, k_q) in zip(firsts, rows)]
        launched = {k: ic.launches[k] - before[k] for k in ic.launches}
        return got, launched

    got, launched = run()
    if launched is not None:
        assert launched[f"weight_{shard}_maxima"] == 2 and launched["weight_scales"] == 2
        assert launched["quantize_weight"] == 0
    blocks = [ws[i].shape[1] for i in range(2)]
    k_q = [k[..., :(cin if shard == "column" else blocks[i])].permute(0, 3, 1, 2)
           for i, (_, _, _, k) in enumerate(got)]
    if shard == "column":
        for s_c, _, s_x, _ in got:
            assert torch.equal(s_c, want.s_c) and torch.equal(s_x, want.s_x)
        assert torch.equal(torch.cat([g_[1] for g_ in got]), want.s_k)
        assert torch.equal(torch.cat(k_q), want.k_q)
    else:
        assert torch.equal(torch.cat([g_[0] for g_ in got]), want.s_c)
        for _, s_k, s_x, _ in got:
            assert torch.equal(s_k, want.s_k) and torch.equal(s_x, want.s_x)
        assert torch.equal(torch.cat(k_q, 1), want.k_q)
    again, _ = run()
    for first, second in zip(got, again):
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_int8_split_quantize_weight_refuses_what_it_does_not_take(cuda_device):
    weight = torch.randn(64, 32, 3, 3, device=cuda_device)
    mx_raw, mx = ic.absmax_channels_plain(torch.randn(1, 32, 4, 4, device=cuda_device))
    s_c, maxima = ic.weight_row_maxima(weight, mx_raw, mx, True)
    for call in (lambda: ic.weight_column_maxima(weight.double()),
                 lambda: ic.quantize_weight_columns(weight, mx_raw, mx, mx[:16]),
                 lambda: ic.weight_row_maxima(weight.cpu(), mx_raw, mx, True),
                 lambda: ic.quantize_weight_rows(weight, s_c, maxima[..., :-1])):
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
def test_int8_quantize_weight_on_two_streams_at_once(cuda_device):
    """(b) with smoothing on two streams with no order between them, twenty
    launches each: every call's s_c, s_k, s_x and k_q equal the plain
    version's (each launch merges its column maxima in its own scratch, so
    overlapping launches do not mix them)."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    cases = []
    for cout, cin in ((512, 512), (1024, 256)):
        x = torch.randn((2, cin, 5, 6), generator=g, device=cuda_device)
        weight = torch.randn((cout, cin, 3, 3), generator=g, device=cuda_device) * 0.05
        mx_raw, mx = ic.absmax_channels_plain(x)
        s_c = ic.smooth_scales_plain(weight, mx, True)
        s_k, k_q = ic.quantize_weight_plain(weight, s_c)
        s_x, _ = ic.quantize_activation_plain(x, s_c)
        cases.append(((weight, mx_raw, mx), (s_c, s_k, s_x, k_q)))
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    results = [[] for _ in cases]
    torch.cuda.synchronize()
    for _ in range(20):
        for (args, _), stream, got in zip(cases, streams, results):
            with torch.cuda.stream(stream):
                got.append(ic.quantize_weight(*args, True))
    torch.cuda.synchronize()
    for (args, (want_sc, want_sk, want_sx, want_kq)), got in zip(cases, results):
        cin = args[0].shape[1]
        for s_c, s_k, s_x, k_q in got:
            assert torch.equal(s_c, want_sc) and torch.equal(s_k, want_sk)
            assert torch.equal(s_x, want_sx)
            assert torch.equal(k_q[..., :cin].permute(0, 3, 1, 2), want_kq)


@pytest.mark.cuda
def test_int8_row_maxima_on_two_streams_at_once(cuda_device):
    """(b)'s row-maxima launch on two streams with no order between them,
    twenty launches each, at the main path's two row-block shapes: every
    call's s_c and maxima (folded over the parts) equal the plain
    version's (no scratch, no memset: each launch's clusters merge in their
    own shared memory)."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    cases = []
    for cout, cin in ((512, 256), (256, 64)):
        x = torch.randn((2, cin, 5, 6), generator=g, device=cuda_device)
        weight = torch.randn((cout, cin, 3, 3), generator=g, device=cuda_device) * 0.05
        mx_raw, mx = ic.absmax_channels_plain(x)
        cases.append(((weight, mx_raw, mx), ic.weight_row_maxima_plain(weight, mx_raw, mx, True)))
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    results = [[] for _ in cases]
    torch.cuda.synchronize()
    for _ in range(20):
        for (args, _), stream, got in zip(cases, streams, results):
            with torch.cuda.stream(stream):
                got.append(ic.weight_row_maxima(*args, True))
    torch.cuda.synchronize()
    for (_, (want_sc, want_maxima)), got in zip(cases, results):
        for s_c, maxima in got:
            assert torch.equal(s_c, want_sc) and torch.equal(maxima.amax(0), want_maxima)


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
# stride, padding (one int or (pad_h, pad_w): a stripe's slab, whose halo
# rows hold H's padding, at pad_h 0); the tile's rectangle and N tile stick
# out of each
IGEMM_SHAPES = {
    "19x23 cin 72 (Cp 80) cout 40": ((3, 72, 19, 23), (40, 72, 3, 3), 1, 1),
    "7x5 Cp 64 cout 20": ((3, 64, 7, 5), (20, 64, 3, 3), 1, 1),
    "stride 2 19x23": ((2, 128, 19, 23), (256, 128, 3, 3), 2, 1),
    "stride 2 Cp 64 cout 40": ((2, 64, 33, 17), (40, 64, 3, 3), 2, 1),
    "1x1 cout 300": ((2, 512, 9, 13), (300, 512, 1, 1), 1, 0),
    "M not a multiple of 128, two N tiles": ((3, 256, 13, 11), (264, 256, 3, 3), 1, 1),
    "Cp 16 cout 36": ((2, 8, 21, 10), (36, 8, 3, 3), 1, 1),
    "a row wider than 128": ((1, 128, 4, 150), (128, 128, 3, 3), 1, 1),
    "slab pad_h 0": ((2, 512, 34, 64), (512, 512, 3, 3), 1, (0, 1)),
    "slab pad_h 0 Cp 144 cout 1024": ((2, 144, 18, 32), (1024, 144, 3, 3), 1, (0, 1)),
    "slab pad_h 0 stride 2": ((2, 64, 33, 64), (128, 64, 3, 3), 2, (0, 1)),
    "pad_h 2 pad_w 0": ((1, 64, 9, 40), (72, 64, 3, 3), 1, (2, 0)),
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
