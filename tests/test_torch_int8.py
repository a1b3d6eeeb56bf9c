"""The port's W8A8 int8 inference path (deepsee_torch/ops/int8conv.py, the
`int8_inference` switch of deepsee_torch/models/layers.py, the quantized
serving export and the evaluator under --int8) against the JAX package,
float32 on the CPU, tiny test configuration.

`int8_conv_plain` is held to the JAX `_int8_conv`, called eagerly on the
same numpy inputs: the int8 operands and their s32 products equal, the
outputs within one ulp of their type.

The tiny systems under `int8_inference(min_ch=8)` are held to the JAX
systems under the same context with the same weights (the bridge,
`SRSystem.load_jax_variables`).  Two int8 runs whose float32 activations
differ by roundoff cannot be held to each other tightly: a one-ulp
difference in an activation's channel maximum moves s_c, and a weight or
activation that sat on a rounding edge then lands one level away; every
later layer's inputs then differ by about a quantization step, so the two
outputs drift apart by a share of the int8 error itself.  So the port runs
teacher-forced: every quantized conv of the port gets the JAX package's
int8 result for the same call (the JAX run is jitted; its per-call inputs,
weights and outputs come back through `jax.debug.callback`), after its own
call was checked to be the same call (shape, weight, stride, padding, mode)
on inputs within FORCED_INPUT_REL of JAX's.  Its output must then be
within FORCED_TOL of the JAX int8 output, and FORCED_TOL must be at most a
tenth of the int8-vs-float32 gap on the same inputs (against the port's
float32 output, which is JAX's within 1e-4).  The op's own arithmetic is
held by the eager comparison above.

Weights: `realistic_variables` (test_torch_layers) of a zero tree of the
JAX init's shapes (`jax.eval_shape`), so no JAX init runs here.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.models import layers as jl
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_torch import evaluate as eval_cli
from deepsee_torch import serve
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.models import layers as tl
from deepsee_torch.ops import int8conv as q
from deepsee_torch.server import ServingServer, decode_image_b64
from deepsee_torch.system import SRSystem
from deepsee_torch.utils.images import tensor2im
from test_torch_layers import realistic_variables
from test_torch_server import _expected_end_to_end, _post, _request_payload
from torch_data_corpus import one_torch_thread  # noqa: F401  (module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUIDED = dict(net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.05)
MIN_CH = 8                  # the tiny model's convs are 8-144 channels wide
NHIDDEN = 128               # the SPADE/SEAN embedding width
FORCED_INPUT_REL = 1e-5     # a forced call's input against JAX's, of max|x| (float32 roundoff)
FORCED_TOL = 1e-5           # the forced output against JAX's int8 output
# a response against its program called directly on the same batch, uint8
# levels: the daemon's thread runs torch with the default intra-op thread
# count and this module with one, and the tiny realistic-weight model turns
# that float32 summation-order difference into an occasional level step
MAX_SERVED_U8_DIFF = 1


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(k)).permute(3, 2, 0, 1).contiguous()


def within_one_ulp(got: np.ndarray, want: np.ndarray, dtype: torch.dtype) -> bool:
    """|got - want| <= one ulp of want's magnitude in `dtype`."""
    want = want.astype(np.float32)
    if dtype == torch.float32:
        ulp = np.spacing(np.abs(want))
    else:
        mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return bool((np.abs(got.astype(np.float32) - want) <= ulp).all())


def reckoned_int8_convs(cfg, min_ch: int, encoder: bool = True) -> int:
    """The convs of one encode + generate with cin and cout >= min_ch:
    per generator block two norms (each its mlp_shared and modulation conv)
    and conv_0 / conv_1; the encoder trunk (mini and full have the same
    widths) and its head."""
    def quantized(cin, cout):
        return int(cin >= min_ch and cout >= min_ch)

    spec, nf16 = cfg.norm_g_spec, 16 * cfg.ngf
    count = 0
    for i in range(2 + cfg.n_blocks):          # head_0, G_middle_0/1, the up blocks
        styled = spec.sean and (i > 0 or not spec.late)
        mod_in = NHIDDEN + (cfg.regional_style_size if styled else 0)
        count += 2 * (quantized(cfg.semantic_nc, NHIDDEN) + quantized(mod_in, 2 * nf16)
                      + quantized(nf16, nf16))
    if encoder:
        nef = cfg.nef
        widths = [(3, nef), (nef, 2 * nef), (2 * nef, 4 * nef), (4 * nef, 8 * nef),
                  (8 * nef, cfg.regional_style_size)]
        count += sum(quantized(a, b) for a, b in widths)
    return count


# -- the op against _int8_conv ---------------------------------------------------

def _jax_int8_conv(x, k, stride, pad, smooth, monkeypatch):
    """JAX `_int8_conv` called eagerly, with its s8 operands and s32 product."""
    seen = {}
    real = jax.lax.conv_general_dilated

    class Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        def conv_general_dilated(self, lhs, rhs, *args, **kw):
            y = real(lhs, rhs, *args, **kw)
            seen.update(x_q=np.asarray(lhs), k_q=np.asarray(rhs), acc=np.asarray(y))
            return y

    with monkeypatch.context() as m:
        m.setattr(jl, "lax", Lax())
        y = jl._int8_conv(x, jnp.asarray(k), (stride, stride), ((pad, pad), (pad, pad)),
                          smooth=smooth)
    return np.asarray(y), seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 1)], ids=["3x3", "3x3s2", "1x1"])
@pytest.mark.parametrize("smooth", [True, False], ids=["smooth", "nosmooth"])
def test_int8_conv_plain_matches_jax(smooth, kernel, stride, dtype, monkeypatch):
    """Cin 72 (32 does not divide it), channel ranges over three decades,
    a bias: s8 operands and s32 products equal, the outputs within one ulp
    of their type (the bias added after the cast, in that type)."""
    rng = np.random.RandomState(kernel * 10 + stride)
    pad = kernel // 2
    x = (rng.randn(2, 9, 11, 72) * 10 ** np.linspace(-2, 1, 72)).astype(np.float32)
    k = (rng.randn(kernel, kernel, 72, 40) * 0.05).astype(np.float32)
    bias = (rng.randn(40) * 0.1).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    y, seen = _jax_int8_conv(xj, k, stride, pad, smooth, monkeypatch)
    want = (jnp.asarray(y).astype(jdt) + jnp.asarray(bias).astype(jdt)).astype(jnp.float32)

    xt = nchw(np.asarray(xj.astype(jnp.float32))).to(dtype)
    quant = q.quantize_plain(xt, oihw(k), smooth)
    np.testing.assert_array_equal(quant.x_q.permute(0, 2, 3, 1).numpy(), seen["x_q"])
    np.testing.assert_array_equal(quant.k_q.permute(2, 3, 1, 0).numpy(), seen["k_q"])
    acc = F.conv2d(quant.x_q.double(), quant.k_q.double(), stride=stride, padding=pad)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), seen["acc"])

    got = q.int8_conv(xt, oihw(k), torch.from_numpy(bias), stride, pad, smooth)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert within_one_ulp(got.float().permute(0, 2, 3, 1).numpy(), np.asarray(want), dtype)


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def test_int8_conv_close_to_the_float_conv():
    """The quantization error of one conv stays under 2 % (as
    tests/test_int8_inference.py holds the JAX package's)."""
    rng = np.random.RandomState(0)
    x = nchw(rng.randn(2, 16, 16, 64).astype(np.float32))
    w = oihw((rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32))
    ref = F.conv2d(x, w, padding=1)
    assert _rel(q.int8_conv_plain(x, w, None), ref) < 0.02


def test_smoothquant_helps_on_disparate_channel_ranges():
    """Three decades of channel spread: SmoothQuant's error under 0.7x the
    per-tensor quantization's; on uniform ranges not above 1.2x."""
    rng = np.random.RandomState(0)
    w = oihw((rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32))
    spread = nchw((rng.randn(2, 16, 16, 64) * 10 ** np.linspace(-2, 1, 64)).astype(np.float32))
    uniform = nchw(rng.randn(2, 16, 16, 64).astype(np.float32))
    for x, bound in ((spread, 0.7), (uniform, 1.2)):
        ref = F.conv2d(x, w, padding=1)
        smoothed = _rel(q.int8_conv_plain(x, w, None, smooth=True), ref)
        plain = _rel(q.int8_conv_plain(x, w, None, smooth=False), ref)
        assert smoothed < bound * plain, (smoothed, plain)


# -- the tiny systems -------------------------------------------------------------

def _exp(tiny, guided):
    exp = tiny().replace(is_train=False)
    return exp.replace(model=dataclasses.replace(exp.model, **(GUIDED if guided else {})))


def _batch(cfg, guided, seed=0):
    rng = np.random.RandomState(seed)
    size = (2, cfg.crop_size, cfg.crop_size)
    batch = {"image_hr": np.tanh(1.5 * rng.randn(*size, 3)).astype(np.float32),
             "label": rng.randint(0, cfg.label_nc, size).astype(np.int32)}
    if guided:
        batch["guiding_image"] = np.tanh(rng.randn(*size, 3)).astype(np.float32)
        batch["guiding_label"] = rng.randint(0, cfg.label_nc, size).astype(np.int32)
    return batch


@pytest.fixture(scope="module", params=[False, True], ids=["independent", "guided"])
def family(request):
    """The JAX system, its weights (realistic values in the init's shapes)
    and the port system holding the same weights."""
    guided = request.param
    jsys = JaxSystem(_exp(jax_tiny, guided))
    shapes = jax.eval_shape(jsys.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    g, e = realistic_variables(zeros.g, 1), realistic_variables(zeros.e, 2)
    port = SRSystem(_exp(torch_tiny, guided), device="cpu")
    port.load_jax_variables(g, e)
    return guided, jsys, g, e, port


def _jax_fake(jsys, g, e, batch, guided):
    """The JAX system's fake, jitted (traced anew on every call)."""
    def fwd(gv, ev, b):
        pre = jsys.preprocess(b)
        return jsys.generate(gv, ev, pre, use_full=guided, no_noise=True, train=False)[0]

    fake = jax.jit(fwd)(g, e, {k: jnp.asarray(v) for k, v in batch.items()})
    fake = np.asarray(fake)
    jax.effects_barrier()
    return fake


def _capturing(calls):
    """A stand-in for `_int8_conv` that appends each call's (strides, padding,
    smooth) and, at run time, its (x, kernel, y) to `calls`, in order."""
    real = jl._int8_conv

    def capture(x, kernel, strides, padding, smooth=True):
        y = real(x, kernel, strides, padding, smooth=smooth)
        meta = (tuple(strides), tuple(map(tuple, padding)), smooth)
        jax.debug.callback(lambda *a: calls.append((meta,) + tuple(np.asarray(t) for t in a)),
                           x, kernel, y, ordered=True)
        return y

    return capture


def _forcing(calls, report):
    """A stand-in for `int8_conv_plain` that checks the port's call against
    the JAX call of the same index and returns the JAX result + bias."""
    def forced(x, weight, bias, stride, padding, smooth, out_dtype=None):
        i = len(report)
        (strides, pads, jsmooth), xj, kj, yj = calls[i]
        assert tuple(x.shape) == tuple(nchw(xj).shape), i
        assert tuple(weight.shape) == tuple(oihw(kj).shape), i
        assert (stride, stride) == strides and ((padding, padding),) * 2 == pads, i
        assert smooth == jsmooth, i
        scale = max(1.0, float(np.abs(xj).max()))
        report.append((float((x - nchw(xj)).abs().max()) / scale,
                       float((weight - oihw(kj)).abs().max())))
        dtype = out_dtype or x.dtype
        y = nchw(yj).to(dtype)
        if bias is not None:
            y = y + bias.to(dtype)[:, None, None]
        return y.contiguous(memory_format=torch.channels_last)

    return forced


def test_tiny_int8_system_matches_jax(family, monkeypatch):
    """Teacher-forced (module docstring): the port makes the JAX package's
    int8 calls in its order, on inputs within FORCED_INPUT_REL, and its
    output is within FORCED_TOL <= gap / 10 of the JAX int8 output."""
    guided, jsys, g, e, port = family
    batch = _batch(port.cfg, guided)
    # the float32 output of the same weights (the port's: JAX's within 1e-4)
    float_fake = port.generate(port.preprocess(batch), use_full=guided)[0].numpy()
    calls = []
    monkeypatch.setattr(jl, "_int8_conv", _capturing(calls))
    with jl.int8_inference(min_ch=MIN_CH):
        int8_fake = _jax_fake(jsys, g, e, batch, guided)
    gap = float(np.abs(int8_fake - float_fake).max())
    assert len(calls) == reckoned_int8_convs(port.cfg, MIN_CH)
    assert FORCED_TOL <= gap / 10, gap
    if guided:  # the full trunk's stride-2 down1 is quantized
        assert any(meta[0] == (2, 2) for meta, *_ in calls)

    report = []
    monkeypatch.setattr(q, "int8_conv_plain", _forcing(calls, report))
    with tl.int8_inference(min_ch=MIN_CH):
        fake, _ = port.generate(port.preprocess(batch), use_full=guided)
    assert len(report) == len(calls)
    assert max(r[0] for r in report) <= FORCED_INPUT_REL, report
    assert max(r[1] for r in report) <= 1e-6, report  # the float32 weights (W / sigma)
    np.testing.assert_allclose(fake.numpy(), int8_fake, rtol=0, atol=FORCED_TOL)


def test_int8_count_and_the_switch(family):
    """Inside the context the port quantizes the convs reckoned from the
    config, and its output stays near the float one (mean |d| < 0.05, as
    the JAX package's test); outside, the output is the unquantized one bit
    for bit."""
    guided, _, _, _, port = family
    pre = port.preprocess(_batch(port.cfg, guided, seed=1))
    before, _ = port.generate(pre, use_full=guided)
    q.reset_launches()
    assert not tl.int8_mode_active()
    with tl.int8_inference(min_ch=MIN_CH):
        assert tl.int8_mode_active()
        int8, _ = port.generate(pre, use_full=guided)
    assert not tl.int8_mode_active()
    assert q.plain_calls["int8_conv"] == reckoned_int8_convs(port.cfg, MIN_CH)
    after, _ = port.generate(pre, use_full=guided)
    assert q.plain_calls["int8_conv"] == reckoned_int8_convs(port.cfg, MIN_CH)
    torch.testing.assert_close(after, before, rtol=0, atol=0)
    assert 0 < float((int8 - before).abs().mean()) < 0.05
    assert sum(q.launches.values()) == 0  # no kernel on the CPU


def test_training_forward_never_quantizes(family):
    """A train-mode encode + generate inside the context makes no int8 call
    (the JAX gates are `not train`)."""
    guided, _, g, e, _ = family
    port = SRSystem(_exp(torch_tiny, guided), device="cpu")
    port.load_jax_variables(g, e)
    port.generator.train()
    port.encoder.train()
    batch = port.train_preprocess(_batch(port.cfg, guided))
    q.reset_launches()
    with torch.no_grad(), tl.int8_inference(min_ch=MIN_CH):
        fake = port.train_generate(batch, use_full=guided, no_noise=False,
                                   generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(fake).all())
    assert q.plain_calls["int8_conv"] == 0


# -- serving --------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    guided = False
    jsys = JaxSystem(_exp(jax_tiny, guided))
    shapes = jax.eval_shape(jsys.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = SRSystem(_exp(torch_tiny, guided), device="cpu")
    port.load_jax_variables(realistic_variables(zeros.g, 1), realistic_variables(zeros.e, 2))
    out = str(tmp_path_factory.mktemp("int8_artifact"))
    programs = serve.export_serving(port, batch_size=2, quantize="int8")
    serve.save_serving(out, port.exp, programs, 2, port.device, quantize="int8")
    return port, programs, out


def test_quantized_export_keeps_the_int8_op(exported):
    """Each quantized conv is one deepsee::int8_conv node (the default
    min_ch 64: the generator's), smoothing on; the manifest says int8."""
    port, programs, out = exported
    want = {"end_to_end": reckoned_int8_convs(port.cfg, 64),
            "styled": reckoned_int8_convs(port.cfg, 64, encoder=False)}
    for name, program in programs.items():
        nodes = [n for n in program.graph.nodes
                 if n.op == "call_function" and str(n.target) == "deepsee.int8_conv.default"]
        assert len(nodes) == want[name] > 0, name
        assert all(n.args[-1] is True for n in nodes)
    manifest = json.loads(open(os.path.join(out, "manifest.json")).read())
    assert manifest["quantize"] == "int8"
    with pytest.raises(ValueError, match="quantize"):
        serve.export_serving(port, batch_size=2, quantize="fp4")


def test_quantized_program_loads_in_a_fresh_process(exported, tmp_path):
    """A process that imports only deepsee_torch.serve loads the int8
    artifact and gives the live int8 system's output bit for bit."""
    port, _, out = exported
    cfg = port.cfg
    rng = np.random.RandomState(4)
    lr = np.tanh(rng.randn(2, cfg.start_size, cfg.start_size, 3)).astype(np.float32)
    lab = rng.randint(0, cfg.label_nc, (2, cfg.crop_size, cfg.crop_size)).astype(np.int32)
    np.savez(os.path.join(str(tmp_path), "args.npz"), lr, lab)
    code = ("import sys, numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from deepsee_torch.serve import load_serving\n"
            "a = np.load(sys.argv[2] + '/args.npz')\n"
            "with torch.inference_mode():\n"
            "    fake, style = load_serving(sys.argv[1])(*(torch.from_numpy(a[k]) for k in "
            "('arr_0', 'arr_1')))\n"
            "np.save(sys.argv[2] + '/fake.npy', fake.numpy())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code, out, str(tmp_path)], check=True, env=env,
                   cwd=REPO, timeout=120)
    with tl.int8_inference():
        want, _ = port.generate(port.preprocess({"image_lr": lr, "label": lab}),
                                use_full=False)
    np.testing.assert_array_equal(np.load(os.path.join(str(tmp_path), "fake.npy")),
                                  want.numpy())


def test_daemon_serves_int8_beside_float(exported, tmp_path):
    """One daemon serves the int8 artifact and a float one of the same
    weights under two aliases: each response is its own program's output on
    the batch the daemon formed (the request padded by repetition), within
    MAX_SERVED_U8_DIFF, and the two differ."""
    port, _, int8_dir = exported
    float_dir = str(tmp_path / "float")
    serve.save_serving(float_dir, port.exp, serve.export_serving(port, batch_size=2), 2,
                       port.device)
    srv = ServingServer([f"f32={float_dir}", f"int8={int8_dir}"], port=0,
                        batch_window_ms=5.0, device="cpu")
    srv.start()
    try:
        body = _request_payload(port.cfg, seed=5)
        responses = {}
        for alias, directory in (("f32", float_dir), ("int8", int8_dir)):
            status, responses[alias] = _post(srv.port, "/v1/super_resolve",
                                             dict(body, model=alias))
            assert status == 200, responses[alias]
            want, _ = _expected_end_to_end(directory, port.exp, body)
            got = decode_image_b64(responses[alias]["image"], port.cfg.crop_size)[0]
            diff = np.abs(tensor2im(got).astype(int) - tensor2im(want).astype(int))
            assert diff.max() <= MAX_SERVED_U8_DIFF, (alias, diff.max())
        assert responses["f32"]["image"] != responses["int8"]["image"]
    finally:
        srv.stop()


# -- evaluation -----------------------------------------------------------------

def test_evaluation_under_int8_is_finite(monkeypatch, capsys):
    """`python -m deepsee_torch.evaluate --int8`: the generator's convs run
    quantized (16 per batch of 2 at min_ch 64), the metrics are finite."""
    monkeypatch.setattr(eval_cli, "get_preset",
                        lambda name: torch_tiny().replace(name=name))
    q.reset_launches()
    result = eval_cli.main(["--name", "tiny_test", "--synthetic", "--device", "cpu",
                            "--num_samples", "4", "--batch_size", "2", "--no_checkpoint",
                            "--no_fid", "--no_lpips", "--int8"])
    capsys.readouterr()
    assert q.plain_calls["int8_conv"] == 2 * reckoned_int8_convs(torch_tiny().model, 64)
    assert not tl.int8_mode_active()
    for key in ("psnr/mean", "ssim/mean", "rmse/mean"):
        assert np.isfinite(result[key]), key
