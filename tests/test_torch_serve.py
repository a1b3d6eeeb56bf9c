"""The port's serving export (deepsee_torch/serve.py) against the JAX
package's serving functions, float32 on the CPU, tiny test configuration.

Both packages get the same weights (test_torch_layers.realistic_variables
of the JAX init, bridged to the port).  The port's two programs are
exported once per model family with torch.export, saved, loaded back and
held against `deepsee_tpu.serve.make_serving_fns` on the same inputs:
images 1e-4 absolute (float32 summation order through ~12 convs), the
style matrix 1e-6.  Against the live port system the loaded program is
exact: the same operations run in the same order.
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

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.serve import make_serving_fns as jax_serving_fns
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_tpu.system import SystemVariables
from deepsee_torch import serve
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.ops import modnorm as mn
from deepsee_torch.system import SRSystem
from test_torch_layers import realistic_variables
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
GUIDED = dict(net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.05)


def _exp(tiny, guided):
    exp = tiny().replace(is_train=False)
    return exp.replace(model=dataclasses.replace(exp.model, **(GUIDED if guided else {})))


def _family(guided: bool, out_dir: str):
    """JAX serving functions, the live port system and its saved artifact."""
    jsys = JaxSystem(_exp(jax_tiny, guided))
    variables = jsys.init(jax.random.PRNGKey(0))
    g, e = realistic_variables(variables.g, 1), realistic_variables(variables.e, 2)
    port = SRSystem(_exp(torch_tiny, guided), device="cpu")
    port.load_jax_variables(g, e)
    programs = serve.export_serving(port, batch_size=BATCH)
    serve.save_serving(out_dir, port.exp, programs, BATCH, port.device)
    jfns = jax_serving_fns(jsys, SystemVariables(g=g, e=e, d=None, vgg=None))
    return jfns, port, programs


@pytest.fixture(scope="module", params=[False, True], ids=["independent", "guided"])
def family(request, tmp_path_factory):
    guided = request.param
    out = str(tmp_path_factory.mktemp("guided" if guided else "independent"))
    jfns, port, programs = _family(guided, out)
    return guided, out, jfns, port, programs


def _inputs(cfg, guided, seed=0):
    rng = np.random.RandomState(seed)
    lr = np.tanh(rng.randn(BATCH, cfg.start_size, cfg.start_size, 3)).astype(np.float32)
    lab = rng.randint(0, cfg.label_nc, (BATCH, cfg.crop_size, cfg.crop_size)).astype(np.int32)
    hr = np.tanh(rng.randn(BATCH, cfg.crop_size, cfg.crop_size, 3)).astype(np.float32)
    glab = rng.randint(0, cfg.label_nc, (BATCH, cfg.crop_size, cfg.crop_size)).astype(np.int32)
    return (lr, lab, hr, glab) if guided else (lr, lab)


def _call(module, args):
    with torch.inference_mode():
        return module(*(torch.from_numpy(a) for a in args))


def test_round_trip_matches_jax(family):
    """export -> save -> load of both programs against the JAX serving
    functions on the same weights."""
    guided, out, (jax_e2e, jax_styled), port, _ = family
    args = _inputs(port.cfg, guided)
    want_fake, want_style = jax.jit(jax_e2e)(*map(jnp.asarray, args))
    fake, style = _call(serve.load_serving(out), args)
    assert fake.shape == (BATCH, 32, 32, 3) and style.shape == (BATCH, 19, 16)
    np.testing.assert_allclose(style.numpy(), np.asarray(want_style), rtol=0, atol=1e-6)
    np.testing.assert_allclose(fake.numpy(), np.asarray(want_fake), rtol=0, atol=1e-4)

    sty = np.asarray(want_style) + 0.1
    want = jax.jit(jax_styled)(jnp.asarray(args[0]), jnp.asarray(args[1]), jnp.asarray(sty))
    got = _call(serve.load_serving(out, "styled"), (args[0], args[1], sty))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_loaded_program_equals_live_system(family):
    guided, out, _, port, _ = family
    args = _inputs(port.cfg, guided, seed=1)
    fake, style = _call(serve.load_serving(out), args)
    keys = ("image_lr", "label", "guiding_image", "guiding_label")
    batch = port.preprocess(dict(zip(keys, args)))
    want_fake, want_style = port.generate(batch, use_full=guided)
    torch.testing.assert_close(fake, want_fake, rtol=0, atol=0)
    torch.testing.assert_close(style, want_style, rtol=0, atol=0)


def test_manifest(family):
    guided, out, _, port, _ = family
    manifest = json.loads(open(os.path.join(out, "manifest.json")).read())
    cfg = port.cfg
    assert manifest["device"] == "cpu" and "platforms" not in manifest
    assert manifest["batch_size"] == BATCH and manifest["quantize"] == ""
    assert manifest["guiding_style_image"] == guided
    assert (manifest["start_size"], manifest["crop_size"], manifest["label_nc"],
            manifest["regional_style_size"]) == (cfg.start_size, cfg.crop_size,
                                                 cfg.label_nc, cfg.regional_style_size)
    assert ("guiding_image" in manifest["programs"]["end_to_end"]) == guided
    assert manifest["programs"]["styled"] == "(image_lr, label, style) -> fake"
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt2")) == [
        "end_to_end.pt2", "styled.pt2"]


def test_programs_keep_the_kernel_op(family):
    """Every norm of the path is one deepsee::modnorm node: affine per
    generator norm, instance per encoder layer (none in `styled`)."""
    guided, _, _, port, programs = family
    cfg = port.cfg
    affine = 2 * (2 + cfg.n_blocks)  # head, two middle blocks, n_blocks - 1 ups
    for name, want in (("end_to_end", affine + 5), ("styled", affine)):
        targets = [str(n.target) for n in programs[name].graph.nodes
                   if n.op == "call_function"]
        assert targets.count("deepsee.modnorm.default") == want, name


def test_program_hands_modnorm_channels_last(family, monkeypatch):
    """The loaded program gives the op channels_last tensors, which the
    CUDA kernel requires (it raises on anything else)."""
    guided, out, _, port, _ = family
    seen = []
    plain = mn.modnorm_plain

    def checked(x, mod=None, **kw):
        assert x.is_contiguous(memory_format=torch.channels_last)
        assert mod is None or mod.is_contiguous(memory_format=torch.channels_last)
        seen.append(tuple(x.shape))
        return plain(x, mod, **kw)

    monkeypatch.setattr(mn, "modnorm_plain", checked)
    module = serve.load_serving(out)
    _call(module, _inputs(port.cfg, guided))
    assert len(seen) == 2 * (2 + port.cfg.n_blocks) + 5


def test_quantize_int8_raises(family):
    """The quantize modes are "", "int8" and "int8_nosmooth" (the int8 export
    is held in test_torch_int8.py); any other raises before tracing."""
    _, _, _, port, _ = family
    for mode in ("fp4", "int4", "INT8"):
        with pytest.raises(ValueError, match="quantize mode"):
            serve.export_serving(port, batch_size=1, quantize=mode)


def test_load_serving_in_a_fresh_process(family):
    """A serving process that imports only deepsee_torch.serve loads and
    runs the artifact (the op is registered on load)."""
    guided, out, _, port, _ = family
    args = _inputs(port.cfg, guided, seed=2)
    np.savez(os.path.join(out, "args.npz"), *args)
    code = ("import sys, numpy as np, torch\n"
            "from deepsee_torch.serve import load_serving\n"
            "d = sys.argv[1]\n"
            "a = np.load(d + '/args.npz')\n"
            "args = [torch.from_numpy(a[f'arr_{i}']) for i in range(len(a.files))]\n"
            "with torch.inference_mode():\n"
            "    fake, style = load_serving(d)(*args)\n"
            "np.save(d + '/fake.npy', fake.numpy())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code, out], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    fake, _ = _call(serve.load_serving(out), args)
    np.testing.assert_array_equal(np.load(os.path.join(out, "fake.npy")), fake.numpy())


def test_export_cli_writes_an_artifact(tmp_path, monkeypatch):
    """`python -m deepsee_torch.serve` with a preset (the tiny one here),
    on the CPU."""
    import deepsee_torch.config as tconfig

    monkeypatch.setattr(tconfig, "get_preset", lambda name: torch_tiny())
    serve.main(["--name", "tiny", "--batch_size", "2", "--out", str(tmp_path),
                "--device", "cpu"])
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["batch_size"] == 2 and manifest["device"] == "cpu"
    args = _inputs(torch_tiny().model, False)
    fake, style = _call(serve.load_serving(str(tmp_path)), args)
    assert fake.shape == (2, 32, 32, 3) and bool(torch.isfinite(fake).all())
