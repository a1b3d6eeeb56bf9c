"""The port's demo (deepsee_torch/demo.py) against the repository's JAX
demo (demo.py's `Demo.run`), and the reference-checkpoint loader
(deepsee_torch/weights.py::load_reference_checkpoint), float32 on the CPU,
tiny test configuration.

Both demos get the same weights and the same PNG files.  The written PNG
may differ by one uint8 level (tensor2im truncates the float image, and
the two packages' float32 outputs differ by up to 1e-4); the written style
CSV by 1e-4 (float32, printed with numpy's default 18 digits).  The
reference-checkpoint files are written by the JAX package's
export_reference_checkpoint; the port loads them strictly and gives the
JAX output within 1e-4.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_tpu.system import SystemVariables
from deepsee_tpu.utils.torch_import import export_reference_checkpoint
from deepsee_torch import demo as tdemo
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.system import SRSystem
from deepsee_torch.weights import load_reference_checkpoint, reference_state_dict
from test_torch_layers import realistic_variables
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

GUIDED = dict(net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.05)


def _exp(tiny, guided=False):
    exp = tiny().replace(is_train=False)
    return exp.replace(model=dataclasses.replace(exp.model, **(GUIDED if guided else {})))


@functools.cache
def _variables(guided=False):
    variables = JaxSystem(_exp(jax_tiny, guided)).init(jax.random.PRNGKey(0))
    return SystemVariables(g=realistic_variables(variables.g, 1),
                           e=realistic_variables(variables.e, 2), d=None, vgg=None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo_inputs")
    cfg = jax_tiny().model
    rng = np.random.RandomState(0)
    paths = {"lr": str(d / "lr.png"), "sem": str(d / "sem.png"), "hr": str(d / "hr.png"),
             "hr2": str(d / "hr2.png")}
    Image.fromarray(rng.randint(0, 255, (cfg.start_size, cfg.start_size, 3),
                                dtype=np.uint8)).save(paths["lr"])
    Image.fromarray(rng.randint(0, cfg.label_nc, (cfg.crop_size, cfg.crop_size),
                                dtype=np.uint8)).save(paths["sem"])
    for key in ("hr", "hr2"):
        Image.fromarray(rng.randint(0, 255, (cfg.crop_size, cfg.crop_size, 3),
                                    dtype=np.uint8)).save(paths[key])
    return paths


@functools.cache
def _demos():
    from demo import Demo as JaxDemo

    variables = _variables()
    jax_demo = JaxDemo(_exp(jax_tiny), variables=variables)
    port_demo = tdemo.Demo(_exp(torch_tiny), device="cpu")
    port_demo.system.load_jax_variables(variables.g, variables.e)
    return jax_demo, port_demo


def _runs(kind, files, out_dir, csv_path=None):
    kw = {}
    if kind == "csv":
        kw["path_encoded_style"] = csv_path
    elif kind == "hr":
        kw["inputs_hr"] = [
            {"path_image_hr": files["hr"], "path_semantics": files["sem"], "regions": "all"},
            {"path_image_hr": files["hr2"], "path_semantics": files["sem"],
             "regions": [4, 11, 12]}]
    jax_demo, port_demo = _demos()
    want = jax_demo.run(files["lr"], files["sem"], out_dir=os.path.join(out_dir, "jax"), **kw)
    got = port_demo.run(files["lr"], files["sem"], out_dir=os.path.join(out_dir, "port"), **kw)
    return want, got


def _check_written(want, got):
    png_w = np.asarray(Image.open(want["save_path"])).astype(int)
    png_g = np.asarray(Image.open(got["save_path"])).astype(int)
    assert png_g.shape == png_w.shape and np.abs(png_g - png_w).max() <= 1
    csv_w = np.loadtxt(want["save_path"][:-4] + ".csv", delimiter=",")
    csv_g = np.loadtxt(got["save_path"][:-4] + ".csv", delimiter=",")
    np.testing.assert_allclose(csv_g, csv_w, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["fake_image"].numpy(), np.asarray(want["fake_image"]),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["lr", "csv", "hr"])
def test_demo_matches_jax(kind, files, tmp_path):
    """Style from the LR input, from a saved CSV (the LR run's), and from
    HR images with a region splice."""
    csv_path = None
    if kind == "csv":
        first, _ = _runs("lr", files, str(tmp_path / "first"))
        csv_path = first["save_path"][:-4] + ".csv"
    want, got = _runs(kind, files, str(tmp_path), csv_path)
    _check_written(want, got)
    assert os.path.basename(got["save_path"]) == "demo_lr.png"


def test_hr_splice_takes_the_listed_rows(files):
    _, port_demo = _demos()
    cfg = port_demo.exp.model
    loaded = [{"image_hr": port_demo.load_image(files[k], cfg.crop_size),
               "label": port_demo.load_label(files["sem"]), "regions": r}
              for k, r in (("hr", "all"), ("hr2", [4, 11]))]
    spliced = port_demo.compute_style_from_hr(loaded)
    base = port_demo.compute_style_from_hr(loaded[:1])
    other = port_demo.compute_style_from_hr([dict(loaded[1], regions="all")])
    for r in range(cfg.label_nc):
        want = other if r in (4, 11) else base
        torch.testing.assert_close(spliced[:, r], want[:, r], rtol=0, atol=0)


def test_lr_style_needs_the_independent_model(files):
    demo = tdemo.Demo(_exp(torch_tiny, guided=True), device="cpu")
    with pytest.raises(ValueError, match="independent"):
        demo.run(files["lr"], files["sem"], out_dir="unused")


@functools.cache
def _reference_dir(guided, root):
    d = os.path.join(root, "guided" if guided else "independent")
    written = export_reference_checkpoint(_variables(guided), d)
    assert sorted(written) == ["E", "SR"]
    return d


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("reference_ckpt"))


@pytest.mark.parametrize("guided", [False, True], ids=["independent", "guided"])
def test_reference_checkpoint_load_matches_jax(guided, ckpt_root):
    """The reference's {"model": sd} files with their dead keys
    (num_batches_tracked, style_conv, the per-trunk final heads) load
    strictly into the port, which then gives the JAX output."""
    d = _reference_dir(guided, ckpt_root)
    port = SRSystem(_exp(torch_tiny, guided), device="cpu")
    load_reference_checkpoint(port, d)
    jsys, variables = JaxSystem(_exp(jax_tiny, guided)), _variables(guided)
    rng = np.random.RandomState(3)
    cfg = port.cfg
    size = (2, cfg.crop_size, cfg.crop_size)
    batch = {"image_hr": np.tanh(rng.randn(*size, 3)).astype(np.float32),
             "label": rng.randint(0, cfg.label_nc, size).astype(np.int32)}
    if guided:
        batch["guiding_image"] = np.tanh(rng.randn(*size, 3)).astype(np.float32)
        batch["guiding_label"] = rng.randint(0, cfg.label_nc, size).astype(np.int32)
    jb = jsys.preprocess({k: jnp.asarray(v) for k, v in batch.items()})
    want_fake, want_style, _ = jsys.generate(variables.g, variables.e, jb, use_full=guided,
                                             no_noise=True, train=False)
    fake, style = port.generate(port.preprocess(batch), use_full=guided)
    np.testing.assert_allclose(style.numpy(), np.asarray(want_style), rtol=0, atol=1e-6)
    np.testing.assert_allclose(fake.numpy(), np.asarray(want_fake), rtol=0, atol=1e-4)


def test_reference_state_dict_drops_only_dead_keys(ckpt_root):
    d = _reference_dir(False, ckpt_root)
    raw = torch.load(os.path.join(d, "latest_net_E.pth"), weights_only=True)["model"]
    kept = reference_state_dict(os.path.join(d, "latest_net_E.pth"))
    dropped = sorted(set(raw) - set(kept))
    assert dropped and all(k.startswith(("encoder_full.final.", "encoder_mini.final."))
                           for k in dropped)
    raw_g = torch.load(os.path.join(d, "latest_net_SR.pth"), weights_only=True)["model"]
    dropped_g = set(raw_g) - set(reference_state_dict(os.path.join(d, "latest_net_SR.pth")))
    assert dropped_g and all(k.endswith(("num_batches_tracked", "style_conv.weight",
                                         "style_conv.bias")) for k in dropped_g)


def test_demo_cli_with_reference_checkpoint(files, ckpt_root, tmp_path, monkeypatch):
    """`python -m deepsee_torch.demo --torch_checkpoint ... --device cpu`
    writes what the JAX demo writes with the same weights."""
    import deepsee_torch.config as tconfig

    monkeypatch.setattr(tconfig, "get_preset", lambda name: torch_tiny())
    d = _reference_dir(False, ckpt_root)
    out = str(tmp_path / "cli")
    tdemo.main(["--name", "tiny", "--image_lr", files["lr"], "--semantics", files["sem"],
                "--hr_image", files["hr"], "--hr_image", f"{files['hr2']}:4,11,12",
                "--torch_checkpoint", d, "--device", "cpu", "--out", out])
    want, _ = _runs("hr", files, str(tmp_path / "direct"))
    got = {"save_path": os.path.join(out, "demo_lr.png")}
    png_w = np.asarray(Image.open(want["save_path"])).astype(int)
    png_g = np.asarray(Image.open(got["save_path"])).astype(int)
    assert np.abs(png_g - png_w).max() <= 1
    np.testing.assert_allclose(np.loadtxt(os.path.join(out, "demo_lr.csv"), delimiter=","),
                               np.asarray(want["encoded_style"][0]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("flag", [["--checkpoint", "ckpts"]])
def test_demo_cli_refuses_what_is_not_ported(flag, files, capsys):
    with pytest.raises(SystemExit):
        tdemo.main(["--image_lr", files["lr"], "--semantics", files["sem"],
                    "--device", "cpu"] + flag)
    assert "deepsee_torch" in capsys.readouterr().err


def test_demo_cli_int8_runs_under_int8_inference(files, ckpt_root, tmp_path, monkeypatch):
    """--int8 runs the demo inside int8_inference(): the generator's convs
    quantized (those reckoned at min_ch 64), the written image the port
    demo's under the context."""
    import deepsee_torch.config as tconfig
    from deepsee_torch.models.layers import int8_inference
    from deepsee_torch.ops import int8conv
    from test_torch_int8 import reckoned_int8_convs

    monkeypatch.setattr(tconfig, "get_preset", lambda name: torch_tiny())
    d = _reference_dir(False, ckpt_root)
    int8conv.reset_launches()
    tdemo.main(["--name", "tiny", "--image_lr", files["lr"], "--semantics", files["sem"],
                "--torch_checkpoint", d, "--device", "cpu", "--out", str(tmp_path / "cli"),
                "--int8"])
    assert int8conv.plain_calls["int8_conv"] == reckoned_int8_convs(torch_tiny().model, 64)
    demo = tdemo.Demo(_exp(torch_tiny), device="cpu")
    load_reference_checkpoint(demo.system, d)
    with int8_inference():
        want = demo.run(files["lr"], files["sem"], out_dir=str(tmp_path / "direct"))
    plain = demo.run(files["lr"], files["sem"], out_dir=str(tmp_path / "float"))
    png = {k: np.asarray(Image.open(os.path.join(str(tmp_path), k, "demo_lr.png")))
           for k in ("cli", "direct", "float")}
    np.testing.assert_array_equal(png["cli"], png["direct"])
    assert not np.array_equal(png["cli"], png["float"])
    assert os.path.basename(want["save_path"]) == os.path.basename(plain["save_path"])


def test_demo_cli_defaults_to_cuda(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdemo.main(["--image_lr", files["lr"], "--semantics", files["sem"]])
