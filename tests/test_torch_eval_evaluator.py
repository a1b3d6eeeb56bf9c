"""deepsee_torch.eval.evaluator end to end against
deepsee_tpu.eval.evaluator.InferenceEvaluator on the tiny test
configuration, float32 on the CPU: one list of numpy batches (with their
"path" lists) fed to both; G and E carried across by load_jax_variables
(realistic_variables), the Inception by one pt_inception-format file both
read, LPIPS by weights.lpips_jax_to_state_dict.  Compared: every key of the
result, the metrics.csv rows and the fid_stats_*.npz files, for a last
batch that overshoots num_samples and for num_samples below one batch (FID
of a single sample: the covariance route).  The FID-500 fallbacks are held
on their own.

Tolerances: the two generators' float32 outputs differ by summation order
(~1e-6), which can move a pixel across a uint8 level; PSNR within 2e-3 dB,
SSIM within 1e-4, RMSE, MS-SSIM and LPIPS within 1e-4 relative, FID within
1e-4 relative, the fid_stats within 1e-4 relative.
"""

import csv
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.eval.evaluator import InferenceEvaluator as JaxEvaluator
from deepsee_tpu.eval.evaluator import MetricsCSVWriter as JaxCSVWriter
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.data import to_device
from deepsee_torch.eval import evaluator as tev
from deepsee_torch.eval.metrics import batch_metrics
from deepsee_torch.system import SRSystem
from deepsee_torch.weights import inception_jax_to_state_dict, lpips_jax_to_state_dict
from test_torch_eval_fid import _jax_params
from test_torch_layers import realistic_variables

PSNR_ATOL_DB = 2e-3
SSIM_ATOL = 1e-4
RTOL = 1e-4


def _batches(cfg, n=3, bsize=2):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        hw = (bsize, cfg.crop_size, cfg.crop_size)
        out.append({"image_hr": np.tanh(1.5 * rng.randn(*hw, 3)).astype(np.float32),
                    "label": rng.randint(0, cfg.label_nc, hw).astype(np.int32),
                    "path": [f"img_{i}_{j}.png" for j in range(bsize)]})
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX evaluator and the port's, on the same weights."""
    root = tmp_path_factory.mktemp("eval")
    inception = str(root / "pt_inception.pth")
    torch.save(inception_jax_to_state_dict(_jax_params()), inception)
    exp = jax_tiny().replace(is_train=False)
    jsys = JaxSystem(exp)
    variables = jsys.init(jax.random.PRNGKey(0))
    g = realistic_variables(variables.g, 1)
    e = realistic_variables(variables.e, 2)
    variables = dataclasses.replace(variables, g=g, e=e)
    jev = JaxEvaluator(jsys, 5, write_details=True, folder_out=str(root / "jax_a"),
                       inception_weights=inception)
    port = SRSystem(torch_tiny().replace(is_train=False), device="cpu")
    port.load_jax_variables(g, e)
    return jev, variables, port, inception, root


def _port_evaluator(port, n, folder, inception, jev):
    ev = tev.InferenceEvaluator(port, n, write_details=True, folder_out=folder,
                                inception_weights=inception)
    assert ev.fid_exact and not ev.lpips_exact
    ev.lpips.load_state_dict(lpips_jax_to_state_dict(jev.lpips_params), strict=True)
    return ev


def _csv(folder):
    with open(os.path.join(folder, "metrics.csv")) as f:
        return list(csv.reader(f))


def _close(name, got, want):
    if name.startswith("psnr"):
        return abs(got - want) <= PSNR_ATOL_DB
    if name.startswith("ssim"):
        return abs(got - want) <= SSIM_ATOL
    return abs(got - want) <= RTOL * abs(want) or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("num_samples,n_rows", [(5, 6), (1, 2)])
def test_evaluator_matches_jax(pair, num_samples, n_rows):
    jev, variables, port, inception, root = pair
    tag = f"n{num_samples}"
    jdir, tdir = str(root / f"jax_{tag}"), str(root / f"port_{tag}")
    jev.num_samples, jev.folder_out = num_samples, jdir
    jev.writer = JaxCSVWriter(jdir, ["ID", "PSNR", "SSIM", "MSSSIM", "RMSE", "LPIPS"])
    batches = _batches(port.cfg)
    want = jev.run(variables, batches)
    ev = _port_evaluator(port, num_samples, tdir, inception, jev)
    got = ev.run(batches)
    jev.writer.close()
    ev.writer.close()

    assert set(got) == set(want) and got["n_samples"] == want["n_samples"] == num_samples
    assert 0 < got["FID"] < 500
    for key, value in want.items():
        if key not in ("n_samples", "eval_seconds"):
            assert _close(key, got[key], value), (key, got[key], value)
    assert np.isfinite(got["psnr/mean"]) and got["lpips/mean"] > 0

    rows, jrows = _csv(tdir), _csv(jdir)
    assert len(rows) == len(jrows) == n_rows + 1 and rows[0] == jrows[0]
    for row, jrow in zip(rows[1:], jrows[1:]):
        assert row[0] == jrow[0] and row[0].startswith("img_")
        for name, g, w in zip(("psnr", "ssim", "ms_ssim", "rmse", "lpips"), row[1:], jrow[1:]):
            assert _close(name, float(g), float(w)), (name, g, w)

    for side in ("fake", "real"):
        fname = f"fid_stats_{num_samples}samples_{side}.npz"
        with np.load(os.path.join(tdir, fname)) as t, np.load(os.path.join(jdir, fname)) as j:
            for key in ("mu", "sigma"):
                scale = np.nanmax(np.abs(j[key])) if np.isfinite(j[key]).any() else 1.0
                np.testing.assert_allclose(t[key], j[key], rtol=0, atol=RTOL * scale)


def test_run_batch_matches_the_sweep_and_leaves_modes(pair):
    """run_batch returns the generator's image and the real one; a training
    system's networks are back in train mode after run and run_batch."""
    _, _, port, _, _ = pair
    ev = tev.InferenceEvaluator(port, 2, compute_fid=False, compute_lpips=False)
    batch = _batches(port.cfg, n=1)[0]
    fake, real = ev.run_batch(batch)
    np.testing.assert_array_equal(real.numpy(), batch["image_hr"])
    m = ev.sweep(to_device(batch, ev.device))
    assert set(m) == {"psnr", "ssim", "ms_ssim", "rmse"}
    for key, value in batch_metrics(fake, real).items():
        torch.testing.assert_close(m[key], value, rtol=0, atol=0, equal_nan=True)
    port.generator.train()
    try:
        ev.run([batch])
        ev.run_batch(batch)
        assert port.generator.training and not port.encoder.training
    finally:
        port.generator.eval()


def test_fid_failure_logs_500(pair, monkeypatch, capsys):
    _, _, port, _, _ = pair

    def fail(*a, **k):
        raise np.linalg.LinAlgError("no convergence")

    ev = tev.InferenceEvaluator(port, 2, compute_lpips=False)
    monkeypatch.setattr(tev.fid_mod, "fid_from_activations", fail)
    assert ev.run(_batches(port.cfg, n=1))["FID"] == 500.0
    assert "FID failed" in capsys.readouterr().out


def test_evaluate_set_falls_back_at_stop_iteration(pair, capsys):
    """A run that raises StopIteration (an exhausted loader iterator) logs
    FID 500 and goes on (evaluation.py:220-262)."""
    _, _, port, _, _ = pair
    ev = tev.InferenceEvaluator(port, 2, compute_fid=False, compute_lpips=False)
    ev.run = lambda loader: next(iter(loader))
    assert tev.evaluate_set(ev, []) == {"FID": 500.0}
    assert "iterator exhausted" in capsys.readouterr().out


def test_strict_float32_restores_the_settings():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tev.strict_float32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
