"""The port's HTTP serving daemon (deepsee_torch/server.py): its own copy
of the tests/test_server.py cases that need no TPU, over port artifacts
(deepsee_torch/serve.py) exported on the CPU and served with
device="cpu".

Concurrent requests are micro-batched into the artifact's fixed trace
batch, padded and sliced back; each response must equal a direct
computation of the SAME loaded program on the request's sample (which
also locks the per-sample independence padding relies on: eval-mode norms,
no style noise).  Besides: the daemon refuses to start without a card
unless asked for the CPU, refuses an artifact exported for another
device, and a batch whose program fails answers HTTP 500 and counts its
requests as errors.
"""

import base64
import concurrent.futures
import dataclasses
import functools
import http.client
import io
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from deepsee_torch import server as server_mod
from deepsee_torch.config import tiny_test_experiment
from deepsee_torch.ops import modnorm as mn
from deepsee_torch.serve import export_serving, load_serving, save_serving
from deepsee_torch.server import (BadRequest, MicroBatcher, ServingServer,
                                  decode_image_b64, decode_label_b64,
                                  encode_image_b64)
from deepsee_torch.system import SRSystem
from deepsee_torch.utils.images import tensor2im
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

GUIDED = dict(net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.05)


def _export(out_dir, seed=0, guided=False):
    """A tiny port artifact (trace batch 2) exported on the CPU."""
    exp = tiny_test_experiment(is_train=False)
    if guided:
        exp = exp.replace(model=dataclasses.replace(exp.model, **GUIDED))
    system = SRSystem(exp, device="cpu")
    system.init(torch.Generator().manual_seed(seed))
    programs = export_serving(system, batch_size=2)
    save_serving(str(out_dir), exp, programs, batch_size=2, device="cpu")
    return exp


@functools.cache
def _loaded(artifact_dir: str, name: str):
    """A program loaded once per test module (loading takes seconds)."""
    return load_serving(artifact_dir, name)


def _call(fn, *arrays):
    """The loaded program on numpy arrays, as the device thread calls it."""
    return server_mod.numpy_program(fn, torch.device("cpu"))(*arrays)


def _png_b64(arr_u8: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _request_payload(cfg, seed: int, guided: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    body = {
        "image_lr": _png_b64(rng.randint(
            0, 256, (cfg.start_size, cfg.start_size, 3), dtype=np.uint8)),
        "label": _png_b64(rng.randint(
            0, cfg.label_nc, (cfg.crop_size, cfg.crop_size),
            dtype=np.uint8)),
    }
    if guided:
        body["guiding_image"] = _png_b64(rng.randint(
            0, 256, (cfg.crop_size, cfg.crop_size, 3), dtype=np.uint8))
        body["guiding_label"] = _png_b64(rng.randint(
            0, cfg.label_nc, (cfg.crop_size, cfg.crop_size),
            dtype=np.uint8))
    return body


def _post(port: int, path: str, body: dict, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port: int, path: str, timeout=30):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("artifact")
    exp = _export(d)
    return str(d), exp


@pytest.fixture(scope="module")
def guided_artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("guided_artifact")
    exp = _export(d, seed=1, guided=True)
    return str(d), exp


@pytest.fixture(scope="module")
def server(artifact):
    d, _ = artifact
    srv = ServingServer(d, port=0, batch_window_ms=30.0, device="cpu")
    srv.start()
    yield srv
    srv.stop()


def _expected_end_to_end(artifact_dir, exp, body):
    """Direct single-request computation through the raw program."""
    cfg = exp.model
    fn = _loaded(artifact_dir, "end_to_end")
    lr = decode_image_b64(body["image_lr"], cfg.start_size)
    lab = decode_label_b64(body["label"], cfg.crop_size, cfg.label_nc)
    # pad to the trace batch by repetition, slice row 0
    fake, style = _call(fn, np.concatenate([lr, lr]), np.concatenate([lab, lab]))
    return fake[0], style[0]


def test_concurrent_requests_batched(server, artifact):
    d, exp = artifact
    cfg = exp.model
    bodies = [_request_payload(cfg, seed) for seed in range(3)]

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        results = list(pool.map(
            lambda b: _post(server.port, "/v1/super_resolve", b), bodies))

    for body, (status, resp) in zip(bodies, results):
        assert status == 200, resp
        img = decode_image_b64(resp["image"], cfg.crop_size)[0]
        want_fake, want_style = _expected_end_to_end(d, exp, body)
        # response image is PNG u8-quantized via tensor2im; compare there
        np.testing.assert_array_equal(tensor2im(img), tensor2im(want_fake))
        np.testing.assert_allclose(np.asarray(resp["style"], np.float32),
                                   want_style, rtol=1e-5, atol=1e-6)

    status, health = _get(server.port, "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["stats"]["requests"] >= 3
    # 3 requests into trace batch 2 -> at least one coalesced batch
    assert health["stats"]["batches"] < health["stats"]["requests"]


def test_styled_path(server, artifact):
    d, exp = artifact
    cfg = exp.model
    body = _request_payload(cfg, seed=7)
    rng = np.random.RandomState(7)
    style = rng.randn(cfg.label_nc, cfg.regional_style_size).astype(
        np.float32) * 0.1
    body["style"] = style.tolist()

    status, resp = _post(server.port, "/v1/super_resolve", body)
    assert status == 200, resp
    assert "style" not in resp  # styled path renders, doesn't encode

    fn = _loaded(d, "styled")
    lr = decode_image_b64(body["image_lr"], cfg.start_size)
    lab = decode_label_b64(body["label"], cfg.crop_size, cfg.label_nc)
    sty = style[None]
    fake = _call(fn, np.concatenate([lr, lr]), np.concatenate([lab, lab]),
                 np.concatenate([sty, sty]))[0][0]
    got = decode_image_b64(resp["image"], cfg.crop_size)[0]
    np.testing.assert_array_equal(tensor2im(got), tensor2im(fake))


def test_bad_requests(server, artifact):
    _, exp = artifact
    cfg = exp.model
    status, resp = _post(server.port, "/v1/super_resolve", {})
    assert status == 400 and "image_lr" in resp["error"]

    body = _request_payload(cfg, seed=1)
    body["style"] = [[0.0]]  # wrong shape
    status, resp = _post(server.port, "/v1/super_resolve", body)
    assert status == 400 and "style shape" in resp["error"]

    body = _request_payload(cfg, seed=1)
    body["image_lr"] = "not base64 png!!"
    status, resp = _post(server.port, "/v1/super_resolve", body)
    assert status == 400

    status, resp = _get(server.port, "/manifest")
    assert status == 200 and resp["batch_size"] == 2


def test_microbatcher_pads_and_slices():
    """Unit-level: a fn with visible batch structure proves pad+slice."""
    calls = []

    def fn(x):
        calls.append(np.asarray(x).shape)
        return np.asarray(x) * 2.0

    mb = MicroBatcher({"p": (fn, 4)}, batch_window_ms=50.0)
    try:
        futs = [mb.submit("p", (np.full((1, 3), i, np.float32),))
                for i in range(3)]
        outs = [f.result(timeout=10) for f in futs]
        for i, out in enumerate(outs):
            np.testing.assert_allclose(out[0], np.full((3,), 2.0 * i))
        assert all(s == (4, 3) for s in calls)  # padded to the trace batch
    finally:
        mb.close()


def test_microbatcher_error_propagates():
    def fn(x):
        raise RuntimeError("boom")

    mb = MicroBatcher({"p": (fn, 2)}, batch_window_ms=1.0)
    try:
        fut = mb.submit("p", (np.zeros((1, 2), np.float32),))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=10)
        assert mb.stats["errors"] == 1
    finally:
        mb.close()


def test_image_codec_roundtrip():
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)
    b64 = _png_b64(u8)
    dec = decode_image_b64(b64, 16)[0]
    # decode -> tensor2im re-encode is lossy by at most 1 u8 step
    # (tensor2im truncates, matching util/util.py:72-103)
    assert np.abs(tensor2im(dec).astype(int) - u8.astype(int)).max() <= 1
    assert encode_image_b64(dec) is not None
    # label 255 maps to label_nc
    lab = np.full((16, 16), 255, np.uint8)
    dec_lab = decode_label_b64(_png_b64(lab), 16, 19)[0]
    assert (dec_lab == 19).all()


def test_guided_parse_requires_guiding_fields(artifact):
    """Guided manifests demand guiding_image/guiding_label; the styled
    path must keep working without them (no second artifact export
    needed — only the parser is guided-aware)."""
    d, exp = artifact
    srv = ServingServer.__new__(ServingServer)  # parser-only instance
    srv.manifest = dict(json.load(open(d + "/manifest.json")),
                        guiding_style_image=True)
    srv.manifests = {"m": srv.manifest}
    srv.default_model = "m"
    cfg = exp.model

    body = _request_payload(cfg, seed=3)
    with pytest.raises(BadRequest, match="guiding"):
        srv._parse_request(body)

    body = _request_payload(cfg, seed=3, guided=True)
    program, args = srv._parse_request(body)
    assert program == "m/end_to_end" and len(args) == 4
    assert args[2].shape == (1, cfg.crop_size, cfg.crop_size, 3)

    # style present routes to styled regardless of guidance
    body["style"] = np.zeros(
        (cfg.label_nc, cfg.regional_style_size), np.float32).tolist()
    program, args = srv._parse_request(body)
    assert program == "m/styled" and len(args) == 3


def test_stop_before_start_does_not_hang(artifact):
    """socketserver.shutdown() waits on an event only serve_forever sets;
    stop() must be safe on a constructed-but-never-started server."""
    d, _ = artifact
    srv = ServingServer(d, port=0, device="cpu")
    t0 = time.monotonic()
    srv.stop()
    assert time.monotonic() - t0 < 10


def test_submit_after_close_raises():
    mb = MicroBatcher({"p": (lambda x: x, 2)}, batch_window_ms=1.0)
    mb.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        mb.submit("p", (np.zeros((1, 1), np.float32),))


def test_microbatcher_stress_mixed_programs():
    """50 requests, 8 client threads, two programs with different trace
    batches and artificial jitter: every future must resolve with exactly
    its own input transformed, batches never exceed their cap, and
    nothing deadlocks."""
    seen = {"a": [], "b": []}
    lock = threading.Lock()

    def make_fn(name, factor):
        def fn(x):
            time.sleep(0.002)  # device-call jitter
            with lock:
                seen[name].append(np.asarray(x).shape[0])
            return np.asarray(x) * factor
        return fn

    mb = MicroBatcher({"a": (make_fn("a", 2.0), 3),
                       "b": (make_fn("b", -1.0), 5)},
                      batch_window_ms=4.0)
    try:
        futs = []
        def client(base):
            for i in range(base, base + 25):
                prog = "a" if i % 3 else "b"
                futs.append((prog, i, mb.submit(
                    prog, (np.full((1, 4), float(i), np.float32),))))
                time.sleep(0.0005 * (i % 4))

        threads = [threading.Thread(target=client, args=(k * 25,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        for prog, i, f in futs:
            out = f.result(timeout=30)[0]
            want = i * (2.0 if prog == "a" else -1.0)
            np.testing.assert_allclose(out, np.full((4,), want))
        assert all(s == 3 for s in seen["a"])  # padded to each cap
        assert all(s == 5 for s in seen["b"])
        assert mb.stats["errors"] == 0
        assert mb.stats["requests"] == 50
    finally:
        mb.close()


def test_microbatcher_shutdown_under_load():
    """close() during a submit storm: every accepted request either
    resolves or fails with the shutdown error — none hang."""
    import threading

    def fn(x):
        return np.asarray(x)

    mb = MicroBatcher({"p": (fn, 4)}, batch_window_ms=2.0)
    futs, rejected = [], []

    def client():
        for i in range(30):
            try:
                futs.append(mb.submit(
                    "p", (np.full((1, 2), float(i), np.float32),)))
            except RuntimeError:
                rejected.append(i)

    t = threading.Thread(target=client)
    t.start()
    mb.close()
    t.join()

    for f in futs:
        try:
            f.result(timeout=10)  # resolved value or shutdown error ok
        except RuntimeError as e:
            assert "shut down" in str(e)
    assert len(futs) + len(rejected) == 30


def test_guided_artifact_end_to_end(guided_artifact):
    """The 4-arg guided program through the daemon's full HTTP + batching
    path (the parse-level test above covers routing only)."""
    d, exp = guided_artifact
    srv = ServingServer(d, port=0, batch_window_ms=20.0, device="cpu")
    srv.start()
    try:
        cfg = exp.model
        bodies = [_request_payload(cfg, seed, guided=True)
                  for seed in (11, 12)]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            results = list(pool.map(
                lambda b: _post(srv.port, "/v1/super_resolve", b), bodies))

        fn = _loaded(d, "end_to_end")
        for body, (status, resp) in zip(bodies, results):
            assert status == 200, resp
            lr = decode_image_b64(body["image_lr"], cfg.start_size)
            lab = decode_label_b64(body["label"], cfg.crop_size,
                                   cfg.label_nc)
            gi = decode_image_b64(body["guiding_image"], cfg.crop_size)
            gl = decode_label_b64(body["guiding_label"], cfg.crop_size,
                                  cfg.label_nc)
            fake, style = _call(fn, np.concatenate([lr, lr]),
                                np.concatenate([lab, lab]),
                                np.concatenate([gi, gi]),
                                np.concatenate([gl, gl]))
            got = decode_image_b64(resp["image"], cfg.crop_size)[0]
            np.testing.assert_array_equal(tensor2im(got), tensor2im(fake[0]))
            np.testing.assert_allclose(
                np.asarray(resp["style"], np.float32),
                style[0], rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()


def test_raw_encoding_matches_png(server, artifact):
    """`"encoding": "raw"` (b64 uint8 bytes, no PNG codec) must produce
    the identical result to the PNG wire format for the same pixels —
    both quantize through tensor2im and scale u8 -> [-1,1] the same way.
    Malformed raw payloads and unknown encodings are 400s."""
    d, exp = artifact
    cfg = exp.model
    rng = np.random.RandomState(31)
    lr_u8 = rng.randint(0, 256, (cfg.start_size, cfg.start_size, 3),
                        dtype=np.uint8)
    lab_u8 = rng.randint(0, cfg.label_nc,
                         (cfg.crop_size, cfg.crop_size), dtype=np.uint8)

    png_body = {"image_lr": _png_b64(lr_u8), "label": _png_b64(lab_u8)}
    raw_body = {
        "encoding": "raw",
        "image_lr": base64.b64encode(lr_u8.tobytes()).decode("ascii"),
        "label": base64.b64encode(lab_u8.tobytes()).decode("ascii"),
    }
    status, png_resp = _post(server.port, "/v1/super_resolve", png_body)
    assert status == 200, png_resp
    status, raw_resp = _post(server.port, "/v1/super_resolve", raw_body)
    assert status == 200, raw_resp

    # raw response: b64 of crop*crop*3 uint8 bytes, equal to the PNG
    # response's decoded pixels
    raw_img = np.frombuffer(base64.b64decode(raw_resp["image"]),
                            np.uint8)
    assert raw_img.size == cfg.crop_size * cfg.crop_size * 3
    raw_img = raw_img.reshape(cfg.crop_size, cfg.crop_size, 3)
    png_img = np.asarray(Image.open(io.BytesIO(
        base64.b64decode(png_resp["image"]))))
    np.testing.assert_array_equal(raw_img, png_img)
    np.testing.assert_allclose(
        np.asarray(raw_resp["style"], np.float32),
        np.asarray(png_resp["style"], np.float32), rtol=1e-6)

    status, resp = _post(server.port, "/v1/super_resolve",
                         dict(raw_body, encoding="jpeg2000"))
    assert status == 400 and "unknown encoding" in resp["error"]
    bad = dict(raw_body,
               image_lr=base64.b64encode(b"\x00" * 7).decode("ascii"))
    status, resp = _post(server.port, "/v1/super_resolve", bad)
    assert status == 400 and "undecodable input" in resp["error"]


def test_multi_artifact_daemon(artifact, tmp_path):
    """One daemon, two artifacts (different weights): requests route by
    the "model" field, each (alias, program) micro-batches independently,
    /v1/models lists both manifests, /healthz reports per-program stats,
    and an unknown alias is a 400."""
    d, exp = artifact
    cfg = exp.model

    # second artifact: same architecture, different init -> different output
    _export(tmp_path, seed=2)

    srv = ServingServer([f"main={d}", f"alt={tmp_path}"], port=0,
                        batch_window_ms=5.0, device="cpu")
    srv.start()
    try:
        status, models = _get(srv.port, "/v1/models")
        assert status == 200 and sorted(models) == ["alt", "main"]
        assert models["main"]["batch_size"] == 2

        body = _request_payload(cfg, seed=21)
        status, default_resp = _post(srv.port, "/v1/super_resolve", body)
        assert status == 200, default_resp
        status, main_resp = _post(srv.port, "/v1/super_resolve",
                                  dict(body, model="main"))
        assert status == 200, main_resp
        status, alt_resp = _post(srv.port, "/v1/super_resolve",
                                 dict(body, model="alt"))
        assert status == 200, alt_resp

        # default routes to the first artifact; alt weights really differ
        assert default_resp["image"] == main_resp["image"]
        assert alt_resp["image"] != main_resp["image"]

        # each model's response equals its own direct program output
        for adir, resp in ((d, main_resp), (str(tmp_path), alt_resp)):
            want_fake, want_style = _expected_end_to_end(adir, exp, body)
            got = decode_image_b64(resp["image"], cfg.crop_size)[0]
            np.testing.assert_array_equal(tensor2im(got),
                                          tensor2im(want_fake))
            np.testing.assert_allclose(
                np.asarray(resp["style"], np.float32), want_style,
                rtol=1e-5, atol=1e-6)

        status, resp = _post(srv.port, "/v1/super_resolve",
                             dict(body, model="nope"))
        assert status == 400 and "unknown model" in resp["error"]

        status, health = _get(srv.port, "/healthz")
        assert status == 200
        progs = health["programs"]
        assert progs["main/end_to_end"]["requests"] == 2
        assert progs["alt/end_to_end"]["requests"] == 1
        assert progs["alt/styled"]["requests"] == 0
        assert health["models"] == ["alt", "main"]
    finally:
        srv.stop()


def _post_bin(port: int, raw: bytes, headers=None, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/super_resolve_bin", data=raw,
        headers={"Content-Type": "application/octet-stream",
                 **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_binary_protocol_matches_json(server, artifact):
    """/v1/super_resolve_bin (no JSON, no base64) must reproduce the JSON
    path exactly: same quantized image, same style matrix; the styled
    route via X-DS-Style supersedes guidance like the JSON path; a wrong
    body length is a 400 naming the expected layout."""
    d, exp = artifact
    cfg = exp.model
    rng = np.random.RandomState(47)
    lr_u8 = rng.randint(0, 256, (cfg.start_size, cfg.start_size, 3),
                        dtype=np.uint8)
    lab_u8 = rng.randint(0, cfg.label_nc,
                         (cfg.crop_size, cfg.crop_size), dtype=np.uint8)

    json_body = {"image_lr": _png_b64(lr_u8), "label": _png_b64(lab_u8)}
    status, json_resp = _post(server.port, "/v1/super_resolve", json_body)
    assert status == 200, json_resp

    status, blob, hdrs = _post_bin(
        server.port, lr_u8.tobytes() + lab_u8.tobytes())
    assert status == 200, blob[:300]
    assert hdrs["Content-Type"] == "application/octet-stream"
    style_n = int(hdrs["X-DS-Style-Bytes"])
    img_n = cfg.crop_size * cfg.crop_size * 3
    assert len(blob) == img_n + style_n
    bin_img = np.frombuffer(blob[:img_n], np.uint8).reshape(
        cfg.crop_size, cfg.crop_size, 3)
    bin_style = np.frombuffer(blob[img_n:], "<f4").reshape(
        cfg.label_nc, cfg.regional_style_size)

    json_img = np.asarray(Image.open(io.BytesIO(
        base64.b64decode(json_resp["image"]))))
    np.testing.assert_array_equal(bin_img, json_img)
    np.testing.assert_allclose(
        bin_style, np.asarray(json_resp["style"], np.float32),
        rtol=1e-6, atol=0)

    # styled route: trailing f32-LE style + X-DS-Style: 1; response has
    # no style tail and equals the JSON styled path
    style = (rng.randn(cfg.label_nc, cfg.regional_style_size)
             .astype("<f4") * 0.1)
    status, blob, hdrs = _post_bin(
        server.port,
        lr_u8.tobytes() + lab_u8.tobytes() + style.tobytes(),
        headers={"X-DS-Style": "1"})
    assert status == 200, blob[:300]
    assert int(hdrs["X-DS-Style-Bytes"]) == 0 and len(blob) == img_n
    status, json_styled = _post(
        server.port, "/v1/super_resolve",
        dict(json_body, style=style.astype(np.float32).tolist()))
    assert status == 200, json_styled
    json_styled_img = np.asarray(Image.open(io.BytesIO(
        base64.b64decode(json_styled["image"]))))
    np.testing.assert_array_equal(
        np.frombuffer(blob, np.uint8).reshape(
            cfg.crop_size, cfg.crop_size, 3), json_styled_img)

    # wrong length -> 400 that names the expected layout
    status, blob, _ = _post_bin(server.port, b"\x00" * 7)
    assert status == 400
    err = json.loads(blob)["error"]
    assert "binary body is 7 bytes" in err and "image_lr" in err

    # unknown model alias -> 400
    status, blob, _ = _post_bin(
        server.port, lr_u8.tobytes() + lab_u8.tobytes(),
        headers={"X-DS-Model": "nope"})
    assert status == 400 and "unknown model" in json.loads(blob)["error"]


def test_binary_protocol_guided_layout(guided_artifact):
    """Guided models read guiding_image + guiding_label from the binary
    body (and the 400 for a short body names the guiding fields)."""
    d, exp = guided_artifact
    cfg = exp.model

    srv = ServingServer(d, port=0, batch_window_ms=5.0, device="cpu")
    srv.start()
    try:
        rng = np.random.RandomState(3)
        lr_u8 = rng.randint(0, 256, (cfg.start_size, cfg.start_size, 3),
                            dtype=np.uint8)
        lab_u8 = rng.randint(0, cfg.label_nc,
                             (cfg.crop_size, cfg.crop_size), dtype=np.uint8)
        g_img_u8 = rng.randint(0, 256, (cfg.crop_size, cfg.crop_size, 3),
                               dtype=np.uint8)

        status, blob, hdrs = _post_bin(
            srv.port, lr_u8.tobytes() + lab_u8.tobytes()
            + g_img_u8.tobytes() + lab_u8.tobytes())
        assert status == 200, blob[:300]
        img_n = cfg.crop_size * cfg.crop_size * 3
        assert len(blob) == img_n + int(hdrs["X-DS-Style-Bytes"])

        # equals the JSON guided path on the same pixels
        body = {"image_lr": _png_b64(lr_u8), "label": _png_b64(lab_u8),
                "guiding_image": _png_b64(g_img_u8),
                "guiding_label": _png_b64(lab_u8)}
        status, json_resp = _post(srv.port, "/v1/super_resolve", body)
        assert status == 200, json_resp
        json_img = np.asarray(Image.open(io.BytesIO(
            base64.b64decode(json_resp["image"]))))
        np.testing.assert_array_equal(
            np.frombuffer(blob[:img_n], np.uint8).reshape(
                cfg.crop_size, cfg.crop_size, 3), json_img)

        status, blob, _ = _post_bin(
            srv.port, lr_u8.tobytes() + lab_u8.tobytes())
        assert status == 400
        assert "guiding_image" in json.loads(blob)["error"]
    finally:
        srv.stop()


# -- the port's own contract ------------------------------------------------

def test_daemon_without_card_raises(artifact, monkeypatch):
    """The daemon runs on CUDA unless asked for the CPU: without a card it
    raises at start-up, from the constructor and from the CLI."""
    d, _ = artifact
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingServer(d, port=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        server_mod.main(["--artifact", d, "--port", "0"])


def test_artifact_for_another_device_is_refused(artifact, tmp_path):
    d, _ = artifact
    for name in os.listdir(d):
        data = open(os.path.join(d, name), "rb").read()
        (tmp_path / name).write_bytes(data)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    (tmp_path / "manifest.json").write_text(json.dumps(dict(manifest, device="cuda")))
    with pytest.raises(ValueError, match="exported for cuda"):
        ServingServer(str(tmp_path), port=0, device="cpu")


def test_failed_batch_answers_500_and_counts(server, artifact, monkeypatch):
    """A batch whose program fails inside the kernel op fails its requests
    with HTTP 500 and counts them in stats["errors"]; nothing falls back."""
    _, exp = artifact

    def broken(*args, **kwargs):
        raise RuntimeError("modnorm launch failed")

    server.batcher.reset_stats()
    monkeypatch.setattr(mn, "modnorm_plain", broken)
    bodies = [_request_payload(exp.model, seed) for seed in (41, 42)]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        results = list(pool.map(
            lambda b: _post(server.port, "/v1/super_resolve", b), bodies))
    for status, resp in results:
        assert status == 500 and "modnorm launch failed" in resp["error"]
    stats = server.batcher.stats_snapshot()
    assert stats["errors"] == 2 and stats["batched_samples"] == 0
    monkeypatch.undo()
    status, _ = _post(server.port, "/v1/super_resolve", bodies[0])
    assert status == 200


def test_oversized_body_is_refused_unread(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    try:
        conn.putrequest("POST", "/v1/super_resolve_bin")
        conn.putheader("Content-Length", str(server_mod.MAX_BODY_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert "byte limit" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_device_thread_returns_numpy(artifact):
    """numpy_program: numpy in, the loaded program on the device, numpy out."""
    d, exp = artifact
    cfg = exp.model
    rng = np.random.RandomState(5)
    lr = rng.uniform(-1, 1, (2, cfg.start_size, cfg.start_size, 3)).astype(np.float32)
    lab = rng.randint(0, cfg.label_nc, (2, cfg.crop_size, cfg.crop_size)).astype(np.int32)
    fake, style = _call(load_serving(d), lr, lab)
    assert isinstance(fake, np.ndarray) and fake.shape == (2, 32, 32, 3)
    assert style.shape == (2, cfg.label_nc, cfg.regional_style_size)
