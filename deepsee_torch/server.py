"""HTTP serving daemon over the port's exported programs: an own copy of
deepsee_tpu/server.py for deepsee_torch artifacts (deepsee_torch/serve.py).

The daemon loads one or more `torch.export` artifact directories, owns the
device from ONE worker thread (which passes numpy batches into the loaded
programs and returns numpy), and coalesces concurrent requests into each
artifact's fixed trace batch via micro-batching with padding.

  python -m deepsee_torch.server --artifact exported_dir/ --port 8000 \
      [--device cuda]

The device defaults to CUDA; without a card the daemon raises at start-up
unless given --device cpu, and it serves only artifacts exported for its
device.  A served batch whose program fails (a kernel that does not build
or launch, say) fails that batch's requests with HTTP 500 and counts in
stats["errors"]; nothing falls back to another path.

API (JSON over HTTP, stdlib-only on both ends):

  GET  /healthz   -> {"status": "ok", "model": ..., "stats": {...},
                      "programs": per-program stats, "models": [aliases]}
  GET  /manifest  -> the DEFAULT artifact's manifest.json
  GET  /v1/models -> {alias: manifest} for every loaded artifact
  POST /v1/super_resolve
       body: {"model": "<alias>" (optional; default = first artifact --
                  one daemon can serve several artifacts, each alias its
                  own micro-batched programs),
              "image_lr": <b64 PNG, start_size RGB>,
              "label":    <b64 PNG, crop_size, values 0..18 or 255>,
              "guiding_image"/"guiding_label": same encodings (guided
                  models only; required there),
              "style": [[...]] (label_nc x regional_style_size) -- when
                  present the `styled` program renders with this style
                  matrix instead of encoding one (the manipulation path),
              "encoding": "png" (default) | "raw" -- with "raw" every
                  image field is b64 of raw uint8 bytes (RGB HxWx3 for
                  images, HxW for labels) and the response image comes
                  back raw too; no image codec is needed}
       resp: {"image": <b64 PNG or raw, crop_size RGB>,
              "style": [[...]]}   (style omitted on the styled path)
  POST /v1/super_resolve_bin
       application/octet-stream, no JSON/base64 at all: concatenated raw
       tensors in, raw u8 RGB (+ trailing f32-LE style) out -- see the
       "binary protocol" section in ServingServer.  Routing via the
       X-DS-Model / X-DS-Style headers.

Images follow the repo conventions (demo.py:45-61): RGB u8 -> /255*2-1;
labels NEAREST-resized (png) with 255 -> label_nc.  The PNG wire decodes
and encodes through the native codec (data/codec.py) where it builds, else
through Pillow; the raw and binary wires need neither.

Batching: requests are queued with a Future; the device thread takes the
oldest request, waits up to --batch_window_ms for more requests OF THE
SAME PROGRAM, pads the tail by repeating the last item up to the trace
batch, runs one device call, and distributes the slices.  Per-sample
independence holds because serving programs run eval-mode norms (running
stats) and no style noise, so padding rows cannot leak into real ones --
locked by tests/test_torch_server.py.
"""

from __future__ import annotations

import argparse
import base64
import collections
import json
import os
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepsee_torch.utils.images import (encode_png_bytes, image_bytes_to_array,
                                        label_bytes_to_array, tensor2im)


# request-body size cap: the largest legitimate payload (four b64 PNGs at
# 512px) is well under 8 MiB; 64 MiB leaves generous headroom
MAX_BODY_BYTES = 64 * 1024 * 1024


# -- request payload <-> arrays (demo.py:45-61 conventions) ---------------
#
# The decode conventions live in deepsee_torch/utils/images.py; these
# wrappers only handle the b64 wire framing.

def decode_image_b64(b64: str, size: int) -> np.ndarray:
    """b64 PNG/JPEG -> (1, size, size, 3) float32 in [-1, 1]."""
    return image_bytes_to_array(base64.b64decode(b64), size)


def decode_label_b64(b64: str, size: int, label_nc: int) -> np.ndarray:
    """b64 PNG -> (1, size, size) int32; 255 (unknown) -> label_nc."""
    return label_bytes_to_array(base64.b64decode(b64), size, label_nc)


def encode_image_b64(img: np.ndarray, level: int = 6) -> str:
    """(H, W, 3) float in [-1, 1] -> b64 PNG (tensor2im convention) at zlib
    `level`."""
    data = encode_png_bytes(tensor2im(img), level=level)
    return base64.b64encode(data).decode("ascii")


# "raw" wire encoding: b64 of raw uint8 bytes, no PNG codec.  PNG encode +
# decode is pure host CPU (zlib); callers that already hold pixel buffers
# should send raw (pass {"encoding": "raw"}).  Same value conventions as
# the PNG path: images are uint8 RGB (u8/255*2-1 on decode), labels uint8
# with 255 -> label_nc.

def image_from_u8(buf: np.ndarray, size: int) -> np.ndarray:
    """flat uint8 RGB (size*size*3 bytes) -> (1,size,size,3) f32."""
    if buf.size != size * size * 3:
        raise ValueError(
            f"raw image payload is {buf.size} bytes, want "
            f"{size * size * 3} ({size}x{size}x3 uint8 RGB)")
    arr = buf.reshape(size, size, 3).astype(np.float32) / 255.0 * 2.0 - 1.0
    return arr[None]


def label_from_u8(buf: np.ndarray, size: int, label_nc: int) -> np.ndarray:
    """flat uint8 (size*size bytes) -> (1,size,size) int32; 255->label_nc."""
    if buf.size != size * size:
        raise ValueError(
            f"raw label payload is {buf.size} bytes, want "
            f"{size * size} ({size}x{size} uint8)")
    arr = buf.reshape(size, size).astype(np.int32)
    return np.where(arr == 255, label_nc, arr)[None]


def decode_image_raw_b64(b64: str, size: int) -> np.ndarray:
    """b64 raw uint8 RGB (size*size*3 bytes) -> (1,size,size,3) f32."""
    return image_from_u8(np.frombuffer(base64.b64decode(b64), np.uint8),
                         size)


def decode_label_raw_b64(b64: str, size: int, label_nc: int) -> np.ndarray:
    """b64 raw uint8 (size*size bytes) -> (1,size,size) int32."""
    return label_from_u8(np.frombuffer(base64.b64decode(b64), np.uint8),
                         size, label_nc)


def encode_image_raw_b64(img: np.ndarray) -> str:
    """(H, W, 3) float in [-1, 1] -> b64 raw uint8 RGB bytes."""
    return base64.b64encode(
        np.ascontiguousarray(tensor2im(img)).tobytes()).decode("ascii")


# -- micro-batcher --------------------------------------------------------

class _Request:
    __slots__ = ("program", "args", "future")

    def __init__(self, program: str, args: Tuple[np.ndarray, ...]):
        self.program = program
        self.args = args
        self.future: Future = Future()


class MicroBatcher:
    """Single device-owner thread coalescing requests into fixed batches.

    programs: {name: (callable, trace_batch_size)}.  Each request carries
    per-sample args (leading dim 1); consecutive requests for the same
    program are stacked up to the trace batch, the tail padded by
    repetition, and sliced back after one device call.
    """

    def __init__(self, programs: Dict[str, Tuple[Callable, int]],
                 batch_window_ms: float = 5.0):
        self.programs = programs
        self.window = batch_window_ms / 1000.0
        self._pending: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self.stats = {"requests": 0, "batches": 0, "batched_samples": 0,
                      "errors": 0}
        self.per_program = {name: {"requests": 0, "batches": 0,
                                   "batched_samples": 0, "errors": 0}
                            for name in programs}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="deepsee-device-worker")
        self._thread.start()

    def submit(self, program: str, args: Tuple[np.ndarray, ...]) -> Future:
        if program not in self.programs:
            raise KeyError(f"unknown program {program!r}")
        req = _Request(program, args)
        with self._cv:
            if self._stop:
                raise RuntimeError("server shutting down")
            self._pending.append(req)
            self.stats["requests"] += 1
            self.per_program[program]["requests"] += 1
            self._cv.notify()
        return req.future

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=10)
        # requests that raced shutdown would otherwise hang on their
        # Future until the handler's timeout; fail them promptly
        with self._cv:
            while self._pending:
                req = self._pending.popleft()
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("server shut down"))

    # -- worker ----------------------------------------------------------

    def _take_batch(self) -> List[_Request]:
        """Block for the first request, then gather same-program requests
        until the trace batch fills or the window elapses."""
        with self._cv:
            while not self._pending and not self._stop:
                self._cv.wait()
            if self._stop and not self._pending:
                return []
            first = self._pending.popleft()
            cap = self.programs[first.program][1]
            batch = [first]
            deadline = time.monotonic() + self.window
            while len(batch) < cap:
                timeout = deadline - time.monotonic()
                # scan for same-program requests already queued
                took = False
                for i, r in enumerate(self._pending):
                    if r.program == first.program:
                        del self._pending[i]
                        batch.append(r)
                        took = True
                        break
                if took:
                    continue
                if timeout <= 0 or self._stop:
                    break
                self._cv.wait(timeout)
            return batch

    def _run(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
            fn, cap = self.programs[batch[0].program]
            n = len(batch)
            try:
                args = [
                    np.concatenate(
                        [r.args[j] for r in batch]
                        + [batch[-1].args[j]] * (cap - n), axis=0)
                    for j in range(len(batch[0].args))]
                out = fn(*args)
                outs = out if isinstance(out, (tuple, list)) else (out,)
                outs = [np.asarray(o) for o in outs]
                for i, r in enumerate(batch):
                    r.future.set_result(tuple(o[i] for o in outs))
                with self._cv:  # stats are read/reset from handler threads
                    self.stats["batches"] += 1
                    self.stats["batched_samples"] += n
                    pp = self.per_program[batch[0].program]
                    pp["batches"] += 1
                    pp["batched_samples"] += n
            except Exception as e:  # noqa: BLE001 — fail the whole batch
                with self._cv:
                    self.stats["errors"] += n
                    self.per_program[batch[0].program]["errors"] += n
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def stats_snapshot(self) -> Dict[str, int]:
        with self._cv:
            return dict(self.stats)

    def program_stats_snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._cv:
            return {k: dict(v) for k, v in self.per_program.items()}

    def reset_stats(self) -> None:
        with self._cv:
            for k in self.stats:
                self.stats[k] = 0
            for v in self.per_program.values():
                for k in v:
                    v[k] = 0


# -- the HTTP server ------------------------------------------------------

class BadRequest(ValueError):
    pass


def numpy_program(module: torch.nn.Module, device: torch.device) -> Callable:
    """A loaded program as the device thread calls it: numpy arrays in,
    tensors on `device`, one call with autograd off, numpy arrays out."""
    def fn(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
        with torch.inference_mode():
            out = module(*(torch.from_numpy(a).to(device) for a in arrays))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            return tuple(o.cpu().numpy() for o in outs)
    return fn


class ServingServer:
    """Loads one or more artifact dirs and serves them; start()/stop() for
    embedding.

    `artifact_dir` accepts a single directory (the v1 contract), or a
    sequence of directories / "alias=directory" entries: ONE daemon then
    serves N artifacts (two batch shapes, different models) with one
    device-owner thread — requests route by the optional
    "model" field and each (alias, program) pair micro-batches
    independently.  The first entry is the default model.

    `device` is where the programs run (CUDA unless "cpu" is asked for);
    every artifact must have been exported for it."""

    def __init__(self, artifact_dir, port: int = 8000,
                 host: str = "127.0.0.1", batch_window_ms: float = 5.0,
                 request_timeout_s: float = 600.0, device: str = "cuda",
                 png_level: int = 6):
        # the default timeout covers the first served batch, which builds
        # the CUDA kernels while every queued request waits behind it
        from deepsee_torch.serve import PROGRAMS, load_serving

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the serving daemon runs on CUDA and no CUDA device "
                               "is available; pass device='cpu' (--device cpu) to "
                               "serve CPU artifacts")
        self.png_level = png_level
        entries = ([artifact_dir] if isinstance(artifact_dir, str)
                   else list(artifact_dir))
        if not entries:
            raise ValueError("need at least one artifact directory")
        self.manifests: Dict[str, dict] = {}
        programs: Dict[str, Tuple[Callable, int]] = {}
        for entry in entries:
            alias, _, d = entry.rpartition("=")
            alias = alias or os.path.basename(os.path.normpath(d))
            if alias in self.manifests:
                raise ValueError(f"duplicate artifact alias {alias!r} — "
                                 "disambiguate with alias=dir")
            with open(os.path.join(d, "manifest.json")) as f:
                self.manifests[alias] = json.load(f)
            if self.manifests[alias]["device"] != self.device.type:
                raise ValueError(
                    f"artifact {d} was exported for {self.manifests[alias]['device']}; "
                    f"this daemon runs on {self.device.type}")
            bs = int(self.manifests[alias]["batch_size"])
            for prog in PROGRAMS:
                programs[f"{alias}/{prog}"] = (
                    numpy_program(load_serving(d, prog), self.device), bs)
        self.default_model = next(iter(self.manifests))
        # plain attribute (not a property) for the default manifest: the
        # single-artifact contract, and tests monkey-patch it directly
        self.manifest = self.manifests[self.default_model]
        self.batcher = MicroBatcher(programs, batch_window_ms)
        self.request_timeout_s = request_timeout_s
        self._httpd = ThreadingHTTPServer((host, port), self._handler_cls())
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self.t_start = time.time()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="deepsee-http")
        self._thread.start()

    def serve_forever(self):
        self._serving = True
        self._httpd.serve_forever()

    def stop(self):
        if self._serving:
            # socketserver.shutdown() waits on an event only
            # serve_forever() sets — calling it un-started deadlocks
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)
        self.batcher.close()

    # -- request handling -------------------------------------------------

    def _resolve_model(self, body: dict) -> str:
        alias = body.get("model", self.default_model)
        if not isinstance(alias, str) or alias not in self.manifests:
            raise BadRequest(
                f"unknown model {alias!r}; available: "
                f"{sorted(self.manifests)}")
        return alias

    def _model_manifest(self, alias: str) -> dict:
        # the default model reads through self.manifest so embedders/tests
        # that patch the attribute keep working
        return self.manifest if alias == self.default_model \
            else self.manifests[alias]

    @staticmethod
    def _encoding(body: dict) -> str:
        enc = body.get("encoding", "png")
        if enc not in ("png", "raw"):
            raise BadRequest(
                f"unknown encoding {enc!r}; use 'png' or 'raw'")
        return enc

    def _parse_request(self, body: dict
                       ) -> Tuple[str, Tuple[np.ndarray, ...]]:
        alias = self._resolve_model(body)
        m = self._model_manifest(alias)
        crop, start, nc = m["crop_size"], m["start_size"], m["label_nc"]
        if self._encoding(body) == "raw":
            dec_img, dec_lab = decode_image_raw_b64, decode_label_raw_b64
        else:
            dec_img, dec_lab = decode_image_b64, decode_label_b64
        try:
            image_lr = dec_img(body["image_lr"], start)
            label = dec_lab(body["label"], crop, nc)
        except KeyError as e:
            raise BadRequest(f"missing required field {e}") from e
        except Exception as e:
            raise BadRequest(f"undecodable input: {e}") from e

        if "style" in body:
            style = np.asarray(body["style"], np.float32)
            want = (nc, m["regional_style_size"])
            if style.shape != want:
                raise BadRequest(
                    f"style shape {style.shape} != {want}")
            return f"{alias}/styled", (image_lr, label, style[None])

        if m["guiding_style_image"]:
            try:
                g_img = dec_img(body["guiding_image"], crop)
                g_lab = dec_lab(body["guiding_label"], crop, nc)
            except KeyError as e:
                raise BadRequest(
                    f"guided model: missing field {e}") from e
            except Exception as e:
                raise BadRequest(f"undecodable guiding input: {e}") from e
            return f"{alias}/end_to_end", (image_lr, label, g_img, g_lab)
        return f"{alias}/end_to_end", (image_lr, label)

    def handle_super_resolve(self, body: dict) -> dict:
        program, args = self._parse_request(body)
        fut = self.batcher.submit(program, args)
        out = fut.result(timeout=self.request_timeout_s)
        if self._encoding(body) == "raw":
            resp = {"image": encode_image_raw_b64(out[0])}
        else:
            resp = {"image": encode_image_b64(out[0], self.png_level)}
        if program.endswith("/end_to_end"):
            resp["style"] = np.asarray(out[1], np.float32).tolist()
        return resp

    # -- binary protocol ----------------------------------------------------
    # /v1/super_resolve_bin skips JSON AND base64: the body is the raw
    # tensors concatenated (image_lr u8 start²·3 | label u8 crop² |
    # guided models: guiding_image u8 crop²·3 + guiding_label u8 crop² |
    # style f32-LE label_nc·rss, present iff the X-DS-Style: 1 header is
    # set — style routes to the `styled` program and supersedes guidance,
    # same as the JSON path).  Routing metadata rides headers
    # (X-DS-Model).  The response body is the upscale's raw u8 RGB bytes
    # with the style matrix (f32-LE) appended on the end_to_end path;
    # X-DS-Style-Bytes carries the split point.  base64 costs 1.33x the
    # bytes plus an encode+decode pass on both ends — on codec-bound
    # hosts this path is the serving stack's true ceiling.

    def _parse_request_bin(self, headers, raw: bytes
                           ) -> Tuple[str, Tuple[np.ndarray, ...]]:
        alias = headers.get("X-DS-Model", self.default_model)
        if alias not in self.manifests:
            raise BadRequest(
                f"unknown model {alias!r}; available: "
                f"{sorted(self.manifests)}")
        m = self._model_manifest(alias)
        crop, start, nc = m["crop_size"], m["start_size"], m["label_nc"]
        rss = m["regional_style_size"]
        styled = headers.get("X-DS-Style", "0") == "1"
        guided = bool(m["guiding_style_image"]) and not styled

        img_n, lab_n = start * start * 3, crop * crop
        g_img_n = crop * crop * 3 if guided else 0
        style_n = nc * rss * 4 if styled else 0
        want = img_n + lab_n + (g_img_n + lab_n if guided else 0) + style_n
        if len(raw) != want:
            raise BadRequest(
                f"binary body is {len(raw)} bytes, want {want} "
                f"(image_lr {img_n} + label {lab_n}"
                + (f" + guiding_image {g_img_n} + guiding_label {lab_n}"
                   if guided else "")
                + (f" + style {style_n}" if styled else "") + ")")

        buf = np.frombuffer(raw, np.uint8)
        pos = 0

        def take(n):
            nonlocal pos
            out = buf[pos:pos + n]
            pos += n
            return out

        image_lr = image_from_u8(take(img_n), start)
        label = label_from_u8(take(lab_n), crop, nc)
        if styled:
            style = np.frombuffer(take(style_n).tobytes(), "<f4")
            return f"{alias}/styled", (image_lr, label,
                                       style.reshape(1, nc, rss))
        if guided:
            g_img = image_from_u8(take(g_img_n), crop)
            g_lab = label_from_u8(take(lab_n), crop, nc)
            return f"{alias}/end_to_end", (image_lr, label, g_img, g_lab)
        return f"{alias}/end_to_end", (image_lr, label)

    def handle_super_resolve_bin(self, headers, raw: bytes
                                 ) -> Tuple[bytes, int]:
        """-> (response body, style byte count appended at the tail)."""
        program, args = self._parse_request_bin(headers, raw)
        fut = self.batcher.submit(program, args)
        out = fut.result(timeout=self.request_timeout_s)
        img = np.ascontiguousarray(tensor2im(out[0])).tobytes()
        if program.endswith("/end_to_end"):
            style = np.asarray(out[1], "<f4").tobytes()
            return img + style, len(style)
        return img, 0

    def health(self) -> dict:
        s = self.batcher.stats_snapshot()
        prog = self.batcher.program_stats_snapshot()
        # Fill ratios use each program's own trace batch — under
        # multi-artifact serving the programs have different batch sizes,
        # so the aggregate is capacity-weighted across programs.
        capacity = 0
        for name, ps in prog.items():
            cap = ps["batches"] * self.batcher.programs[name][1]
            ps["batch_fill"] = (round(ps["batched_samples"] / cap, 3)
                                if cap else 0.0)
            capacity += cap
        s["batch_fill"] = (round(s["batched_samples"] / capacity, 3)
                           if capacity else 0.0)
        return {"status": "ok", "model": self.manifest["name"],
                "uptime_s": round(time.time() - self.t_start, 1),
                "trace_batch": self.manifest["batch_size"], "stats": s,
                "models": sorted(self.manifests),
                "programs": prog}

    def _handler_cls(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(self, code: int, payload: dict):
                blob = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, server.health())
                elif self.path == "/manifest":
                    self._send(200, server.manifest)
                elif self.path == "/v1/models":
                    self._send(200, {
                        a: (server._model_manifest(a))
                        for a in server.manifests})
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path not in ("/v1/super_resolve",
                                     "/v1/super_resolve_bin"):
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > MAX_BODY_BYTES:
                        # refuse before reading: one oversized request must
                        # not be able to exhaust host memory.  The unread
                        # body would corrupt a keep-alive connection, so
                        # close it after responding.
                        self.close_connection = True
                        self._send(413, {
                            "error": f"body {n} bytes exceeds the "
                                     f"{MAX_BODY_BYTES} byte limit"})
                        return
                    raw = self.rfile.read(n)
                    if self.path == "/v1/super_resolve_bin":
                        blob, style_n = server.handle_super_resolve_bin(
                            self.headers, raw)
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        self.send_header("Content-Length", str(len(blob)))
                        self.send_header("X-DS-Style-Bytes", str(style_n))
                        self.end_headers()
                        self.wfile.write(blob)
                        return
                    body = json.loads(raw)
                    self._send(200, server.handle_super_resolve(body))
                except BadRequest as e:
                    self._send(400, {"error": str(e)})
                except json.JSONDecodeError as e:
                    self._send(400, {"error": f"bad JSON: {e}"})
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(
        description="Serve exported DeepSEE artifacts over HTTP")
    p.add_argument("--artifact", required=True, action="append",
                   help="artifact directory from `python -m deepsee_torch.serve`; "
                        "repeatable, optionally 'alias=dir' (e.g. "
                        "--artifact indep=dir1 --artifact guided=dir2); the "
                        "first is the default model")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda",
                   help="device the programs run on; the artifacts must have "
                        "been exported for it")
    p.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="how long to wait coalescing concurrent requests "
                        "into the artifact's trace batch")
    p.add_argument("--request_timeout_s", type=float, default=600.0,
                   help="per-request wait bound; must cover the first served "
                        "batch, which builds the CUDA kernels")
    p.add_argument("--png_level", type=int, default=6,
                   help="zlib level for response PNGs (0-9)")
    args = p.parse_args(argv)

    srv = ServingServer(args.artifact, port=args.port, host=args.host,
                        batch_window_ms=args.batch_window_ms,
                        request_timeout_s=args.request_timeout_s,
                        device=args.device, png_level=args.png_level)
    for alias in srv.manifests:
        m = srv._model_manifest(alias)
        tag = " (default)" if alias == srv.default_model else ""
        print(f"serving {alias}{tag}: {m['name']} (batch {m['batch_size']}, "
              f"{'guided' if m['guiding_style_image'] else 'independent'}) "
              f"on http://{args.host}:{srv.port}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
