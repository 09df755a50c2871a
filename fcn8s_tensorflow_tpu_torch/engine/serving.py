"""HTTP inference service for the PyTorch port: a serving endpoint around
``FCN8s.predict``.

Port of ``fcn8s_tensorflow_tpu/engine/serving.py``, nearly line for line:
the service is plain Python around ``model.predict`` (stdlib
``ThreadingHTTPServer``, PIL for PNG/JPEG bodies):

* ``POST /predict``  — request body: encoded image (PNG/JPEG, any H×W)
  → response: grayscale PNG of argmax class ids (uint8).
* ``POST /overlay``  — same request → RGB PNG with the class colors
  alpha-composited on the input, on the device.
* ``GET  /healthz``  — JSON liveness + model config.
* ``GET  /stats``    — JSON request counters and latency percentiles.

Predictions run under a lock (one device user at a time); decode/encode run
concurrently on the request threads. The service's ``quantized``, ``tile``
and ``tile_overlap`` go to every ``predict`` (int8 serving, tiled inference
of large frames) and ``/healthz`` reports the first two.

**Micro-batching** (``batch_window_ms > 0``): concurrent requests queue to
a dispatcher thread that waits up to the window for more work, groups
same-shaped images, and runs ONE device batch per group (at most
``max_batch`` images), at the cost of up to one window of added latency on
sparse traffic.

Entry: ``FCN8s(...)`` -> ``InferenceService(model, ...)`` ->
``make_server(service, port=...)`` -> ``serve_forever()``; or from the
command line, a checkpoint directory of either package:

    python -m fcn8s_tensorflow_tpu_torch.engine.serving <checkpoint_dir> [port] \
        [--batch-window-ms N] [--device cuda]
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
from PIL import Image


class ClientError(ValueError):
    """Bad request payload (undecodable image) — maps to HTTP 400; every
    other failure is the server's fault and maps to 500."""


class _MicroBatcher:
    """Server-side request batching (see module docstring): a single
    dispatcher thread drains the request queue, waits up to ``window`` s
    for more work (up to ``max_batch`` requests), groups by (image shape,
    overlay?), runs one device dispatch per group, and resolves the
    requests' futures. Unlike the JAX service it does not pad a group to
    ``max_batch``: eager PyTorch compiles nothing per batch size, so padding
    would only spend device time on copies of the last image."""

    #: bound on a request's wait for its batch result — the dispatcher
    #: normally answers within one window + one device dispatch; if it
    #: ever wedges, requests fail (500) instead of hanging forever
    RESULT_TIMEOUT_S = 600.0

    def __init__(self, service: "InferenceService", window: float,
                 max_batch: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.service = service
        self.window = window
        self.max_batch = max_batch
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, overlay: bool) -> Future:
        if self._closed:
            raise RuntimeError("inference service is closed")
        fut: Future = Future()
        self._q.put((image, overlay, fut))
        return fut

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join()
        # fail anything that raced past the closed flag instead of
        # leaving its requester blocked on a never-resolved future
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[2].set_exception(
                    RuntimeError("inference service is closed"))

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.perf_counter() + self.window
            while len(batch) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch):
        # the WHOLE body is guarded per group: any failure (stack/pad
        # memory errors included, not just the device call) must fail
        # that group's futures, never the dispatcher thread — a dead
        # dispatcher would wedge every subsequent batched request
        groups: dict = {}
        for image, overlay, fut in batch:
            groups.setdefault((image.shape, overlay), []).append((image, fut))
        for (shape, overlay), group in groups.items():
            try:
                images = np.stack([im for im, _ in group])
                outs = self.service._predict_batch(images, overlay)
            except Exception as exc:  # noqa: BLE001 — fail the requests, not the thread
                for _, fut in group:
                    fut.set_exception(exc)
                continue
            for (_, fut), out in zip(group, outs):
                fut.set_result(out)


class InferenceService:
    """Wraps an ``FCN8s`` model with the request-level logic (decode,
    predict, encode, stats) — separable from the HTTP layer for tests.

    It needs one controller: a request reaches one process, while a mesh
    of the port runs one process per position that must all make each
    call. So a model on a mesh of more than one position raises; serve a
    single-rank model (the (1, 1) mesh, ``FCN8s(model_load_dir=ckpt)`` in
    one process)."""

    def __init__(self, model, color_map=None, *, quantized: bool = False,
                 tile=None, tile_overlap: int = 128,
                 batch_window_ms: float = 0.0, max_batch: int = 8):
        mesh = getattr(model, "mesh", None)
        if mesh is not None and mesh.size > 1:
            raise ValueError(
                f"InferenceService needs one controller, and this model runs on a "
                f"{mesh.shape['data']}x{mesh.shape['model']} mesh of processes: serve a "
                "single-rank model (FCN8s(model_load_dir=...) in one process)")
        self.model = model
        self.color_map = color_map
        self.quantized = quantized
        self.tile = tile
        self.tile_overlap = tile_overlap
        self._lock = threading.Lock()
        # counters/latencies get their own lock: `_lock` is held for whole
        # device predicts, and /stats must not block behind one
        self._stats_lock = threading.Lock()
        self._latencies: deque[float] = deque(maxlen=1000)  # bounded memory
        self.requests = 0
        self.errors = 0
        self.dispatches = 0  # device batches actually run
        self._batcher = (_MicroBatcher(self, batch_window_ms / 1e3, max_batch)
                         if batch_window_ms > 0 else None)

    def close(self):
        """Stop the micro-batcher thread (no-op without batching)."""
        if self._batcher is not None:
            self._batcher.close()

    def _predict_batch(self, images, overlay: bool):
        """One device dispatch for a stacked (N,H,W,3) batch; returns the
        per-image outputs (RGB overlays or id maps). Caller holds no lock —
        this takes the device lock itself."""
        if overlay and self.color_map is None:
            raise ValueError("server built without a color_map")
        with self._lock:
            out = self.model.predict(
                images, overlay=self.color_map if overlay else None,
                quantized=self.quantized, tile=self.tile,
                tile_overlap=self.tile_overlap,
            )
        with self._stats_lock:
            self.dispatches += 1
        return out

    def _encode_png(self, out, overlay: bool) -> bytes:
        if overlay:
            mode_img = Image.fromarray(out.astype(np.uint8))  # (H, W, 3): RGB
        elif self.model.num_classes > 256:
            # uint8 would silently alias ids >= 256; a 16-bit grayscale
            # PNG ('I;16') keeps them exact
            mode_img = Image.fromarray(out.astype(np.uint16))
        else:
            mode_img = Image.fromarray(out.astype(np.uint8))  # (H, W): L
        buf = io.BytesIO()
        mode_img.save(buf, format="PNG")
        return buf.getvalue()

    def predict_png(self, image_bytes: bytes, overlay: bool = False) -> bytes:
        try:
            image = np.asarray(Image.open(io.BytesIO(image_bytes)).convert("RGB"))
        except Exception as exc:
            raise ClientError(f"undecodable image: {exc}") from exc
        t0 = time.perf_counter()
        if self._batcher is not None:
            out = self._batcher.submit(image, overlay).result(
                timeout=_MicroBatcher.RESULT_TIMEOUT_S)
        else:
            out = self._predict_batch(image[None], overlay)[0]
        with self._stats_lock:
            self._latencies.append(time.perf_counter() - t0)
            self.requests += 1
        return self._encode_png(out, overlay)

    def stats(self) -> dict:
        # snapshot under the lock: request threads append concurrently and
        # iterating a mutating deque raises (ADVICE r2)
        with self._stats_lock:
            lat = np.asarray(list(self._latencies)) * 1e3
            requests, errors = self.requests, self.errors
            dispatches = self.dispatches
        return {
            "requests": requests,
            "errors": errors,
            "dispatches": dispatches,
            "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
            "p95_ms": float(np.percentile(lat, 95)) if lat.size else None,
        }

    def health(self) -> dict:
        return {
            "status": "ok",
            "model_config": self.model.model_config,
            "quantized": self.quantized,
            "tile": list(self.tile) if self.tile else None,
        }


def make_server(service: InferenceService, host: str = "127.0.0.1",
                port: int = 8009):
    """Build (not start) a ``ThreadingHTTPServer`` for the service."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats() is the observability
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(service.health())
            elif self.path == "/stats":
                self._send_json(service.stats())
            else:
                self._send_json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path not in ("/predict", "/overlay"):
                self._send_json({"error": "not found"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                png = service.predict_png(body, overlay=self.path == "/overlay")
                self._send(200, png, "image/png")
            except Exception as exc:  # noqa: BLE001 — a server must not die
                with service._stats_lock:
                    service.errors += 1
                # client payload faults -> 400; anything else (device
                # failure, server misconfiguration) is OUR fault -> 500 so
                # monitors flag the backend instead of blaming callers
                code = 400 if isinstance(exc, ClientError) else 500
                self._send_json({"error": str(exc)}, code)

    return http.server.ThreadingHTTPServer((host, port), Handler)


def _take_option(argv: list, flag: str, convert):
    """Remove ``flag value`` from ``argv``; returns the converted value or
    None when the flag is absent. Raises ``ValueError`` on a missing or bad
    value."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise ValueError(f"{flag} requires a value")
    value = convert(argv[i + 1])
    del argv[i:i + 2]
    return value


def main(argv=None, *, serve: bool = True):
    """``python -m fcn8s_tensorflow_tpu_torch.engine.serving <checkpoint_dir>
    [port] [--batch-window-ms N] [--device cuda|cpu|cuda:K]``: serve a
    checkpoint directory (of either package) on 127.0.0.1 (port 8009 by
    default, 0 picks a free one). The model runs on ``--device``, by
    default ``cuda``; without a card that raises, and the CPU serves only
    when asked for with ``--device cpu``. With ``serve=False`` the built
    server is returned unstarted (the caller runs ``serve_forever`` and
    closes it)."""
    import sys

    import torch

    argv = list(argv) if argv is not None else sys.argv[1:]
    try:
        window_ms = _take_option(argv, "--batch-window-ms", float) or 0.0
        device = torch.device(_take_option(argv, "--device", str) or "cuda")
    except (ValueError, RuntimeError) as exc:
        print(__doc__)
        print(f"error: {exc}")
        return 1
    if not argv:
        print(__doc__)
        return 1
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for --device cuda: pass --device cpu to serve on "
                           "the CPU")
    checkpoint_dir = argv[0]
    port = int(argv[1]) if len(argv) > 1 else 8009

    from ..labels import TRAINIDS_TO_RGBA_DICT
    from .model import FCN8s

    model = FCN8s(model_load_dir=checkpoint_dir, device=device)
    service = InferenceService(model, color_map=TRAINIDS_TO_RGBA_DICT,
                               batch_window_ms=window_ms)
    server = make_server(service, port=port)
    server.service = service  # the caller of serve=False closes it
    print(f"serving {checkpoint_dir} on {device} at "
          f"http://127.0.0.1:{server.server_address[1]} "
          f"(POST /predict, /overlay; GET /healthz, /stats)")
    if not serve:
        return server
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
