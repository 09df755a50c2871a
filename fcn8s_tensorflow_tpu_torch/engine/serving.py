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
same-shaped images, and runs ONE device batch per group, padded to
``max_batch`` (unless tiled), at the cost of up to one window of added
latency on sparse traffic.

**A mesh of processes** (a model whose ``mesh`` has more than one
position: JAX's facade serves data-parallel over every device, and
``FCN8s(model_load_dir=ckpt)`` under ``torchrun`` builds that mesh): every
rank builds the same ``InferenceService``. Rank 0, the mesh's position
(0, 0), takes the requests: it serves HTTP, runs the micro-batcher, and
before each ``predict`` broadcasts a command (the batch's N, H, W and the
overlay flag, then the uint8 batch) while it holds the device lock, so
every rank sees the calls in one order. Every other rank runs
``InferenceService.follow()``: it makes the same ``predict`` call on the
same images and returns at rank 0's ``close()``. Whatever can fail on the
request alone (an undecodable body, overlay without a color map, a tile
that ``predict`` refuses) fails on rank 0 before any command. ``predict``
returns the whole batch on every rank (its step gathers the rows over the
mesh), so rank 0 answers every request.

Entry: ``FCN8s(...)`` -> ``InferenceService(model, ...)`` ->
``make_server(service, port=...)`` -> ``serve_forever()``; or from the
command line, a checkpoint directory of either package:

    python -m fcn8s_tensorflow_tpu_torch.engine.serving <checkpoint_dir> [port] \
        [--batch-window-ms N] [--device cuda]

and on N cards of one host, one process each (rank 0 binds the port):

    torchrun --nproc-per-node=N -m fcn8s_tensorflow_tpu_torch.engine.serving \
        <checkpoint_dir> [port] [--batch-window-ms N]
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch
from PIL import Image

from ..parallel import collectives
from .model import check_tile

# the controller's commands to the followers (``InferenceService._command``)
_STOP, _PREDICT, _IDLE = 0, 1, 2


class ClientError(ValueError):
    """Bad request payload (undecodable image) — maps to HTTP 400; every
    other failure is the server's fault and maps to 500."""


class _MicroBatcher:
    """Server-side request batching (see module docstring): a single
    dispatcher thread drains the request queue, waits up to ``window`` s
    for more work, groups by (image shape, overlay?), pads each group to
    ``max_batch`` with copies of its last image, runs one device dispatch
    per group, and resolves the requests' futures. The padding is the JAX
    service's, for the same reason: the facade's predict step is a CUDA
    graph captured per batch shape and kept in a bounded cache, so group
    sizes 1 to ``max_batch`` (times ids and overlay) would each capture a
    step of their own, with its warm-up and its private pool, and cycle
    the cache; padded, every group of one image shape replays one capture.
    The copies change no answer (the dynamic int8 scales' batch maxima
    included). A tiled service's groups are not padded: a tiled predict
    already dispatches whole chunks of 8 tiles, one capture whatever the
    group size, and copies would multiply its tiles and regroup them, and
    with them which tiles share a dynamic int8 scale."""

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
                n = images.shape[0]
                if n < self.max_batch and self.service.tile is None:
                    # pad with the last image: every request count replays
                    # the ONE max_batch-shaped capture
                    pad = np.repeat(images[-1:], self.max_batch - n, axis=0)
                    images = np.concatenate([images, pad], axis=0)
                outs = self.service._predict_batch(images, overlay)
            except Exception as exc:  # noqa: BLE001 — fail the requests, not the thread
                for _, fut in group:
                    fut.set_exception(exc)
                continue
            for (_, fut), out in zip(group, outs[:n]):
                fut.set_result(out)


class InferenceService:
    """Wraps an ``FCN8s`` model with the request-level logic (decode,
    predict, encode, stats) — separable from the HTTP layer for tests.

    On a mesh of processes (see the module docstring) every rank builds it
    with the same arguments; rank 0 (``is_controller``) serves, and every
    other rank calls ``follow()``. Rank 0 sends an idle command after
    ``HEARTBEAT_S`` s without one, so that the followers' wait for the next
    command outlasts an idle spell (the process group's timeout must exceed
    ``HEARTBEAT_S``); its ``close()`` stops the followers."""

    #: seconds of silence after which rank 0 sends the followers an idle command
    HEARTBEAT_S = 30.0

    def __init__(self, model, color_map=None, *, quantized: bool = False,
                 tile=None, tile_overlap: int = 128,
                 batch_window_ms: float = 0.0, max_batch: int = 8):
        if getattr(model, "variant", None) == "segformer":
            raise ValueError("SegFormer does not run the service (InferenceService); its "
                             "model runs train, evaluate and predict")
        mesh = getattr(model, "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.is_controller = self._mesh is None or self._mesh.rank == 0
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
        self.dispatches = 0  # device batches actually run (rank 0's)
        self._batcher = (_MicroBatcher(self, batch_window_ms / 1e3, max_batch)
                         if batch_window_ms > 0 and self.is_controller else None)
        self._stopped = False  # rank 0 sent the stop command
        self._last_command = time.monotonic()
        self._quiet = threading.Event()  # set by close(): the heartbeat ends
        self._heartbeat = None
        if self._mesh is not None and self.is_controller:
            self._heartbeat = threading.Thread(target=self._beat, daemon=True)
            self._heartbeat.start()

    def close(self):
        """Stop the micro-batcher thread (it answers what it holds first);
        on a mesh, rank 0 then sends the stop command, and every follower's
        ``follow()`` returns. A no-op on a follower and when called again."""
        if self._batcher is not None:
            self._batcher.close()
        if self._heartbeat is None:
            return
        self._quiet.set()
        with self._lock:
            if not self._stopped:
                self._stopped = True
                self._command(_STOP)
        self._heartbeat.join()

    def follow(self) -> None:
        """A rank other than rank 0 of a mesh of processes: make each
        ``predict`` call of rank 0's service, on the same images and in the
        same order, until rank 0's ``close()``. A failure raises (the rank
        should exit non-zero): rank 0's call then fails at its next
        collective, or at the group's timeout."""
        if self.is_controller:
            raise RuntimeError("rank 0 of the mesh takes the requests; follow() runs on the "
                               "other ranks")
        while True:
            op, images, overlay = self._receive()
            if op == _STOP:
                return
            if op == _PREDICT:
                self._predict(images, overlay)

    def _command(self, op: int, images=None, overlay: bool = False) -> None:
        """Rank 0, holding ``_lock``: broadcast one command to the
        followers; a predict command carries its uint8 batch."""
        n, h, w = images.shape[:3] if images is not None else (0, 0, 0)
        collectives.broadcast(torch.tensor([op, n, h, w, int(overlay)]), self._mesh)
        if images is not None:
            collectives.broadcast(torch.from_numpy(images), self._mesh)
        self._last_command = time.monotonic()

    def _receive(self):
        """A follower: the next command, as (op, images or None, overlay)."""
        op, n, h, w, overlay = collectives.broadcast(
            torch.zeros(5, dtype=torch.int64), self._mesh).tolist()
        if op != _PREDICT:
            return op, None, False
        images = collectives.broadcast(torch.empty((n, h, w, 3), dtype=torch.uint8), self._mesh)
        return op, images.cpu().numpy(), bool(overlay)

    def _beat(self):
        """Rank 0's heartbeat thread (see the class docstring)."""
        while not self._quiet.wait(self.HEARTBEAT_S / 4):
            with self._lock:
                if self._stopped:
                    return
                if time.monotonic() - self._last_command >= self.HEARTBEAT_S:
                    self._command(_IDLE)

    def _check_request(self, overlay: bool) -> None:
        """What fails on the request alone, raised before any device work
        (and on a mesh before any command)."""
        if overlay and self.color_map is None:
            raise ValueError("server built without a color_map")
        if self.tile is not None:
            check_tile(self.tile, self.tile_overlap)

    def _predict(self, images, overlay: bool):
        return self.model.predict(
            images, overlay=self.color_map if overlay else None,
            quantized=self.quantized, tile=self.tile,
            tile_overlap=self.tile_overlap,
        )

    def _predict_batch(self, images, overlay: bool):
        """One device dispatch for a stacked (N,H,W,3) batch; returns the
        per-image outputs (RGB overlays or id maps). Caller holds no lock —
        this takes the device lock itself (and on a mesh sends the
        followers the command under it)."""
        if not self.is_controller:
            raise RuntimeError(f"rank {self._mesh.rank} of the mesh follows rank 0 "
                               "(InferenceService.follow); rank 0 takes the requests")
        self._check_request(overlay)
        with self._lock:
            if self._stopped:
                raise RuntimeError("inference service is closed")
            if self._mesh is not None:
                images = np.require(images, np.uint8, ("C", "W"))  # what every rank predicts
                self._command(_PREDICT, images, overlay)
            out = self._predict(images, overlay)
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
    closes it and its ``service``).

    Under ``torchrun`` (``WORLD_SIZE`` > 1) it first joins the process
    group (NCCL on the card, gloo on the CPU; an initialised group is used
    as it is), and the model is on the mesh of every rank over 'data'
    (``FCN8s(model_load_dir=...)``'s default). Rank 0 serves as above;
    every other rank follows it (``InferenceService.follow``), prints
    nothing but errors, and returns 0 after rank 0's ``close()`` whatever
    ``serve``. A group this call joined it leaves at the end."""
    import sys

    import torch.distributed as dist

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

    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if joined:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        model = FCN8s(model_load_dir=checkpoint_dir, device=device)
        service = InferenceService(model, color_map=TRAINIDS_TO_RGBA_DICT,
                                   batch_window_ms=window_ms)
        if not service.is_controller:
            service.follow()
            model.close()
            return 0
        server = make_server(service, port=port)
        server.service = service  # the caller of serve=False closes it
        print(f"serving {checkpoint_dir} on {device} at "
              f"http://127.0.0.1:{server.server_address[1]} "
              f"(POST /predict, /overlay; GET /healthz, /stats)")
        if not serve:
            joined = False  # the caller's service still needs the group
            return server
        try:
            server.serve_forever()
        finally:
            server.server_close()
            service.close()
        return 0
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    sys.exit(main())
