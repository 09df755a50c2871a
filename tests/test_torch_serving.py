"""PyTorch port, HTTP inference service: request round trips on the CPU
(the port's counterpart of tests/test_serving.py), and a check that the
port's serving path never imports JAX."""

import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu_torch.engine import serving  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService, make_server  # noqa: E402

CMAP = {0: (255, 0, 0, 127), 1: (0, 255, 0, 127), 2: (0, 0, 255, 127)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model():
    return FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32,
                 device="cpu")


@pytest.fixture(scope="module")
def server():
    model = _model()
    service = InferenceService(model, color_map=CMAP)
    srv = make_server(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    yield f"http://{host}:{port}", service
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    model.close()


def _png_bytes(rng, h=32, w=64):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_predict_endpoint(server, rng):
    base, _ = server
    status, png = _post(base + "/predict", _png_bytes(rng))
    assert status == 200
    ids = np.asarray(Image.open(io.BytesIO(png)))
    assert ids.shape == (32, 64) and ids.dtype == np.uint8
    assert ids.max() < 3


def test_overlay_endpoint_and_odd_size(server, rng):
    base, _ = server
    status, png = _post(base + "/overlay", _png_bytes(rng, h=30, w=50))
    assert status == 200
    assert np.asarray(Image.open(io.BytesIO(png))).shape == (30, 50, 3)


def test_health_and_stats(server, rng):
    base, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok"
    assert health["model_config"]["num_classes"] == 3
    _post(base + "/predict", _png_bytes(rng))
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["p50_ms"] is not None


def test_bad_request_is_400_and_server_survives(server, rng):
    base, service = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/predict", b"this is not an image")
    assert err.value.code == 400 and "error" in json.loads(err.value.read())
    status, _ = _post(base + "/predict", _png_bytes(rng))
    assert status == 200 and service.errors >= 1


def test_unknown_route_is_404(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert err.value.code == 404


def test_server_fault_is_500(rng):
    """/overlay on a service built without a color map is the server's
    fault: 500, not 400."""
    model = _model()
    srv = make_server(InferenceService(model, color_map=None), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"http://{host}:{port}/overlay", _png_bytes(rng))
        assert err.value.code == 500
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def test_microbatching_coalesces_and_matches_unbatched(rng):
    """8 concurrent same-shape requests under a 200 ms window resolve in
    fewer dispatches than requests, each equal to the unbatched answer."""
    model = _model()
    service = InferenceService(model, color_map=CMAP, batch_window_ms=200, max_batch=8)
    try:
        bodies = [_png_bytes(rng) for _ in range(8)]
        results = [None] * 8

        def worker(i):
            results[i] = service.predict_png(bodies[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = service.stats()
        assert stats["requests"] == 8 and stats["dispatches"] < 8, stats
        reference = InferenceService(model, color_map=CMAP)
        for body, out in zip(bodies, results):
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(out))),
                                          np.asarray(Image.open(io.BytesIO(
                                              reference.predict_png(body)))))
    finally:
        service.close()


def test_microbatching_pads_every_group_to_one_capture(rng):
    """Groups of 1 to 8 same-shape requests each pad to ``max_batch`` with
    copies of their last image: one predict step and one capture serve them
    all (the compiled step's cache counts captures on the CPU too), and
    every answer equals the unpadded batch's."""
    model = _model()
    service = InferenceService(model, color_map=CMAP, batch_window_ms=100, max_batch=8)
    try:
        images = [rng.integers(0, 256, (32, 64, 3), dtype=np.uint8) for _ in range(8)]
        answers = []
        for k in range(1, 9):
            futures = [service._batcher.submit(im, False) for im in images[:k]]
            answers.append([f.result(timeout=120) for f in futures])
        assert model.capture_counts()["predict"] == 1
        assert [key[0] for key in model._predict_steps.keys()] == [(8, 32, 64, 3)]
        assert service.stats()["dispatches"] >= 8
    finally:
        service.close()
    for k, got in enumerate(answers, start=1):
        np.testing.assert_array_equal(np.stack(got), model.predict(np.stack(images[:k])))


def test_microbatching_submit_after_close_fails_fast(rng):
    service = InferenceService(_model(), color_map=CMAP, batch_window_ms=50)
    service.close()
    with pytest.raises(RuntimeError, match="closed"):
        service.predict_png(_png_bytes(rng))


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """A narrow trained model's checkpoint directory."""
    model = _model()
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 3, (2, 32, 32), dtype=np.uint8))
    model.train(iter([batch]), 1, 1, lambda s: 1e-3, record_summaries=False, prefetch=0)
    return model.save(str(tmp_path_factory.mktemp("ckpt"))), model


def test_checkpoint_cli_waits_for_the_checkpoint_port(checkpoint_dir, rng):
    """The checkpoint CLI (which waited for the checkpoint port until it
    landed) serves a checkpoint directory: on ``--device cpu`` it builds the
    model from the checkpoint, answers /healthz with its config and
    /predict with the trained model's ids."""
    path, model = checkpoint_dir
    server = serving.main([path, "0", "--device", "cpu", "--batch-window-ms", "5"], serve=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["model_config"] == model.model_config
        body = _png_bytes(rng)
        status, png = _post(base + "/predict", body)
        assert status == 200
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(png))),
            model.predict(np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))[None])[0])
    finally:
        server.shutdown()
        server.server_close()
        server.service.close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert serving.main([]) == 1 and serving.main([path, "--device"]) == 1  # usage errors


def test_checkpoint_cli_without_cuda_raises(checkpoint_dir, monkeypatch):
    """The default device is the card: without one the CLI raises and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serving.main([checkpoint_dir[0], "0"], serve=False)


def test_port_labels_equal_the_jax_packages():
    from fcn8s_tensorflow_tpu.labels import cityscapes

    from fcn8s_tensorflow_tpu_torch import labels

    assert labels.TRAINIDS_TO_RGBA_DICT == cityscapes.TRAINIDS_TO_RGBA_DICT
    assert labels.NUM_TRAIN_CLASSES == cityscapes.NUM_TRAIN_CLASSES


def test_serving_path_imports_no_jax():
    """In a fresh interpreter, the port's serving module, its labels and one
    overlay predict leave ``jax`` and the JAX package out of ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
        from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService
        from fcn8s_tensorflow_tpu_torch.labels import TRAINIDS_TO_RGBA_DICT
        torch.set_num_threads(1)
        model = FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32,
                      compute_dtype=torch.float32, device="cpu")
        service = InferenceService(model, color_map=TRAINIDS_TO_RGBA_DICT)
        ids = service._predict_batch(np.zeros((1, 32, 32, 3), np.uint8), overlay=False)
        assert ids.shape == (1, 32, 32), ids.shape
        rgb = service._predict_batch(np.zeros((1, 32, 32, 3), np.uint8), overlay=True)
        assert rgb.shape == (1, 32, 32, 3), rgb.shape
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        ref = [m for m in sys.modules
               if m == "fcn8s_tensorflow_tpu" or m.startswith("fcn8s_tensorflow_tpu.")]
        assert not ref, ref
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
