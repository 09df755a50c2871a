"""PyTorch port, tiled and blended inference (``FCN8s.predict(tile=...,
tile_overlap=..., tile_blend=...)``, ``_tile_grid``, ``_feather_profile``)
and the HTTP service's ``quantized``/``tile`` options, against the JAX
package on the CPU, plus tests/test_engine.py's tiling cases on the port.

The narrow fp32 model and ``_tree`` weights of tests/test_torch_model.py;
the JAX facade on a one-device mesh, so that it dispatches tiles in chunks
of 8 as the port does (dynamic int8 scales are per dispatch, so the chunk
is part of the result).
Tolerances, with their reasons:

* ``_tile_grid`` and ``_feather_profile``: equal (the same integer and
  fp32 arithmetic);
* tiled probabilities, hard paste and blend, bf16-free and int8: rtol 1e-4,
  atol 1e-6 (each tile is ``predict``'s softmax, within
  tests/test_torch_model.py's fp32 tolerance; the blend is the same fp32
  host accumulation); ids by its ``_assert_ids_agree`` rule on JAX's
  probabilities;
* the hard paste against per-tile ``predict`` calls pasted by the grid's
  cores: exact; the blend where one tile covers a pixel: within 2 fp32
  ulps of that tile's own (``p * w / w``);
* the service against the facade call it makes: exact.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.schedules import constant  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService  # noqa: E402
from tests.test_torch_model import C, SMALL, _assert_ids_agree, _images, _tree  # noqa: E402

TF32 = dict(compute_dtype=torch.float32)
CMAP = {0: (255, 0, 0, 127), 1: (0, 255, 0, 127), 2: (0, 0, 255, 127)}


@pytest.mark.parametrize("size,t,overlap", [
    (128, 64, 32), (96, 64, 32), (64, 64, 32), (50, 64, 0), (300, 96, 48), (130, 64, 2),
    (1024, 512, 128), (2048, 512, 128), (544, 512, 128), (96, 32, 0), (640, 256, 224)])
def test_tile_grid_equals_jax_and_partitions(size, t, overlap):
    grid = FCN8s._tile_grid(size, t, overlap)
    assert grid == JFCN8s._tile_grid(size, t, overlap)
    covered = []
    for s, lo, hi in grid:
        covered.extend(range(s + lo, s + hi))
        assert 0 <= lo <= hi <= t
        assert s + t <= size or t >= size
    assert covered == list(range(size))


@pytest.mark.parametrize("t,margin", [(64, 16.0), (512, 64.0), (32, 1.0), (96, 48.0), (64, 0.5)])
def test_feather_profile_equals_jax(t, margin):
    got = FCN8s._feather_profile(t, margin)
    assert got.dtype == np.float32 and got.min() > 0
    np.testing.assert_array_equal(got, JFCN8s._feather_profile(t, margin))


def _pair():
    jm = JFCN8s(num_classes=C, compute_dtype=jnp.float32, mesh=create_mesh(data=1, model=1),
                **SMALL)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree()))
    return jm, FCN8s.from_params(_tree(), device="cpu", **TF32, **SMALL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("blend", [False, True])
def test_tiled_predict_matches_jax(rng, blend, quantized):
    """2 x 100x150 images (padded to 128x160) in 64x64 tiles, overlap 32:
    12 tiles of each image, chunks of 8."""
    images = _images(rng, n=2, h=100, w=150)
    jm, model = _pair()
    kw = dict(tile=(64, 64), tile_overlap=32, tile_blend=blend, quantized=quantized)
    want = jm.predict(images, argmax=False, **kw)
    got = model.predict(images, argmax=False, **kw)
    assert got.shape == (2, 100, 150, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    ids = model.predict(images, **kw)
    assert ids.shape == (2, 100, 150) and ids.dtype == np.int32
    _assert_ids_agree(ids, jm.predict(images, **kw), want)
    jm.close()


def test_tiled_overlay_and_hard_paste_equal_the_host_composition(rng):
    """The hard paste equals ``predict`` of each tile pasted by the grid's
    cores, ids and on-device overlays alike; the default overlap clamps to
    ``min(th, tw) - 32``."""
    images = _images(rng, n=2, h=96, w=160)
    _, model = _pair()
    rows, cols = model._tile_grid(96, 64, 32), model._tile_grid(160, 64, 32)
    for overlay in (None, CMAP):
        want = np.zeros((2, 96, 160) + ((3,) if overlay else ()), np.int32 if not overlay
                        else np.uint8)
        for ys, ylo, yhi in rows:
            for xs, xlo, xhi in cols:
                part = model.predict(images[:, ys:ys + 64, xs:xs + 64], overlay=overlay)
                want[:, ys + ylo:ys + yhi, xs + xlo:xs + xhi] = part[:, ylo:yhi, xlo:xhi]
        got = model.predict(images, tile=(64, 64), overlay=overlay)  # 128 clamps to 32
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,kwargs,match", [
    ("dims", dict(tile=(60, 64)), "multiples of 32"),
    ("odd_overlap", dict(tile=(64, 64), tile_overlap=31), "tile_overlap"),
    ("negative_overlap", dict(tile=(64, 64), tile_overlap=-2), "tile_overlap"),
    ("blend_without_tile", dict(tile_blend=True), "tile_blend requires"),
    ("blend_overlay", dict(tile=(64, 64), tile_blend=True, overlay=CMAP), "composites probabilities"),
    ("spatial", dict(tile=(64, 64), spatial_partition=True), "mutually exclusive"),
    ("ema_int8", dict(tile=(64, 64), quantized=True, use_ema=True), "mutually exclusive"),
])
def test_tiled_predict_validation(rng, case, kwargs, match):
    _, model = _pair()
    with pytest.raises(ValueError, match=match):
        model.predict(_images(rng, n=1), **kwargs)


def _repeat(images, labels):
    while True:
        yield images, labels


def test_predict_tiled_matches_full_on_local_task():
    """tests/test_engine.py's case: a model trained on a locally decided
    task (class = brightness band) predicts the same away from tile seams;
    the blend agrees with the full run about as well as the hard paste,
    and equals it (to 2 ulps) where one tile covers the whole image."""
    rng = np.random.default_rng(1)
    images = rng.integers(0, 255, (2, 64, 128, 3), np.uint8)
    labels = (images.mean(-1) // 86).astype(np.uint8)
    model = FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32, device="cpu", **TF32)
    model.train(_repeat(images, labels), epochs=1, steps_per_epoch=25,
                learning_rate_schedule=constant(2e-3), keep_prob=1.0, eval_frequency=10,
                record_summaries=False, prefetch=0)
    full = model.predict(images)
    tiled = model.predict(images, tile=(64, 64), tile_overlap=32)
    assert tiled.shape == full.shape
    assert (tiled == full).mean() > 0.9, (tiled == full).mean()
    probs = model.predict(images, tile=(64, 64), tile_overlap=32, argmax=False)
    assert probs.shape == full.shape + (3,)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)
    small = model.predict(images[:, :32, :48], tile=(64, 64))
    assert small.shape == (2, 32, 48)

    blended = model.predict(images, tile=(64, 64), tile_overlap=32, tile_blend=True)
    assert blended.shape == full.shape
    assert (blended == full).mean() >= (tiled == full).mean() - 0.02
    bprobs = model.predict(images, tile=(64, 64), tile_overlap=32, tile_blend=True,
                           argmax=False)
    np.testing.assert_allclose(bprobs.sum(-1), 1.0, atol=1e-3)
    hard1 = model.predict(images[:, :32, :48], tile=(64, 64), argmax=False)
    soft1 = model.predict(images[:, :32, :48], tile=(64, 64), tile_blend=True, argmax=False)
    np.testing.assert_allclose(soft1, hard1, rtol=2 ** -22, atol=0)


def _png(array) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG")
    return buf.getvalue()


def test_service_quantized_tiled_serving_and_health(rng):
    """``InferenceService(quantized=True, tile=(64, 64), tile_overlap=32)``
    passes the options to every predict, unbatched and micro-batched, and
    reports them in ``health()``; the default service reports neither."""
    _, model = _pair()
    plain = InferenceService(model, color_map=CMAP)
    assert plain.health()["quantized"] is False and plain.health()["tile"] is None
    image = _images(rng, n=1, h=100, w=150)[0]
    kw = dict(quantized=True, tile=(64, 64), tile_overlap=32)
    want_ids = model.predict(image[None], **kw)[0]
    want_ov = model.predict(image[None], overlay=CMAP, **kw)[0]
    for window in (0.0, 20.0):
        service = InferenceService(model, color_map=CMAP, batch_window_ms=window, **kw)
        try:
            ids = np.asarray(Image.open(io.BytesIO(service.predict_png(_png(image)))))
            ov = np.asarray(Image.open(io.BytesIO(service.predict_png(_png(image), overlay=True))))
            health = service.health()
        finally:
            service.close()
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(ov, want_ov)
        assert health["quantized"] is True and health["tile"] == [64, 64]
        assert health["model_config"]["num_classes"] == C
