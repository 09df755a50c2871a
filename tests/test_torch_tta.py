"""PyTorch port, test-time augmentation (``ops.nn.resize_bilinear``,
``parallel.steps.tta_step``, ``FCN8s.predict_tta``) against the JAX package
on the CPU, plus every case of tests/test_tta.py on the port's facade.

The narrow fp32 model and ``_tree`` weights of tests/test_torch_model.py.
Tolerances, with their reasons:

* the resize against ``jax.image.resize(method="bilinear")``, up and down
  at non-integer ratios: atol 1e-5 on values in [0, 1) (both are separable
  triangle filters, widened by the scale when downscaling, summed in
  another order);
* ``tta_step`` and ``predict_tta`` probabilities: rtol 1e-4, atol 1e-6
  (the fp32 logits' tolerance of tests/test_torch_model.py through the
  softmax, the mirror average and the resizes); ids by the
  ``_assert_ids_agree`` rule on JAX's probabilities;
* the port's own facade against itself (identity = predict, the flip
  average = its host composition, flip equivariance): atol 1e-5, as
  tests/test_tta.py holds JAX's.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu.ops.quantize import quantize_fcn8s_params as j_quantize  # noqa: E402
from fcn8s_tensorflow_tpu.parallel.steps import tta_step as j_tta  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.nn import resize_bilinear  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel.steps import tta_step as t_tta  # noqa: E402
from tests.test_torch_model import C, SMALL, _assert_ids_agree, _images, _run_params, _tree  # noqa: E402

F32 = dict(compute_dtype=jnp.float32)
TF32 = dict(compute_dtype=torch.float32)


def _assert_probs_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("size", [(48, 72), (32, 32), (50, 70), (80, 120), (96, 160)])
def test_resize_bilinear_matches_jax(rng, size):
    x = rng.random((2, 64, 96, 5), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 5), method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x), size)
    assert got.shape == want.shape and got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# 96x128 images: predict_tta's 0.75 and 1.25 snap to 64x96 and 128x160
TTA_CASES = {"flip": (None, True, False), "0.75": ((64, 96), True, False),
             "1.25": ((128, 160), True, False), "0.75_no_flip": ((64, 96), False, False),
             "quantized": ((128, 160), True, True)}


@pytest.mark.parametrize("case", list(TTA_CASES))
def test_tta_step_matches_jax(rng, case):
    scale_hw, flip, quantized = TTA_CASES[case]
    tree, images = _tree(), _images(rng, h=96, w=128)
    if quantized:  # JAX's int8 tree, through the bridge
        jparams = jax.tree.map(np.asarray, jax.jit(j_quantize)(tree, None))
        params = bridge.quantized_to_port(jparams, torch.float32)
    else:
        jparams, params = tree, _run_params(tree)
    want = np.asarray(jax.jit(partial(j_tta, scale_hw=scale_hw, flip=flip, quantized=quantized,
                                      **F32))(jparams, jnp.asarray(images)))
    with torch.inference_mode():
        got = t_tta(params, torch.from_numpy(images), scale_hw=scale_hw, flip=flip,
                    quantized=quantized, **TF32).numpy()
    assert got.shape == want.shape == (2, 96, 128, C) and got.dtype == np.float32
    _assert_probs_close(got, want)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_facade_predict_tta_matches_jax(rng):
    """Three scales with the flip, probabilities then ids, on 50x70 images
    (padded to 64x96 as predict pads), bf16-free and int8."""
    images = _images(rng, n=2, h=50, w=70)
    jm = JFCN8s(num_classes=C, **F32, **SMALL)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree()))
    model = FCN8s.from_params(_tree(), device="cpu", **TF32, **SMALL)
    for quantized in (False, True):
        kw = dict(scales=(0.75, 1.0, 1.25), flip=True, quantized=quantized)
        want = jm.predict_tta(images, argmax=False, **kw)
        got = model.predict_tta(images, argmax=False, **kw)
        assert got.shape == (2, 50, 70, C) and got.dtype == np.float32
        _assert_probs_close(got, want)
        ids = model.predict_tta(images, **kw)
        assert ids.dtype == np.int32 and ids.shape == (2, 50, 70)
        _assert_ids_agree(ids, jm.predict_tta(images, **kw), want)
    jm.close()


def test_predict_tta_validation(rng):
    model = FCN8s.from_params(_tree(), device="cpu", **TF32, **SMALL)
    images = _images(rng, n=1)
    with pytest.raises(ValueError, match="scales must be non-empty"):
        model.predict_tta(images, scales=())
    with pytest.raises(ValueError, match="mutually exclusive"):
        model.predict_tta(images, quantized=True, use_ema=True)
    with pytest.raises(ValueError, match="No EMA params"):
        model.predict_tta(images, use_ema=True)


# ---------------------------------------------------------------------------
# tests/test_tta.py's cases, on the port's facade
# ---------------------------------------------------------------------------

NUM_CLASSES = 3
HW = (32, 64)


@pytest.fixture(scope="module")
def model():
    return FCN8s(num_classes=NUM_CLASSES, width_mult=1 / 32, fc_channels=32, device="cpu", **TF32)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    return rng.integers(0, 255, size=(2, *HW, 3), dtype=np.uint8)


def test_tta_identity_matches_predict(model, images):
    """scales=(1.0,), flip=False degenerates to plain softmax predict."""
    ref = model.predict(images, argmax=False)
    tta = model.predict_tta(images, scales=(1.0,), flip=False, argmax=False)
    np.testing.assert_allclose(tta, ref, atol=1e-5)


def test_tta_flip_average_matches_host_composition(model, images):
    """flip=True equals the average of the forward view and the
    un-mirrored prediction of the mirrored view."""
    fwd = model.predict(images, argmax=False)
    mir = model.predict(images[:, :, ::-1, :], argmax=False)[:, :, ::-1, :]
    tta = model.predict_tta(images, scales=(1.0,), flip=True, argmax=False)
    np.testing.assert_allclose(tta, (fwd + mir) * 0.5, atol=1e-5)


def test_tta_flip_equivariance(model, images):
    """TTA(mirror(x)) == mirror(TTA(x))."""
    a = model.predict_tta(images[:, :, ::-1, :], scales=(1.0,), flip=True, argmax=False)
    b = model.predict_tta(images, scales=(1.0,), flip=True, argmax=False)[:, :, ::-1, :]
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_tta_multiscale_valid_distribution(model, images):
    """Bilinear resizes are convex combinations: the average stays a
    distribution without a renormalization pass."""
    probs = model.predict_tta(images, scales=(0.5, 1.0, 1.5), flip=True, argmax=False)
    assert probs.shape == (2, *HW, NUM_CLASSES) and probs.dtype == np.float32
    np.testing.assert_allclose(probs.sum(axis=-1), 1.0, atol=1e-5)
    assert probs.min() >= 0.0


def test_tta_argmax_ids_and_odd_shapes(model):
    """Inputs off the stride-32 grid pad and crop as in predict; ids are
    int32 and in range."""
    odd = np.random.default_rng(3).integers(0, 255, size=(1, 33, 65, 3), dtype=np.uint8)
    ids = model.predict_tta(odd, scales=(0.75, 1.0), flip=True, argmax=True)
    assert ids.shape == (1, 33, 65) and ids.dtype == np.int32
    assert ids.min() >= 0 and ids.max() < NUM_CLASSES


def test_tta_quantized_smoke(model, images):
    ids = model.predict_tta(images, scales=(1.0,), flip=True, argmax=True, quantized=True)
    assert ids.shape == (2, *HW)
    assert ids.min() >= 0 and ids.max() < NUM_CLASSES
