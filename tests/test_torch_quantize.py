"""PyTorch port, int8 serving (``ops/quantize.py``, ``predict(quantized=True)``,
``calibrate_quantization``) against the JAX package on the CPU.

The narrow model of tests/test_torch_model.py (``width_mult=1/32,
fc_channels=32``, 64x64, fp32 compute, its ``_tree`` weights). Tolerances,
with their reasons:

* ``quantize_kernel_per_channel``: ``kernel_q`` and ``scale`` bit-equal
  (the same fp32 max, division and round-half-to-even), zero channels
  included;
* the int8 convolution's int32 accumulators (the fp64 twin and the
  ``_int_mm`` im2col route, which runs on the CPU too): equal to JAX's
  ``lax.conv_general_dilated(..., preferred_element_type=int32)``;
* ``conv2d_int8`` dequantized: within one ulp of ``compute_dtype``
  (XLA and ``torch.addcmul`` both compute ``acc * scale + bias`` as one
  FMA on the CPU; the ulp leaves room for a compiler that does not);
* ``collect_activation_absmax``: rtol 1e-5 (fp32 convolutions summed in
  another order);
* ``apply_fcn8s_int8`` on JAX's own quantized tree (through
  ``bridge.quantized_to_port``), dynamic and static: logits within
  tests/test_torch_model.py's fp32 tolerance (``atol = 1e-4 * max|logits|``,
  ``rtol = 1e-4``) and ids by its ``_assert_ids_agree`` rule. Measured on
  these inputs: 0 of the encoder's int8 activations differ from JAX's (0
  rounding flips, in fp32 and in bf16), so the encoders agree bit for bit
  and only the fp32 decoder's summation order is left (3e-7 of 1.85 at
  most); the port's own quantization of the same fp32 tree is bit-equal to
  JAX's;
* facade probabilities: rtol 1e-4, ``atol = 1e-4`` (softmax of the logits
  above); calibrated absmax rtol 1e-5;
* a tiny model trained by the port: int8 against the unquantized forward,
  argmax agreement >= 0.97, as tests/test_quantize.py holds JAX.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu.ops import quantize as JQ  # noqa: E402
from fcn8s_tensorflow_tpu.ops.nn import DIMENSION_NUMBERS  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.schedules import constant  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import quantize as TQ  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.nn import nchw, nhwc  # noqa: E402
from tests.test_torch_model import (  # noqa: E402
    C,
    SMALL,
    _assert_ids_agree,
    _assert_logits_close,
    _images,
    _run_params,
    _tree,
)

F32 = dict(compute_dtype=jnp.float32)
TF32 = dict(compute_dtype=torch.float32)

# HWIO kernels: conv1_1's K = 27 (padded to 32), a 3x3 middle layer, fc6's
# 7x7, fc7's 1x1, and an O and K that are no multiple of 8
KERNELS = [(3, 3, 3, 8), (3, 3, 8, 16), (7, 7, 16, 32), (1, 1, 32, 24), (3, 3, 5, 12)]


def _jax_tree_to_torch(qlayer: dict) -> dict:
    return bridge.quantized_to_port({"encoder_q": {"l": jax.tree.map(np.asarray, qlayer)},
                                     "decoder": {}})["encoder_q"]["l"]


def _as_torch(absmax) -> dict | None:
    return None if absmax is None else {k: torch.tensor(np.asarray(v)) for k, v in absmax.items()}


# ---------------------------------------------------------------------------
# the weight and activation quantization, the int8 convolution
# ---------------------------------------------------------------------------


def _hand_kernel():
    """tests/test_quantize.py's fixture: scale 2.54 / 127 with a -63.5-ulp
    half case, and scale 1 with 63.5, which rounds to even."""
    k = np.zeros((1, 1, 2, 2), np.float32)
    k[0, 0, :, 0] = [2.54, -1.27]
    k[0, 0, :, 1] = [127.0, 63.5]
    return k


@pytest.mark.parametrize("shape", KERNELS + ["hand"])
def test_quantize_kernel_per_channel_bit_equal_to_jax(rng, shape):
    if shape == "hand":
        k = _hand_kernel()
    else:
        k = rng.normal(size=shape).astype(np.float32)
        k[..., 1] = 0.0  # a zero channel: scale 1, all-zero weights
    jq, js = jax.jit(JQ.quantize_kernel_per_channel)(jnp.asarray(k))
    tq, ts = TQ.quantize_kernel_per_channel(torch.from_numpy(k).permute(3, 2, 0, 1))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.permute(2, 3, 1, 0).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if shape != "hand":
        assert float(ts[1]) == 1.0 and not bool(tq[1].any())


# (NHWC input, HWIO kernel); the 7x7 case on a 2x2 map has 4 rows, below
# _int_mm's 17, so the route pads rows
CONVS = [((2, 8, 12, 3), (3, 3, 3, 8)), ((2, 8, 12, 8), (3, 3, 8, 16)),
         ((2, 4, 6, 16), (7, 7, 16, 32)), ((2, 4, 6, 32), (1, 1, 32, 24)),
         ((1, 2, 2, 16), (7, 7, 16, 32)), ((1, 3, 5, 5), (3, 3, 5, 12))]


@pytest.mark.parametrize("route", ["twin", "im2col"])
@pytest.mark.parametrize("x_shape,k_shape", CONVS)
def test_int8_conv_accumulators_equal_jax(rng, route, x_shape, k_shape):
    xq = rng.integers(-127, 128, x_shape).astype(np.int8)
    kq = rng.integers(-127, 128, k_shape).astype(np.int8)
    xq[0, 0, 0, :] = kq[0, 0, :, 0] = 127  # the extreme products
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (1, 1), "SAME", dimension_numbers=DIMENSION_NUMBERS,
        preferred_element_type=jnp.int32))
    layer = TQ.quantized_layer(torch.from_numpy(kq).permute(3, 0, 1, 2),
                               torch.ones(k_shape[3]), torch.zeros(k_shape[3]))
    assert layer["kernel_mat"].shape[0] % 8 == 0 and layer["kernel_mat"].shape[1] % 8 == 0
    x = torch.from_numpy(xq)
    n = TQ.conv2d_int8_im2col.launches
    if route == "twin":
        got = TQ.conv2d_int8_reference(x, layer["kernel_q"])
    else:
        got = TQ.conv2d_int8_im2col(x, layer["kernel_q"], layer["kernel_mat"])
        assert TQ.conv2d_int8_im2col.launches == n + 1
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _ulp(v: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "float32":
        return np.spacing(np.abs(v).astype(np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_int8_within_one_ulp_of_jax(rng, static, dtype):
    x = rng.normal(size=(2, 8, 12, 8)).astype(np.float32) * 3
    k = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    jq, js = JQ.quantize_kernel_per_channel(jnp.asarray(k))
    jl = {"kernel_q": jq, "scale": js, "bias": jnp.asarray(b)}
    if static:  # a calibrated scale above this tensor's own
        jl["act_scale"] = jnp.float32(np.abs(x).max() * 1.25 / 127)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.jit(partial(JQ.conv2d_int8, compute_dtype=jdt))(
        jnp.asarray(x).astype(jdt), jl)).astype(np.float32)
    got = TQ.conv2d_int8(nchw(torch.from_numpy(x).to(tdt)), _jax_tree_to_torch(jl),
                         compute_dtype=tdt)
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
    got = nhwc(got).float().numpy()
    assert np.all(np.abs(got - want) <= _ulp(np.maximum(np.abs(got), np.abs(want)), dtype))


def test_collect_activation_absmax_matches_jax(rng):
    tree, images = _tree(), _images(rng)
    want = jax.jit(partial(JQ.collect_activation_absmax, **F32))(tree, jnp.asarray(images))
    with torch.inference_mode():
        got = TQ.collect_activation_absmax(_run_params(tree), torch.from_numpy(images), **TF32)
    assert set(got) == set(want) and len(got) == 15
    for name in want:
        assert got[name].dtype == torch.float32 and got[name].dim() == 0
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5)


@pytest.mark.parametrize("static", [False, True])
def test_apply_fcn8s_int8_matches_jax_on_its_quantized_tree(rng, static):
    tree, images = _tree(), _images(rng)
    jx = jnp.asarray(images)
    absmax = jax.jit(partial(JQ.collect_activation_absmax, **F32))(tree, jx) if static else None
    jq = jax.tree.map(np.asarray, jax.jit(JQ.quantize_fcn8s_params)(tree, absmax))
    want = np.asarray(jax.jit(partial(JQ.apply_fcn8s_int8, **F32))(jq, jx))
    from_jax = bridge.quantized_to_port(jq, torch.float32)
    with torch.inference_mode():
        got = TQ.apply_fcn8s_int8(from_jax, torch.from_numpy(images), **TF32)
    assert got.shape == want.shape == (2, 64, 64, C) and got.dtype == torch.float32
    _assert_logits_close(got.numpy(), want)
    _assert_ids_agree(got.numpy().argmax(-1), want.argmax(-1), want)

    # the port's own quantization of the same fp32 tree is JAX's, bit for bit
    own = TQ.quantize_fcn8s_params(bridge.to_port(tree), _as_torch(absmax), **TF32)
    for name, layer in own["encoder_q"].items():
        assert set(layer) == set(from_jax["encoder_q"][name])
        assert ("act_scale" in layer) == static
        for key, t in layer.items():
            assert torch.equal(t, from_jax["encoder_q"][name][key]), (name, key)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


def _jax_model():
    jm = JFCN8s(num_classes=C, **F32, **SMALL)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree()))
    return jm


def test_facade_calibration_and_quantized_predict_match_jax(rng):
    """Dynamic, then calibrated static (chunks of 2 over 3 images of 50x70,
    padded as predict pads) quantized predict, against the JAX facade."""
    images = _images(rng, n=3, h=50, w=70)
    jm = _jax_model()
    model = FCN8s.from_params(_tree(), device="cpu", **TF32, **SMALL)
    dyn_j = jm.predict(images, quantized=True, argmax=False)
    dyn_t = model.predict(images, quantized=True, argmax=False)
    assert dyn_t.shape == (3, 50, 70, C) and dyn_t.dtype == np.float32
    np.testing.assert_allclose(dyn_t, dyn_j, rtol=1e-4, atol=1e-4)

    want = jm.calibrate_quantization(images, batch_size=2)
    got = model.calibrate_quantization(images, batch_size=2)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5)
    assert "act_scale" in model._quantized_params()["encoder_q"]["fc7"]
    st_j = jm.predict(images, quantized=True, argmax=False)
    st_t = model.predict(images, quantized=True, argmax=False)
    np.testing.assert_allclose(st_t, st_j, rtol=1e-4, atol=1e-4)
    assert not np.array_equal(st_t, dyn_t)  # the static scales took effect
    ids = model.predict(images, quantized=True)
    assert ids.dtype == np.int32 and ids.shape == (3, 50, 70)
    _assert_ids_agree(ids, jm.predict(images, quantized=True), st_j)
    jm.close()


def _batch(seed=1, n=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 32, 64, 3), dtype=np.uint8),
            rng.integers(0, 3, (n, 32, 64)).astype(np.uint8))


def _repeat(images, labels):
    while True:
        yield images, labels


def _train(model, steps, **kw):
    model.train(_repeat(*_batch()), epochs=1, steps_per_epoch=steps,
                learning_rate_schedule=constant(1e-2), keep_prob=1.0, record_summaries=False,
                prefetch=0, **kw)


@pytest.mark.parametrize("change", ["train", "adopt_ema", "load_variables"])
def test_int8_tree_is_rebuilt_after_the_params_change(tmp_path, change):
    """After training, ``adopt_ema`` or ``load_variables`` the cached int8
    tree is marked stale and requantized from the new masters (into its own
    tensors, which the compiled predict steps read), with the calibrated
    scales kept."""
    model = FCN8s(num_classes=3, seed=0, device="cpu", **TF32, **SMALL)
    images = _batch()[0]
    if change == "adopt_ema":
        _train(model, 2, ema_decay=0.5)
    model.calibrate_quantization(images)
    before = model.predict(images, quantized=True, argmax=False)
    assert model._qparams is not None
    if change == "train":
        _train(model, 1)
    elif change == "adopt_ema":
        model.adopt_ema()
    else:
        other = FCN8s(num_classes=3, seed=1, device="cpu", **TF32, **SMALL)
        model.load_variables(other.save(str(tmp_path), force_save=True))
    assert model._qparams_stale
    after = model._quantized_params()
    want = TQ.quantize_fcn8s_params(model.params, model._act_absmax, **TF32)
    for name, layer in want["encoder_q"].items():
        assert "act_scale" in layer
        for key, t in layer.items():
            assert torch.equal(after["encoder_q"][name][key], t), (name, key)
    assert not np.array_equal(model.predict(images, quantized=True, argmax=False), before)


@pytest.fixture(scope="module")
def trained_tiny():
    """tests/test_quantize.py's task: class = brightness band of a pixel;
    a width-1/8 model trained 30 Adam steps by the port's ``train``."""
    rng = np.random.default_rng(42)
    images = rng.integers(0, 255, (4, 32, 32, 3), np.uint8)
    labels = (images.mean(-1) // 86).astype(np.uint8)
    model = FCN8s(num_classes=3, width_mult=1 / 8, fc_channels=64, seed=0, device="cpu", **TF32)
    model.train(_repeat(images, labels), epochs=1, steps_per_epoch=30,
                learning_rate_schedule=constant(1e-3), keep_prob=1.0, record_summaries=False,
                prefetch=0)
    return bridge.to_numpy(model.params), images


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_argmax_agreement_after_training(trained_tiny, dtype):
    tree, images = trained_tiny
    model = FCN8s.from_params(tree, width_mult=1 / 8, fc_channels=64, compute_dtype=dtype,
                              device="cpu")
    agreement = (model.predict(images) == model.predict(images, quantized=True)).mean()
    assert agreement >= 0.97, f"int8 / {dtype} argmax agreement {agreement:.4f}"
