"""PyTorch port, kernel-holding ops against the JAX package on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as tests/test_pallas.py runs them) and through the port's
wrapper, which on a CPU tensor takes its kernel's plain twin. Tolerances:
pools (forward, code and gradient), the subpixel tap algebra and confusion
matrices are exact (pure selection / integer counting); float convolutions
and the CE sums differ only in summation order, so they are held to rtol
1e-5, and CE gradients to rtol 1e-4 / atol 1e-6 (as tests/test_pallas.py
holds the Pallas CE against XLA); bf16 CE gradients to one bf16 rounding
(rtol 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.ops import metrics as jmetrics  # noqa: E402
from fcn8s_tensorflow_tpu.ops import nn as jnn  # noqa: E402
from fcn8s_tensorflow_tpu.ops import pallas_kernels as pk  # noqa: E402
from fcn8s_tensorflow_tpu.ops import subpixel as jsub  # noqa: E402
from fcn8s_tensorflow_tpu.ops.losses import (  # noqa: E402
    masked_mean_softmax_cross_entropy,
    valid_pixel_weights,
)
from fcn8s_tensorflow_tpu.ops.pallas_kernels import (  # noqa: E402
    confusion_matrix_pallas,
    masked_softmax_cross_entropy_pallas,
    softmax_cross_entropy_pallas,
)
from fcn8s_tensorflow_tpu.ops.pallas_pool import _fwd_impl, max_pool_2x2_pallas  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import kernels as K  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import metrics as tmetrics  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import subpixel as tsub  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.nn import nchw, nhwc  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.pool import (  # noqa: E402
    maxpool2x2,
    maxpool2x2_bwd_nhwc,
    maxpool2x2_code_nhwc,
    maxpool2x2_nhwc,
)


def _pool(x_nhwc: np.ndarray) -> np.ndarray:
    """The port's pool wrapper on an NHWC array (channels_last inside)."""
    return nhwc(maxpool2x2_nhwc(nchw(torch.from_numpy(x_nhwc)))).numpy()


# ---------------------------------------------------------------------------
# K4f: 2x2 max pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 8, 64), (1, 32, 16, 128)])
def test_pool_matches_reduce_window_and_pallas(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    got = _pool(x)
    np.testing.assert_array_equal(got, np.asarray(jnn.max_pool_2x2(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.asarray(max_pool_2x2_pallas(jnp.asarray(x), True)))


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (1, 5, 4, 3), (1, 1, 3, 2)])
def test_pool_odd_dims_match_reduce_window_same(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(_pool(x), np.asarray(jnn.max_pool_2x2(jnp.asarray(x))))


def test_pool_ties_and_nan_bf16(rng):
    """bf16 with many ties and a NaN: NaN propagates like lax.max, and the
    values are bit-identical to reduce_window in the same dtype."""
    x = rng.integers(-2, 3, size=(2, 8, 8, 16)).astype(np.float32)
    x[0, 3, 4, 5] = np.nan
    got = maxpool2x2_nhwc(nchw(torch.from_numpy(x).to(torch.bfloat16)))
    want = np.asarray(jnn.max_pool_2x2(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = nhwc(got).float().numpy()
    assert np.isnan(got[0, 1, 2, 5])
    np.testing.assert_array_equal(got, want)


def _meta(shape, dtype=torch.bfloat16, channels_last=True):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t.contiguous(memory_format=torch.channels_last) if channels_last else t


@pytest.mark.parametrize("x, match", [
    (_meta((2, 64, 15, 16)), "even"),
    (_meta((2, 64, 16, 16), dtype=torch.float16), "bf16 or fp32"),
    (_meta((2, 64, 16, 16), channels_last=False), "channels_last"),
    (_meta((2, 64, 16, 16)), "CUDA"),
])
def test_pool_wrapper_rejects_what_the_kernel_does_not_take(x, match):
    """Off the CPU the wrapper never falls back: it launches the kernel or
    raises (meta tensors reach the checks without a card)."""
    with pytest.raises(ValueError, match=match):
        maxpool2x2_nhwc(x)


# ---------------------------------------------------------------------------
# subpixel deconv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [2, 8, 16, 32])
def test_subpixel_kernel_tap_algebra_is_exact(rng, s):
    kernel = rng.normal(size=(2 * s, 2 * s, 3, 4)).astype(np.float32)
    want = np.asarray(jsub._subpixel_kernel(jnp.asarray(kernel), s))
    got = tsub._subpixel_kernel(torch.from_numpy(kernel), s).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [2, 8])
@pytest.mark.parametrize("packed", [False, True])
def test_subpixel_deconv_matches_jax(rng, s, packed):
    c_in, c_out = 6, 5
    x = rng.normal(size=(2, 5, 7, c_in)).astype(np.float32)
    kernel = rng.normal(size=(2 * s, 2 * s, c_in, c_out)).astype(np.float32)
    bias = rng.normal(size=(c_out,)).astype(np.float32)
    want = np.asarray(jsub.conv2d_transpose_subpixel(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), stride=s, packed=packed))
    w, b = tsub.subpixel_weight(torch.from_numpy(kernel), torch.from_numpy(bias), s)
    got = tsub.conv2d_transpose_subpixel(nchw(torch.from_numpy(x)), w, b, stride=s, packed=packed)
    got = (got if packed else nhwc(got)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_subpixel_rejects_wrong_kernel():
    with pytest.raises(ValueError, match="2s x 2s"):
        tsub._subpixel_kernel(torch.zeros(3, 3, 2, 2), 2)


# ---------------------------------------------------------------------------
# K1: per-sample CE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label_dtype", [np.int32, np.uint8])
def test_ce_matches_pallas_with_mask_and_out_of_range_label(rng, label_dtype):
    """A zeroed mask entry and out-of-range labels (which pick nothing in
    the per-sample Pallas path), rtol 1e-5 (summation order differs)."""
    c = 7
    logits = rng.normal(size=(3, 16, 16, c)).astype(np.float32) * 3
    labels = rng.integers(0, c, (3, 16, 16)).astype(label_dtype)
    labels[0, 2, 3] = 9
    labels[2, 5, 5] = 200
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    want = float(softmax_cross_entropy_pallas(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), interpret=True))
    got = K.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_ce_without_mask_matches_mean_ce(rng):
    c = 20
    logits = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    labels = rng.integers(0, c, (2, 16, 16)).astype(np.int32)
    want = float(softmax_cross_entropy_pallas(jnp.asarray(logits), jnp.asarray(labels),
                                              interpret=True))
    got = K.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_ce_wrapper_rejects_what_the_kernel_does_not_take():
    logits = torch.empty((64, 5), dtype=torch.bfloat16, device="meta")
    labels = torch.empty((64,), dtype=torch.uint8, device="meta")
    mask = torch.empty((2,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.ce_sum_per_sample(logits, labels, mask, 32)
    with pytest.raises(ValueError, match="split"):
        K.ce_sum_per_sample(logits, labels, mask, 16)
    with pytest.raises(ValueError, match="uint8 or int32"):
        K.ce_sum_per_sample(logits, labels.to(torch.int64), mask, 32)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        K.ce_sum_per_sample(logits.to(torch.float16), labels, mask, 32)


# ---------------------------------------------------------------------------
# K5: confusion matrix, and the metrics around it
# ---------------------------------------------------------------------------


def _ids(rng, c, shape=(3, 16, 16)):
    pred = rng.integers(0, c, shape).astype(np.int32)
    gt = rng.integers(0, c, shape).astype(np.int32)
    pred[0, 0, :4] = [c, c + 2, -1, 0]
    gt[1, 3, :3] = [c + 1, -1, 2]
    return pred, gt


def test_confmat_matches_pallas_and_xla_exactly(rng):
    c = 20
    pred, gt = _ids(rng, c)
    got = tmetrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt), c).numpy()
    want_pallas = np.asarray(confusion_matrix_pallas(jnp.asarray(pred), jnp.asarray(gt), c,
                                                     chunk=256, interpret=True))
    want_xla = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), c))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want_pallas.astype(np.int32))
    np.testing.assert_array_equal(got, want_xla.astype(np.int32))


def test_confmat_sample_mask_matches_xla_exactly(rng):
    c = 5
    pred, gt = _ids(rng, c)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), c,
                                                jnp.asarray(mask))).astype(np.int32)
    got = tmetrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt.astype(np.int32)),
                                    c, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    # uint8 GT (the facade's label dtype) counts the same
    gt8 = np.where((gt >= 0) & (gt < 255), gt, 255).astype(np.uint8)
    got8 = tmetrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt8), c,
                                     torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got8, want)


def test_confmat_accumulates_in_place(rng):
    c = 4
    pred, gt = _ids(rng, c)
    conf = torch.zeros((c, c), dtype=torch.int32)
    mask = torch.ones(3)
    out = K.confusion_matrix_accumulate(conf, torch.from_numpy(pred.reshape(-1)),
                                        torch.from_numpy(gt.reshape(-1)), mask, 256)
    assert out is conf
    K.confusion_matrix_accumulate(conf, torch.from_numpy(pred.reshape(-1)),
                                  torch.from_numpy(gt.reshape(-1)), mask, 256)
    want = 2 * np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), c))
    np.testing.assert_array_equal(conf.numpy(), want.astype(np.int32))


def test_confmat_wrapper_rejects_what_the_kernel_does_not_take():
    conf = torch.empty((4, 4), dtype=torch.int32, device="meta")
    ids = torch.empty((64,), dtype=torch.int32, device="meta")
    mask = torch.empty((2,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.confusion_matrix_accumulate(conf, ids, ids, mask, 32)
    with pytest.raises(ValueError, match="int32"):
        K.confusion_matrix_accumulate(conf.to(torch.int64), ids, ids, mask, 32)
    with pytest.raises(ValueError, match="uint8 or int32"):
        K.confusion_matrix_accumulate(conf, ids.to(torch.int64), ids, mask, 32)


@pytest.mark.parametrize("on_card", ["pred", "gt", "mask", "all"])
def test_confmat_wrapper_takes_the_twin_only_when_all_lie_on_the_cpu(on_card):
    """A CPU ``conf`` with ids or a mask elsewhere (a meta tensor stands in
    for the card) raises instead of running the twin across devices."""
    t = {"pred": torch.zeros(64, dtype=torch.int32), "gt": torch.zeros(64, dtype=torch.uint8),
         "mask": torch.ones(2)}
    for k in t if on_card == "all" else [on_card]:
        t[k] = t[k].to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.confusion_matrix_accumulate(torch.zeros((4, 4), dtype=torch.int32), t["pred"], t["gt"],
                                      t["mask"], 32)


def test_metrics_match_jax(rng):
    c = 6
    pred, gt = _ids(rng, c)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    js = jmetrics.update_metrics_state(
        jmetrics.empty_metrics_state(c), loss=jnp.float32(1.25), pred_ids=jnp.asarray(pred),
        gt_ids=jnp.asarray(gt), num_classes=c, sample_mask=jnp.asarray(mask))
    state = tmetrics.empty_metrics_state(c, device="cpu")
    ts = tmetrics.update_metrics_state(
        state, loss=torch.tensor(1.25), pred_ids=torch.from_numpy(pred),
        gt_ids=torch.from_numpy(gt), num_classes=c, sample_mask=torch.from_numpy(mask))
    assert ts is state
    np.testing.assert_array_equal(ts["conf_matrix"].numpy(), np.asarray(js["conf_matrix"]))
    conf_t, conf_j = ts["conf_matrix"], js["conf_matrix"]
    for tfn, jfn in [(tmetrics.per_class_iou_from_confusion, jmetrics.per_class_iou_from_confusion),
                     (tmetrics.benchmark_iou_from_confusion,
                      jmetrics.benchmark_iou_from_confusion)]:
        (ti, tv), (ji, jv) = tfn(conf_t), jfn(conf_j)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tf, jf = tmetrics.finalize_metrics(ts), jmetrics.finalize_metrics(js)
    for key in ("loss", "mean_iou", "accuracy"):
        np.testing.assert_allclose(float(tf[key]), float(jf[key]), rtol=1e-6)


# ---------------------------------------------------------------------------
# K4a/K4b: the pool under autograd
# ---------------------------------------------------------------------------


def _ties(rng, shape):
    """Values on a coarse grid, so most windows hold ties."""
    return np.round(rng.standard_normal(shape) * 2).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 16, 8, 64), (2, 32, 16, 128)])
def test_pool_autograd_gradient_bit_exact_with_jax(rng, shape):
    """The port's pool under autograd (the K4a/K4b pair's plain twins on
    the CPU) routes dy exactly as JAX's Pallas VJP and XLA's
    select-and-scatter do, ties included; y is bit-exact too."""
    x = _ties(rng, shape)
    dy = rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 2, shape[3])).astype(np.float32)
    jx, jdy = jnp.asarray(x), jnp.asarray(dy)
    want_pallas = np.asarray(jax.vjp(lambda t: max_pool_2x2_pallas(t, True), jx)[1](jdy)[0])
    want_xla = np.asarray(jax.vjp(jnn.max_pool_2x2, jx)[1](jdy)[0])
    tx = nchw(torch.from_numpy(x)).contiguous(memory_format=torch.channels_last).requires_grad_()
    y = maxpool2x2(tx)
    assert "MaxPool2x2" in type(y.grad_fn).__name__
    y.backward(nchw(torch.from_numpy(dy)))
    got = nhwc(tx.grad).numpy()
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(nhwc(y.detach()).numpy(), np.asarray(jnn.max_pool_2x2(jx)))


def test_pool_code_twin_matches_pallas_fwd_impl(rng):
    x = _ties(rng, (2, 16, 8, 64))
    y, code = maxpool2x2_code_nhwc(nchw(torch.from_numpy(x)))
    want_y, want_code = _fwd_impl(jnp.asarray(x), interpret=True)
    assert code.dtype == torch.uint8 and code.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(code).numpy(),
                                  np.asarray(want_code).reshape(nhwc(code).shape))
    np.testing.assert_array_equal(nhwc(y).numpy(), np.asarray(want_y))


def test_pool_bwd_twin_writes_zero_off_the_code(rng):
    dy = torch.from_numpy(rng.standard_normal((1, 4, 3, 5)).astype(np.float32))
    code = torch.from_numpy(rng.integers(0, 4, (1, 4, 3, 5)).astype(np.uint8))
    dx = maxpool2x2_bwd_nhwc(dy, code)
    assert dx.shape == (1, 4, 6, 10)
    windows = dx.view(1, 4, 3, 2, 5, 2).permute(0, 1, 2, 4, 3, 5).reshape(1, 4, 3, 5, 4)
    assert torch.equal(windows.gather(-1, code.long()[..., None])[..., 0], dy)
    assert int((windows != 0).sum()) == int((dy != 0).sum())


def test_pool_without_grad_takes_the_forward_only_kernel(rng):
    x = nchw(torch.from_numpy(_ties(rng, (1, 4, 4, 8)))).requires_grad_()
    with torch.no_grad():
        assert maxpool2x2(x).grad_fn is None
    assert maxpool2x2(x).grad_fn is not None


@pytest.mark.parametrize("call, match", [
    (lambda: maxpool2x2_code_nhwc(_meta((2, 64, 15, 16))), "even"),
    (lambda: maxpool2x2_code_nhwc(_meta((2, 64, 16, 16), channels_last=False)), "channels_last"),
    (lambda: maxpool2x2_code_nhwc(_meta((2, 64, 16, 16))), "CUDA"),
    (lambda: maxpool2x2_bwd_nhwc(_meta((2, 8, 4, 4)), _meta((2, 8, 4, 4), torch.uint8)), "CUDA"),
    (lambda: maxpool2x2_bwd_nhwc(_meta((2, 8, 4, 4), channels_last=False),
                                 _meta((2, 8, 4, 4), torch.uint8)), "channels_last"),
    (lambda: maxpool2x2_bwd_nhwc(_meta((2, 8, 4, 4)), _meta((2, 8, 4, 4))), "uint8"),
    (lambda: maxpool2x2_bwd_nhwc(_meta((2, 8, 4, 4), torch.float16),
                                 _meta((2, 8, 4, 4), torch.uint8)), "bf16 or fp32"),
])
def test_pool_pair_wrappers_reject_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# ---------------------------------------------------------------------------
# K1/K3 under autograd, the CE-grad kernel and the masked path
# ---------------------------------------------------------------------------


def _ce_inputs(rng, c=7, shape=(3, 8, 16)):
    logits = rng.normal(size=shape + (c,)).astype(np.float32) * 3
    labels = rng.integers(0, c, shape).astype(np.int32)
    return logits, labels


def _port_value_and_grad(fn, logits, *args):
    t = torch.from_numpy(logits).requires_grad_()
    value = fn(t, *args)
    value.backward()
    return float(value.detach()), t.grad.numpy()


def _jax_value_and_grad(fn, logits, *args):
    value, grad = jax.value_and_grad(fn)(jnp.asarray(logits), *args)
    return float(value), np.asarray(grad)


def _assert_ce_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)


def test_ce_per_sample_value_and_grad_match_pallas(rng):
    logits, labels = _ce_inputs(rng)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    want = _jax_value_and_grad(lambda l: softmax_cross_entropy_pallas(
        l, jnp.asarray(labels), jnp.asarray(mask), chunk=128, interpret=True), logits)
    got = _port_value_and_grad(K.softmax_cross_entropy, logits, torch.from_numpy(labels),
                               torch.from_numpy(mask))
    _assert_ce_close(got, want)
    assert np.all(got[1][1] == 0)  # the masked sample


def test_ce_dense_pixel_weights_match_pallas(rng):
    logits, labels = _ce_inputs(rng)
    labels[0, 0, :3] = 200  # out of range: picks nothing, one-hots to zeros
    weights = rng.uniform(0, 2, labels.shape).astype(np.float32)
    weights[1, 2] = 0.0
    want = _jax_value_and_grad(lambda l: softmax_cross_entropy_pallas(
        l, jnp.asarray(labels), jnp.asarray(weights), chunk=128, interpret=True), logits)
    got = _port_value_and_grad(K.softmax_cross_entropy, logits, torch.from_numpy(labels),
                               torch.from_numpy(weights))
    _assert_ce_close(got, want)


def test_masked_ce_matches_pallas_with_exact_zeros(rng):
    """K3 with valid-pixel weights meets the masked path's contract: the
    weighted-valid-count mean, and exactly zero gradient where ignored."""
    logits, labels = _ce_inputs(rng)
    labels[rng.random(labels.shape) < 0.3] = 255
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    want = _jax_value_and_grad(lambda l: masked_softmax_cross_entropy_pallas(
        l, jnp.asarray(labels), jnp.asarray(mask), 255, chunk=128, interpret=True), logits)
    got = _port_value_and_grad(K.masked_softmax_cross_entropy, logits, torch.from_numpy(labels),
                               torch.from_numpy(mask), 255)
    _assert_ce_close(got, want)
    ignored = labels == 255
    assert np.all(got[1][ignored] == 0) and np.abs(got[1][:2][~ignored[:2]]).max() > 0
    np.testing.assert_allclose(got[0], float(masked_mean_softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        valid_pixel_weights(jnp.asarray(labels), jnp.asarray(mask), 255))), rtol=1e-5)


def test_masked_ce_all_ignored_is_zero(rng):
    logits, labels = _ce_inputs(rng)
    labels[:] = 255
    value, grad = _port_value_and_grad(K.masked_softmax_cross_entropy, logits,
                                       torch.from_numpy(labels), torch.ones(3), 255)
    assert value == 0.0 and np.all(grad == 0)


def test_ce_bf16_logits_keep_a_bf16_gradient(rng):
    logits, labels = _ce_inputs(rng)
    t = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    loss = K.softmax_cross_entropy(t, torch.from_numpy(labels).to(torch.uint8))
    loss.backward()
    assert loss.dtype == torch.float32 and t.grad.dtype == torch.bfloat16
    want = jax.grad(lambda l: softmax_cross_entropy_pallas(
        l, jnp.asarray(labels), chunk=128, interpret=True))(jnp.asarray(logits, jnp.bfloat16))
    np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-6)


def test_ce_grad_twin_weight_modes_agree(rng):
    """The per-sample mode equals the per-pixel mode with the mask spread
    over each sample's pixels."""
    logits, labels = _ce_inputs(rng)
    flat = torch.from_numpy(logits.reshape(-1, 7))
    ids = torch.from_numpy(labels.reshape(-1))
    mask = torch.tensor([1.0, 0.0, 2.0])
    g = torch.tensor(0.25)
    per_sample = K.ce_grad(flat, ids, mask, g, 128)
    per_pixel = K.ce_grad(flat, ids, mask.repeat_interleave(128), g)
    torch.testing.assert_close(per_sample, per_pixel, rtol=1e-6, atol=0)


def test_ce_sum_weighted_matches_pallas_sum(rng):
    logits, labels = _ce_inputs(rng)
    weights = rng.uniform(0, 1, labels.shape).astype(np.float32)
    got = K.ce_sum_weighted(torch.from_numpy(logits.reshape(-1, 7)),
                            torch.from_numpy(labels.reshape(-1)),
                            torch.from_numpy(weights.reshape(-1)))
    want = pk._ce_sum_impl(jnp.asarray(logits.reshape(-1, 7)),
                           jnp.asarray(labels.reshape(-1, 1)), jnp.asarray(weights.reshape(-1, 1)),
                           num_classes=7, chunk=128, interpret=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_ce_kernel_wrappers_reject_what_the_kernels_do_not_take():
    logits = torch.empty((64, 5), dtype=torch.bfloat16, device="meta")
    labels = torch.empty((64,), dtype=torch.uint8, device="meta")
    weights = torch.empty((64,), dtype=torch.float32, device="meta")
    g = torch.empty((), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.ce_sum_weighted(logits, labels, weights)
    with pytest.raises(ValueError, match="float32"):
        K.ce_sum_weighted(logits, labels, weights[:32])
    with pytest.raises(ValueError, match="CUDA"):
        K.ce_grad(logits, labels, weights, g)
    with pytest.raises(ValueError, match="split"):
        K.ce_grad(logits, labels, weights[:3], g, 32)
    with pytest.raises(ValueError, match="one-element"):
        K.ce_grad(logits, labels, weights, g.to(torch.float64))
