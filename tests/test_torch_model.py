"""PyTorch port, the slice as a whole against the JAX package on the CPU.

A narrow model (``width_mult=1/32, fc_channels=32``) on 64x64 inputs in
fp32, with the same numpy weights handed to both packages through the
bridge. Tolerances, with their reasons:

* fp32 logits: ``atol = 1e-4 * max|logits_jax|``, ``rtol = 1e-4`` — XLA:CPU
  and oneDNN sum the convolutions in different orders;
* argmax ids: equal wherever JAX's top-2 margin exceeds
  ``1e-3 * max|logits|``, and equal on >= 99.9% of pixels overall;
* overlay: within 1 LSB where the ids agree (FMA contraction);
* confusion matrices: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.models.fcn8s import apply_fcn8s as j_apply  # noqa: E402
from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu.ops.metrics import empty_metrics_state as j_empty  # noqa: E402
from fcn8s_tensorflow_tpu.parallel.steps import eval_step as j_eval  # noqa: E402
from fcn8s_tensorflow_tpu.parallel.steps import predict_step as j_predict  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.fcn8s import apply_fcn8s as t_apply  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s as t_init  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.metrics import empty_metrics_state as t_empty  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel.steps import eval_step as t_eval  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel.steps import predict_step as t_predict  # noqa: E402

C = 5
SMALL = dict(width_mult=1 / 32, fc_channels=32)
F32 = dict(compute_dtype=jnp.float32)
TF32 = dict(compute_dtype=torch.float32)


@functools.cache
def _tree(variant="fcn8s", seed=0):
    """A JAX-initialised numpy tree whose decoder kernels are redrawn at
    unit fan-in scale, so the logits (and their argmax margins) are O(1)
    instead of the 1e-3-sigma init's near-ties. Cached: callers only read it."""
    init = jax.jit(lambda key: j_init(key, C, variant=variant, **SMALL))
    tree = jax.tree.map(np.array, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = rng.normal(size=layer["bias"].shape).astype(np.float32) * 0.1
    return tree


def _images(rng, n=2, h=64, w=64):
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _run_params(tree):
    return bridge.cast_params(bridge.to_port(tree), torch.float32)


def _assert_logits_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _assert_ids_agree(got, want, logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3 * np.abs(logits).max()
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (got == want).mean() >= 0.999


# ---------------------------------------------------------------------------
# bridge and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fcn8s", "fcn16s", "fcn32s"])
def test_bridge_round_trip_is_exact(variant):
    tree = _tree(variant)
    back = bridge.to_numpy(bridge.to_port(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["fcn8s", "fcn16s", "fcn32s"])
def test_fresh_init_has_the_jax_tree_shapes(variant):
    """The port's seeded init draws its own stream but the same tree:
    same layers, shapes and dtypes as ``init_fcn8s`` of the JAX package."""
    want = jax.eval_shape(lambda k: j_init(k, C, variant=variant, **SMALL),
                          jax.random.PRNGKey(0))
    got = t_init(torch.Generator().manual_seed(0), C, variant=variant, **SMALL)
    assert jax.tree.structure(jax.tree.map(np.asarray, got)) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_fresh_init_is_seeded():
    a = FCN8s(num_classes=C, seed=3, device="cpu", **SMALL)
    b = FCN8s(num_classes=C, seed=3, device="cpu", **SMALL)
    c = FCN8s(num_classes=C, seed=4, device="cpu", **SMALL)
    wa, wb, wc = (m.params["encoder"]["conv1_1"]["weight"] for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)


# ---------------------------------------------------------------------------
# forward, predict and eval steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fcn8s", "fcn16s", "fcn32s"])
def test_apply_fcn8s_matches_jax(rng, variant):
    tree = _tree(variant)
    images = _images(rng)
    want = np.asarray(j_apply(tree, jnp.asarray(images), **F32))
    with torch.inference_mode():
        got = t_apply(_run_params(tree), torch.from_numpy(images), **TF32)
    assert got.shape == want.shape == (2, 64, 64, C) and got.dtype == torch.float32
    _assert_logits_close(got.numpy(), want)


def test_packed_final_matches_jax(rng):
    tree = _tree()
    images = _images(rng)
    want = np.asarray(j_apply(tree, jnp.asarray(images), packed_final=True, **F32))
    with torch.inference_mode():
        got = t_apply(_run_params(tree), torch.from_numpy(images), packed_final=True, **TF32)
    assert got.shape == want.shape == (2, 8, 8, 8, 8, C)
    _assert_logits_close(got.numpy(), want)


def test_predict_step_ids_overlay_softmax_match_jax(rng):
    tree = _tree()
    images = _images(rng)
    params = _run_params(tree)
    logits = np.asarray(j_apply(tree, jnp.asarray(images), **F32))
    lut = np.array([[255, 0, 0, 0], [0, 255, 0, 255], [10, 20, 30, 127], [0, 0, 0, 255],
                    [200, 100, 50, 60]], np.float32)
    jx = jnp.asarray(images)
    ids_j = np.asarray(j_predict(tree, jx, **F32))
    ov_j = np.asarray(j_predict(tree, jx, overlay_lut=lut, **F32))
    sm_j = np.asarray(j_predict(tree, jx, argmax=False, **F32))
    tx = torch.from_numpy(images)
    with torch.inference_mode():
        ids_t = t_predict(params, tx, **TF32).numpy()
        ids_u8 = t_predict(params, tx, id_dtype=torch.uint8, **TF32).numpy()
        ov_t = t_predict(params, tx, overlay_lut=lut, **TF32).numpy()
        sm_t = t_predict(params, tx, argmax=False, **TF32).numpy()
    assert ids_t.dtype == np.int32 and ids_u8.dtype == np.uint8 and ov_t.dtype == np.uint8
    np.testing.assert_array_equal(ids_u8, ids_t)
    _assert_ids_agree(ids_t, ids_j, logits)
    same = ids_t == ids_j
    assert np.abs(ov_t.astype(int) - ov_j.astype(int))[same].max() <= 1
    np.testing.assert_array_equal(ov_t[ids_t == 0], images[ids_t == 0])  # alpha 0 passes through
    np.testing.assert_allclose(sm_t, sm_j, rtol=1e-4, atol=1e-4 * np.abs(logits).max())


def test_eval_step_matches_jax_cpu_path(rng):
    tree = _tree()
    images = _images(rng, n=3)
    labels = rng.integers(0, C, (3, 64, 64)).astype(np.uint8)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    js = j_eval(tree, j_empty(C), jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mask),
                num_classes=C, use_pallas_ce=False, **F32)
    with torch.inference_mode():
        ts = t_eval(_run_params(tree), t_empty(C), torch.from_numpy(images),
                    torch.from_numpy(labels), torch.from_numpy(mask), num_classes=C, **TF32)
    np.testing.assert_allclose(float(ts["loss_sum"]), float(js["loss_sum"]), rtol=1e-5)
    assert float(ts["loss_count"]) == float(js["loss_count"]) == 1.0
    np.testing.assert_array_equal(ts["conf_matrix"].numpy(), np.asarray(js["conf_matrix"]))
    assert int(ts["conf_matrix"].sum()) == 2 * 64 * 64


def test_steps_raise_for_what_is_not_ported(rng):
    params = _run_params(_tree())
    images = torch.from_numpy(_images(rng, n=1))
    with pytest.raises(NotImplementedError):
        t_predict(params, images, quantized=True)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


def test_facade_predict_pads_crops_and_matches_jax(rng):
    tree = _tree()
    model = FCN8s.from_params(tree, compute_dtype=torch.float32, device="cpu", **SMALL)
    assert model.model_config["num_classes"] == C and model.variant == "fcn8s"
    images = _images(rng, n=3, h=50, w=70)
    padded = np.pad(images, ((0, 0), (0, 14), (0, 26), (0, 0)))
    logits = np.asarray(j_apply(tree, jnp.asarray(padded), **F32))[:, :50, :70]
    want = np.asarray(j_predict(tree, jnp.asarray(padded), **F32))[:, :50, :70]
    got = model.predict(images)
    assert got.shape == (3, 50, 70) and got.dtype == np.int32
    _assert_ids_agree(got, want, logits)
    overlay = model.predict(images[0], overlay={0: (255, 0, 0, 127), -1: (0, 0, 0, 255)})
    assert overlay.shape == (1, 50, 70, 3) and overlay.dtype == np.uint8
    probs = model.predict(images, argmax=False)
    assert probs.shape == (3, 50, 70, C)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    with pytest.raises(NotImplementedError):
        model.predict(images, tile=(64, 64))
    with pytest.raises(NotImplementedError):
        model.predict_tta(images)


def test_facade_evaluate_matches_jax_eval_steps(rng):
    """Three batches (the last one short) through ``FCN8s.evaluate`` give
    the JAX eval step's running loss and its exact confusion matrix."""
    tree = _tree()
    model = FCN8s.from_params(tree, compute_dtype=torch.float32, device="cpu", **SMALL)
    batches = [(_images(rng, n=n), rng.integers(0, C, (n, 64, 64)).astype(np.uint8))
               for n in (2, 2, 1)]
    js = j_empty(C)
    for images, labels in batches:
        js = j_eval(tree, js, jnp.asarray(images), jnp.asarray(labels),
                    jnp.ones(len(images)), num_classes=C, use_pallas_ce=False, **F32)
    values = model.evaluate(iter(batches), 3, metrics={"loss", "mean_iou"})
    assert model.metric_names == ["loss", "mean_iou"]
    np.testing.assert_array_equal(model.metrics_state["conf_matrix"].numpy(),
                                  np.asarray(js["conf_matrix"]))
    np.testing.assert_allclose(values["loss"], float(js["loss_sum"]) / 3, rtol=1e-5)
    with pytest.raises(ValueError):
        model.evaluate(iter(batches), 1, metrics={"bogus"})
    model.close()
