"""PyTorch port, the TensorFlow tools (``tools/parity_harness.py`` and
``tools/tf_interop.py`` of ``fcn8s_tensorflow_tpu_torch``) against the JAX
package's on the CPU, where TensorFlow is installed (the card's machine
has none: there the tools raise ``ImportError`` naming it).

* parity: the port's fp32 forward against the TF reference graph on the
  same weights, within the JAX harness's own bounds
  (``tests/test_tf_parity.py``): logits ``max_rel_diff`` < 1e-4, argmax
  agreement > 0.999, the mean CE within rtol 1e-4, and one Adam step's
  largest weight difference < 0.01 * lr; the port's harness loads the TF
  graph with the JAX harness's weights, bit for bit;
* interop: the port's SavedModel exported from one checkpoint gives the
  JAX tool's logits (within 1e-6; fcn8s and fcn32s), reads back into the
  port's tree bit for bit; fcn16s exported from live params serves the
  port's logits; the loader defaults to the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

tf = pytest.importorskip("tensorflow")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402
from fcn8s_tensorflow_tpu_torch.tools import parity_harness as ph  # noqa: E402
from fcn8s_tensorflow_tpu_torch.tools import tf_interop as ti  # noqa: E402
from tools import parity_harness as jph  # noqa: E402
from tools import tf_interop as jti  # noqa: E402

NUM_CLASSES = 20
TINY = dict(width_mult=1 / 16, fc_channels=64)


def _tree(seed, num_classes=NUM_CLASSES, **kw):
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), num_classes,
                                           **(kw or TINY)))


def test_port_forward_and_loss_match_the_tf_reference():
    rng = np.random.default_rng(42)
    tree = _tree(1)
    params = bridge.to_port(tree)
    tf_model = ph.build_tf_reference_model(NUM_CLASSES, **TINY)
    ph.copy_params_to_tf(params, tf_model)
    images = rng.integers(0, 255, size=(2, 64, 96, 3), dtype=np.uint8)
    label_ids = rng.integers(0, NUM_CLASSES, size=(2, 64, 96))
    lt = ph.tf_forward(tf_model, images)
    lp = ph.torch_forward(params, images)
    stats = ph.compare_logits(lt, lp)
    assert stats["max_rel_diff"] < 1e-4 and stats["argmax_agreement"] > 0.999, stats
    tf_loss = float(tf.reduce_mean(tf.nn.softmax_cross_entropy_with_logits(
        labels=tf.one_hot(label_ids, NUM_CLASSES), logits=lt)))
    port_loss = float(torch.nn.functional.cross_entropy(
        torch.from_numpy(lp).permute(0, 3, 1, 2), torch.from_numpy(label_ids)))
    np.testing.assert_allclose(port_loss, tf_loss, rtol=1e-4)


def test_port_harness_loads_the_jax_harness_weights():
    tree = _tree(2)
    a = ph.build_tf_reference_model(NUM_CLASSES, **TINY)
    b = jph.build_tf_reference_model(NUM_CLASSES, **TINY)
    ph.copy_params_to_tf(bridge.to_port(tree), a)
    jph.copy_params_to_tf(tree, b)
    for la, lb in zip(a.layers, b.layers):
        for wa, wb in zip(la.get_weights(), lb.get_weights()):
            assert wa.dtype == wb.dtype and wa.tobytes() == wb.tobytes(), la.name


def test_one_adam_step_matches_the_tf_reference():
    rng = np.random.default_rng(42)
    lr = 1e-3
    tree = _tree(2)
    tf_model = ph.build_tf_reference_model(NUM_CLASSES, **TINY)
    ph.copy_params_to_tf(bridge.to_port(tree), tf_model)
    images = rng.integers(0, 255, size=(2, 64, 64, 3), dtype=np.uint8)
    label_ids = rng.integers(0, NUM_CLASSES, size=(2, 64, 64)).astype(np.uint8)
    tf_loss, tf_weights = ph.tf_loss_and_adam_step(tf_model, images, label_ids, NUM_CLASSES,
                                                   learning_rate=lr)
    opt = tsteps.make_optimizer()
    state = tsteps.create_train_state(bridge.to_port(tree), opt)
    state, loss = tsteps.train_step(state, torch.from_numpy(images), torch.from_numpy(label_ids),
                                    torch.ones(2), 0, lr, 0.0, 1.0, optimizer=opt,
                                    num_classes=NUM_CLASSES, compute_dtype=torch.float32)
    np.testing.assert_allclose(float(loss), tf_loss, rtol=1e-4)
    worst = 0.0
    for part, layers in bridge.to_numpy(state.params).items():
        for name, layer in layers.items():
            kernel = layer["kernel"]
            if name.endswith("deconv"):
                kernel = kernel[::-1, ::-1].transpose(0, 1, 3, 2)
            got_k, got_b = tf_weights[name]
            worst = max(worst, np.abs(kernel - got_k).max(), np.abs(layer["bias"] - got_b).max())
    assert worst < 0.01 * lr, worst


@pytest.mark.parametrize("variant", ["fcn8s", "fcn32s"])
def test_savedmodel_from_one_checkpoint_equals_the_jax_tools(tmp_path, variant):
    """A checkpoint written by the port's facade, exported by both tools:
    the same serving logits; the port's export reads back bit for bit."""
    model = FCN8s.from_params(_tree(3, 5, variant=variant, **TINY), width_mult=1 / 16,
                              fc_channels=64, compute_dtype=torch.float32, device="cpu")
    ckpt = model.save(str(tmp_path / "ckpts"), force_save=True)
    ours = ti.export_tf_savedmodel(ckpt, str(tmp_path / "port_sm"))
    theirs = jti.export_tf_savedmodel(ckpt, str(tmp_path / "jax_sm"))
    image = np.random.default_rng(0).integers(0, 255, (1, 64, 96, 3), np.uint8)
    got, want = (tf.saved_model.load(d).signatures["serving_default"](image=tf.constant(image))
                 for d in (ours, theirs))
    g, w = got["logits"].numpy(), want["logits"].numpy()
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1.0)
    np.testing.assert_array_equal(got["argmax"].numpy(), want["argmax"].numpy())
    back = ti.load_tf_savedmodel_params(ours, model.params, device="cpu")
    for a, b in zip(bridge.param_leaves(back), bridge.param_leaves(model.params)):
        assert a.device.type == "cpu" and torch.equal(a, b.detach())


def test_export_of_live_params_and_default_device(tmp_path, monkeypatch):
    """fcn16s from live params (its variant read from the decoder): the
    serving logits are the port's forward."""
    params = bridge.to_port(_tree(4, 5, variant="fcn16s", **TINY))
    out = ti.export_tf_savedmodel(params, str(tmp_path / "sm"), num_classes=5, **TINY)
    image = np.random.default_rng(1).integers(0, 255, (1, 64, 96, 3), np.uint8)
    served = tf.saved_model.load(out).signatures["serving_default"](image=tf.constant(image))
    stats = ph.compare_logits(served["logits"].numpy(), ph.torch_forward(params, image))
    assert stats["max_rel_diff"] < 1e-4 and stats["argmax_agreement"] > 0.999, stats
    with pytest.raises(ValueError, match="num_classes"):
        ti.export_tf_savedmodel(params, str(tmp_path / "x"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ti.load_tf_savedmodel_params(out, params)
    assert ti.REFERENCE_DECONV_NAMES == jti.REFERENCE_DECONV_NAMES


def test_interop_cli_usage(capsys):
    assert ti.main([]) == 1
    assert "export" in capsys.readouterr().out
