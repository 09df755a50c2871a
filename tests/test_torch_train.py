"""PyTorch port, the training path against the JAX package on the CPU.

A narrow fp32 model (``width_mult=1/32, fc_channels=32``) on 64x64 inputs
at ``keep_prob=1``, with the same numpy weights and batches handed to both
packages. JAX's ``train_step`` runs jitted with ``use_pallas_ce=False``
(its composite XLA loss); the port's runs its kernels' plain twins, as it
does for any CPU tensor. Gradients are read out of JAX's step through an
optimizer that stores them as its state (``_grad_capture``), one jitted
reference per loss branch. Tolerances, with their reasons:

* losses: rtol 1e-5 (summation order);
* gradients: ``atol = 1e-4 * max|g|`` of each leaf, ``rtol = 1e-4``: XLA:CPU
  and oneDNN sum the convolutions and their transposes in different orders;
* optimizers fed identical gradients: rtol 1e-6, atol 1e-7 (fp32 rounding
  of the same formula, the clip norm summed in another leaf order);
* one Adam step: where ``|g| > 1e-3 * max|g|`` of the leaf the update is
  lr * sign(g) up to fp32 rounding, so the params agree to ``1e-3 * lr``;
  elsewhere a near-zero gradient's sign is noise, and only Adam's bound
  (``|update| <= lr``) is held.
"""

import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.models.fcn8s import decoder_l2_loss as j_l2  # noqa: E402
from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu.ops import losses as jlosses  # noqa: E402
from fcn8s_tensorflow_tpu.ops.metrics import empty_metrics_state as j_empty  # noqa: E402
from fcn8s_tensorflow_tpu.parallel import steps as jsteps  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.data.prefetch import DevicePrefetcher  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.fcn8s import apply_fcn8s as t_apply  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.fcn8s import decoder_l2_loss as t_l2  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import losses as tlosses  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.metrics import empty_metrics_state as t_empty  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.nn import dropout, dropout_mask  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 5
N = 4
SMALL = dict(width_mult=1 / 32, fc_channels=32)
CLASS_WEIGHTS = (0.5, 1.0, 2.0, 0.0, 1.5)


@functools.cache
def _tree(seed=0):
    """A JAX-initialised numpy tree whose decoder kernels are redrawn at
    unit fan-in scale, so the decoder's gradients are not 1e-3-sigma
    small. Cached: callers only read it."""
    init = jax.jit(lambda key: j_init(key, C, **SMALL))
    tree = jax.tree.map(np.array, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = rng.normal(size=layer["bias"].shape).astype(np.float32) * 0.1
    return tree


def _batch(seed=1, ignore_share=0.0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (N, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (N, 64, 64)).astype(np.uint8)
    if ignore_share:
        labels[rng.random(labels.shape) < ignore_share] = 255
    return images, labels


def _grad_capture():
    """An optax transformation whose state after ``update`` is the gradient
    itself (and whose update is zero), wrapped like ``make_optimizer``'s so
    JAX's ``train_step`` can set its learning rate."""

    def factory(learning_rate):
        del learning_rate

        def update(updates, state, params=None):
            return jax.tree.map(jnp.zeros_like, updates), updates

        return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), update)

    return optax.inject_hyperparams(factory)(learning_rate=0.0)


@functools.cache
def _jax_step(optimizer_name, grad_accum=1, ignore_label=None, class_weights=None):
    optimizer = _grad_capture() if optimizer_name == "capture" else jsteps.make_optimizer(
        optimizer_name)
    fn = functools.partial(jsteps.train_step, optimizer=optimizer, num_classes=C,
                           compute_dtype=jnp.float32, use_pallas_ce=False,
                           grad_accum=grad_accum, ignore_label=ignore_label,
                           class_weights=class_weights)
    return optimizer, jax.jit(fn)


def _jax_train(optimizer_name, images, labels, mask, lr=1e-3, l2=0.01, **kw):
    optimizer, step = _jax_step(optimizer_name, **kw)
    state = jsteps.create_train_state(jax.tree.map(jnp.asarray, _tree()), optimizer)
    state, loss = step(state, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mask),
                       jax.random.PRNGKey(0), lr, l2, 1.0)
    return state, float(loss)


def _grad_tree(params, grads):
    """The port's gradient list as a JAX-layout numpy tree."""
    it = iter(grads)
    tree = {part: {name: {k: next(it) for k in layer} for name, layer in layers.items()}
            for part, layers in params.items()}
    return bridge.to_numpy(tree)


BRANCHES = {
    "per_sample": dict(mask=(1, 1, 1, 1)),
    "sample_mask": dict(mask=(1, 0, 1, 1)),
    "grad_accum": dict(mask=(1, 1, 1, 0), grad_accum=2),
    "ignore_label": dict(mask=(1, 1, 0, 1), ignore_label=255, ignore_share=0.3),
    "class_weights": dict(mask=(1, 1, 1, 1), class_weights=CLASS_WEIGHTS),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_loss_and_grads_match_jax_train_step(branch):
    """Every gradient leaf, the deconv kernels through the subpixel tap
    algebra included, and the loss (CE + 0.01 * decoder L2) of the port's
    step against JAX's jitted ``train_step`` on the same weights and batch."""
    cfg = dict(BRANCHES[branch])
    mask = np.asarray(cfg.pop("mask"), np.float32)
    images, labels = _batch(ignore_share=cfg.pop("ignore_share", 0.0))
    state, want_loss = _jax_train("capture", images, labels, mask, **cfg)
    want = jax.tree.map(np.asarray, state.opt_state.inner_state)
    params = bridge.to_port(_tree())
    tsteps.create_train_state(params, tsteps.make_optimizer("sgd"))
    loss, grads = tsteps.loss_and_grads(
        params, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(mask),
        seed=0, step=0, l2_rate=0.01, keep_prob=1.0, compute_dtype=torch.float32, **cfg)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = _grad_tree(params, grads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = functools.reduce(lambda t, k: t[k.key], path, want)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def test_adam_train_step_matches_jax():
    """One TF1-Adam ``train_step`` of each package from the same weights."""
    images, labels = _batch()
    mask = np.ones(N, np.float32)
    lr = 1e-3
    grad_state, _ = _jax_train("capture", images, labels, mask, lr=lr)
    grads = jax.tree.map(np.asarray, grad_state.opt_state.inner_state)
    state, want_loss = _jax_train("adam", images, labels, mask, lr=lr)
    params = bridge.to_port(_tree())
    tstate = tsteps.create_train_state(params, tsteps.make_optimizer("adam"))
    tstate, loss = tsteps.train_step(
        tstate, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(mask),
        0, lr, 0.01, 1.0, optimizer=tsteps.make_optimizer("adam"), num_classes=C,
        compute_dtype=torch.float32)
    assert tstate.step == 1
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got, want = bridge.to_numpy(tstate.params), jax.tree.map(np.asarray, state.params)
    before = _tree()
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        def at(tree):
            return functools.reduce(lambda t, k: t[k.key], path, tree)
        grad = at(grads)
        clear = np.abs(grad) > 1e-3 * np.abs(grad).max()
        np.testing.assert_allclose(g[clear], at(want)[clear], rtol=0, atol=1e-3 * lr,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.abs(g - at(before)).max() <= lr * (1 + 1e-5)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


OPTIMIZER_CASES = {
    "adam": ("adam", None, {}),
    "adam_clip": ("adam", 0.5, {"b1": 0.8, "eps": 1e-6}),
    "adamw": ("adamw", None, {"weight_decay": 1e-2}),
    "momentum": ("momentum", None, {"momentum": 0.8}),
    "nesterov": ("momentum", 1.0, {"nesterov": True}),
    "sgd": ("sgd", None, {}),
}


@pytest.mark.parametrize("case", list(OPTIMIZER_CASES))
def test_optimizers_match_jax(case):
    """Three steps fed identical numpy gradients, with a learning rate that
    changes per step, through ``make_optimizer`` of both packages."""
    name, clip, hyper = OPTIMIZER_CASES[case]
    rng = np.random.default_rng(3)
    shapes = {"encoder": {"a": {"weight": (4, 3, 3, 3), "bias": (4,)}},
              "decoder": {"b": {"kernel": (4, 4, 2, 2), "bias": (2,)}}}
    tree = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
             for _ in range(3)]
    jopt = jsteps.make_optimizer(name, clip_norm=clip, **hyper)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    topt = tsteps.make_optimizer(name, clip_norm=clip, **hyper)
    tparams = jax.tree.map(torch.tensor, tree)
    tstate = topt.init(tparams)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jstate = jsteps._set_lr(jstate, lr)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.apply(tparams, [torch.tensor(a) for a in jax.tree.leaves(g)], tstate, lr)
    for got, want in zip(jax.tree.leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_make_optimizer_validates_like_jax():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tsteps.make_optimizer("rmsprop")
    with pytest.raises(ValueError, match="unknown kwargs"):
        tsteps.make_optimizer("sgd", momentum=0.9)
    with pytest.raises(ValueError, match="unknown kwargs"):
        tsteps.make_optimizer("adam", weight_decay=1e-4)
    assert tsteps.make_optimizer("AdamW", weight_decay=1e-3).name == "adamw"


# ---------------------------------------------------------------------------
# losses and L2
# ---------------------------------------------------------------------------


def test_losses_match_jax(rng):
    logits = rng.normal(size=(2, 8, 8, C)).astype(np.float32) * 2
    labels = rng.integers(0, C, (2, 8, 8)).astype(np.int32)
    labels[0, :2] = 255
    mask = np.array([1.0, 0.0], np.float32)
    tl, tb, tm = torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask)
    jl, jb, jm = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)
    in_range = np.where(labels == 255, 0, labels)
    np.testing.assert_allclose(
        float(tlosses.mean_softmax_cross_entropy(tl, torch.from_numpy(in_range))),
        float(jlosses.mean_softmax_cross_entropy(jl, jnp.asarray(in_range))), rtol=1e-6)
    vw = tlosses.valid_pixel_weights(tb, tm, 255)
    np.testing.assert_array_equal(vw.numpy(), np.asarray(jlosses.valid_pixel_weights(jb, jm, 255)))
    for ignore in (255, None):
        ids = tb if ignore is not None else torch.from_numpy(in_range)
        jids = jb if ignore is not None else jnp.asarray(in_range)
        cw = tlosses.class_pixel_weights(ids, tm, CLASS_WEIGHTS, ignore)
        np.testing.assert_array_equal(
            cw.numpy(), np.asarray(jlosses.class_pixel_weights(jids, jm, CLASS_WEIGHTS, ignore)))
        np.testing.assert_allclose(
            float(tlosses.masked_mean_softmax_cross_entropy(tl, ids, cw)),
            float(jlosses.masked_mean_softmax_cross_entropy(jl, jids, jnp.asarray(cw.numpy()))),
            rtol=1e-6)
    one_hot = np.eye(C, dtype=np.float32)[in_range]
    np.testing.assert_allclose(
        tlosses.softmax_cross_entropy_one_hot(tl, torch.from_numpy(one_hot)).numpy(),
        np.asarray(jlosses.softmax_cross_entropy_one_hot(jl, jnp.asarray(one_hot))), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("counts", [[10, 0, 30, 5, 20], [7, 7, 1, 0, 0, 4], [0, 0, 0]])
def test_median_frequency_class_weights_match_jax(counts):
    np.testing.assert_allclose(
        tlosses.median_frequency_class_weights(counts).numpy(),
        np.asarray(jlosses.median_frequency_class_weights(jnp.asarray(counts))), rtol=1e-6)


def test_decoder_l2_loss_matches_jax():
    tree = _tree()
    got = t_l2(bridge.to_port(tree)["decoder"])
    want = j_l2(jax.tree.map(jnp.asarray, tree["decoder"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_eval_step_ignore_label_and_class_weights_match_jax():
    images, labels = _batch(ignore_share=0.2)
    mask = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    run = bridge.cast_params(bridge.to_port(_tree()), torch.float32)
    for kw in (dict(ignore_label=255), dict(ignore_label=255, class_weights=CLASS_WEIGHTS)):
        js = jsteps.eval_step(jax.tree.map(jnp.asarray, _tree()), j_empty(C), jnp.asarray(images),
                              jnp.asarray(labels), jnp.asarray(mask), num_classes=C,
                              compute_dtype=jnp.float32, use_pallas_ce=False, **kw)
        with torch.inference_mode():
            ts = tsteps.eval_step(run, t_empty(C), torch.from_numpy(images),
                                  torch.from_numpy(labels), torch.from_numpy(mask),
                                  num_classes=C, compute_dtype=torch.float32, **kw)
        np.testing.assert_allclose(float(ts["loss_sum"]), float(js["loss_sum"]), rtol=1e-5)
        np.testing.assert_array_equal(ts["conf_matrix"].numpy(), np.asarray(js["conf_matrix"]))


# ---------------------------------------------------------------------------
# port-only: dropout, remat, the facade
# ---------------------------------------------------------------------------


def test_dropout_keeps_scales_and_repeats():
    x = torch.full((4, 16, 8, 8), 3.0).contiguous(memory_format=torch.channels_last)
    for keep in (0.5, 0.8):
        mask = dropout_mask(x.shape, keep, tsteps.dropout_generator("cpu", 7, 3))
        y = dropout(x, keep, mask)
        kept = y != 0
        assert abs(float(kept.float().mean()) - keep) < 0.03
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 3.0 / keep))
        again = dropout(x, keep, dropout_mask(x.shape, keep, tsteps.dropout_generator("cpu", 7, 3)))
        assert torch.equal(y, again)
        other = dropout(x, keep, dropout_mask(x.shape, keep, tsteps.dropout_generator("cpu", 7, 4)))
        assert not torch.equal(y, other)
        assert y.is_contiguous(memory_format=torch.channels_last)
    assert dropout(x, 1.0, None) is x


def test_remat_gradients_equal_at_keep_prob_half():
    """With the same seed and step, ``remat`` recomputes the same dropout
    masks and the same activations, so every gradient matches."""
    images, labels = _batch()
    mask = torch.ones(N)
    params = bridge.to_port(_tree())
    tsteps.create_train_state(params, tsteps.make_optimizer("sgd"))
    runs = [tsteps.loss_and_grads(params, torch.from_numpy(images), torch.from_numpy(labels),
                                  mask, seed=5, step=2, l2_rate=0.0, keep_prob=0.5,
                                  compute_dtype=torch.float32, remat=remat)
            for remat in (False, True)]
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    deterministic = tsteps.loss_and_grads(
        params, torch.from_numpy(images), torch.from_numpy(labels), mask, seed=5, step=2,
        l2_rate=0.0, keep_prob=1.0, compute_dtype=torch.float32)[0]
    assert not torch.equal(l0, deterministic)  # the masks did drop units


def _stream(seed=4, n=N):
    rng = np.random.default_rng(seed)
    while True:
        yield (rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8),
               rng.integers(0, C, (n, 64, 64)).astype(np.uint8))


def test_facade_train_then_predict_uses_new_weights(tmp_path):
    """Two steps of ``FCN8s.train`` move the masters; ``predict`` afterwards
    runs the new weights (its cache was rebuilt), evaluation ran on 'val',
    and the train log has one record per epoch."""
    model = FCN8s.from_params(_tree(), compute_dtype=torch.float32, device="cpu", **SMALL)
    images = next(_stream(9))[0][:2]
    before = model.predict(images, argmax=False)
    w0 = model.params["decoder"]["fc7_1x1"]["weight"].detach().clone()
    log = tmp_path / "train.jsonl"
    model.train(_stream(), epochs=2, steps_per_epoch=1, learning_rate_schedule=lambda s: 1e-3,
                keep_prob=0.5, metrics={"loss", "mean_iou"}, eval_dataset="val",
                val_generator=_stream(5, n=2), val_steps=1, eval_frequency=1,
                record_summaries=False, train_log=str(log), gradient_accumulation=3)
    assert model.g_step == model.state.step == 2
    assert not torch.equal(model.params["decoder"]["fc7_1x1"]["weight"], w0)
    with torch.inference_mode():
        want = torch.softmax(t_apply(bridge.cast_params(model.params, torch.float32),
                                     torch.from_numpy(images), compute_dtype=torch.float32), -1)
    after = model.predict(images, argmax=False)
    np.testing.assert_allclose(after, want.numpy(), rtol=1e-6, atol=1e-7)
    assert np.abs(after - before).max() > 0
    assert np.isfinite(model.training_loss) and len(model.metric_values) == 2
    assert model.best_metric_values[0] <= model.metric_values[0]
    records = [line for line in log.read_text().splitlines() if line]
    assert len(records) == 2 and '"eval_loss"' in records[1]


@pytest.mark.parametrize("option", [
    # saving during training is ported; an unported option beside it still
    # raises before any step runs or anything is written
    dict(save_during_training=True, save_dir="x", early_stopping=2),
    dict(record_summaries=True, summaries_dir="x"),
    dict(device_augment={"flip": 0.5}), dict(ema_decay=0.9), dict(spatial_partition=True),
    dict(early_stopping=2), dict(reduce_lr_on_plateau=2)])
def test_train_options_not_ported_raise(option):
    model = FCN8s(num_classes=C, compute_dtype=torch.float32, device="cpu", **SMALL)
    kw = dict(record_summaries=False)
    kw.update(option)
    with pytest.raises(NotImplementedError):
        model.train(_stream(), 1, 1, lambda s: 1e-4, **kw)
    with pytest.raises(ValueError, match="summaries_dir"):
        model.train(_stream(), 1, 1, lambda s: 1e-4)  # JAX's own check comes first


def test_prefetcher_yields_in_order_and_closes():
    batches = [(np.full((2, 3), i, np.int32),) for i in range(5)]
    pre = DevicePrefetcher(iter(batches), "cpu", depth=2)
    assert [int(next(pre)[0][0, 0]) for _ in range(3)] == [0, 1, 2]
    pre.close()
    assert not pre._thread.is_alive()
    assert [int(b[0][0, 0]) for b in DevicePrefetcher(iter(batches), "cpu")] == list(range(5))


def test_train_path_imports_no_jax():
    """In a fresh interpreter, two steps of ``FCN8s.train`` with prefetch
    leave ``jax`` and the JAX package out of ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
        torch.set_num_threads(1)
        model = FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32,
                      compute_dtype=torch.float32, ignore_label=255, device="cpu")
        rng = np.random.default_rng(0)
        batches = iter([(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
                         rng.integers(0, 3, (2, 32, 32), dtype=np.uint8))] * 2)
        model.train(batches, 1, 2, lambda s: 1e-3, record_summaries=False, prefetch=1)
        assert np.isfinite(model.training_loss)
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
