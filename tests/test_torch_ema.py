"""PyTorch port, the EMA of the weights (``train(ema_decay=...)``,
``use_ema``, ``adopt_ema``, checkpoints) against the JAX package on the CPU.

A narrow fp32 model (``width_mult=1/32, fc_channels=32``, 3 classes) on
32x64 batches at keep_prob 1, both packages started from one JAX param tree
whose decoder is redrawn at unit fan-in scale (as in
tests/test_torch_train.py), so the logits are far from ties. Tolerances:

* the EMA update fed the same params in both packages: 1e-6 relative to
  the update's terms, ``1e-6 * (|ema| + |p|)`` per element (the same fp32
  formula; PyTorch may fuse ``ema * d + p * (1 - d)`` into one FMA, and
  where the two terms cancel the rounding is of their size, not of the
  result's);
* after trained steps the EMA is a convex combination of the param iterates,
  so per element it may differ from JAX's by no more than the largest
  param gap of the iterates (the train steps' own gradient rounding, see
  tests/test_torch_train.py) plus that bound;
* ``use_ema`` predict and evaluate on the same EMA (a JAX checkpoint loaded
  in the port): ids exact, metrics within 1e-5 relative;
* a resumed run against the uninterrupted one in the same package: atol
  1e-6, as tests/test_ema.py holds JAX.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.schedules import constant  # noqa: E402

C = 3
SMALL = dict(width_mult=1 / 32, fc_channels=32)
DECAY = 0.75
LR = 1e-3


@functools.cache
def _tree():
    tree = jax.tree.map(np.array, jax.jit(lambda k: j_init(k, C, **SMALL))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = rng.normal(size=layer["bias"].shape).astype(np.float32) * 0.1
    return tree


def _batch(seed=1, n=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 32, 64, 3), dtype=np.uint8),
            rng.integers(0, C, (n, 32, 64)).astype(np.uint8))


def _repeat(images, labels):
    while True:
        yield images, labels


def _jax_model():
    jm = JFCN8s(num_classes=C, compute_dtype=jnp.float32, **SMALL)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree()))
    return jm


def _port_model():
    return FCN8s.from_params(_tree(), compute_dtype=torch.float32, device="cpu", **SMALL)


def _train(model, steps=1, **kw):
    model.train(_repeat(*_batch()), epochs=1, steps_per_epoch=steps,
                learning_rate_schedule=constant(LR), keep_prob=1.0, metrics=set(),
                eval_frequency=10**9, record_summaries=False, ema_decay=DECAY, **kw)


def _jtree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _ttree(tree):
    return jax.tree.map(np.copy, bridge.to_numpy(tree))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _bound(prev_ema, params):
    """The rounding bound of one EMA update, per element."""
    return 1e-6 * (np.abs(prev_ema) + np.abs(params)) + 1e-30


@pytest.fixture(scope="module")
def trained():
    """Both packages, three steps with ``ema_decay`` from the same tree (one
    ``train`` call each: the EMA persists across calls), with the largest
    param gap of each element over the three iterates."""
    jm, tm = _jax_model(), _port_model()
    gap = None
    for _ in range(3):
        _train(jm)
        _train(tm)
        step_gap = jax.tree.map(lambda a, b: np.abs(a - b), _jtree(jm.state.params),
                                _ttree(tm.params))
        gap = step_gap if gap is None else jax.tree.map(np.maximum, gap, step_gap)
    return jm, tm, gap


def test_ema_update_matches_jax_on_the_same_params():
    """Both ``_update_ema``s fed the same three param trees: the seed copy,
    then two updates."""
    rng = np.random.default_rng(5)
    trees = [jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05).astype(np.float32),
                          _tree()) for _ in range(3)]
    j = types.SimpleNamespace(_ema_params=None, _ema_fn=None, state=None)
    t = types.SimpleNamespace(_ema=None, _ema_run=None, params=None)
    for i, tree in enumerate(trees):
        prev = _jtree(j._ema_params) if i else None
        j.state = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, tree))
        JFCN8s._update_ema(j, DECAY)
        t.params = bridge.to_port(tree)
        FCN8s._update_ema(t, DECAY)
        if prev is None:  # the seed is a copy
            jax.tree.map(np.testing.assert_array_equal, _ttree(t._ema), tree)
            continue
        for (path, want), got, e, p in zip(_leaves(_jtree(j._ema_params)),
                                           jax.tree.leaves(_ttree(t._ema)),
                                           jax.tree.leaves(prev), jax.tree.leaves(tree)):
            assert (np.abs(got - want) <= _bound(e, p)).all(), jax.tree_util.keystr(path)
        assert any((a != b).any() for a, b in zip(jax.tree.leaves(_ttree(t._ema)),
                                                  jax.tree.leaves(tree)))


def test_ema_after_three_steps_matches_jax(trained):
    jm, tm, gap = trained
    want, got = _jtree(jm.ema_params), _ttree(tm.ema_params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    params = _jtree(jm.state.params)
    for path, w in _leaves(want):
        def at(tree):
            return functools.reduce(lambda x, k: x[k.key], path, tree)
        err = np.abs(at(got) - w)
        # the recurrence's roundings stay within three updates' bounds
        assert (err <= at(gap) + 3 * _bound(w, at(params))).all(), jax.tree_util.keystr(path)
    assert max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(got),
                                                           jax.tree.leaves(_ttree(tm.params)))) > 0


def test_use_ema_predict_evaluate_and_adopt_match_jax(trained, tmp_path):
    """A JAX checkpoint with an EMA, loaded in the port, holds JAX's EMA
    exactly; ``predict``/``evaluate(use_ema=True)`` and ``adopt_ema`` then
    agree with JAX's on it."""
    jm, _, _ = trained
    path = jm.save(str(tmp_path), force_save=True)
    tm = FCN8s(model_load_dir=path, device="cpu")
    for (p, a), b in zip(_leaves(_jtree(jm.ema_params)), jax.tree.leaves(_ttree(tm.ema_params))):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(p))
    images, labels = _batch(2, n=3)
    np.testing.assert_array_equal(tm.predict(images, use_ema=True),
                                  jm.predict(images, use_ema=True))
    assert not np.array_equal(tm.predict(images, argmax=False),
                              tm.predict(images, argmax=False, use_ema=True))
    kw = dict(num_batches=1, metrics={"loss", "mean_iou", "accuracy"}, dataset="train",
              use_ema=True)
    want = jm.evaluate(_repeat(images, labels), **kw)
    got = tm.evaluate(_repeat(images, labels), **kw)
    for name in want:
        np.testing.assert_allclose(got[name], float(want[name]), rtol=1e-5, err_msg=name)

    averaged = tm.predict(images, argmax=False, use_ema=True)
    tm.variables_updated = False
    tm.adopt_ema()
    assert tm.variables_updated
    jl = JFCN8s(model_load_dir=path)
    jl.adopt_ema()
    for (p, a), b in zip(_leaves(_jtree(jl.state.params)), jax.tree.leaves(_ttree(tm.params))):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(p))
    np.testing.assert_allclose(tm.predict(images, argmax=False), averaged, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="No EMA params"):
        tm.ema_params  # noqa: B018
    assert tm.state.opt_state is not None or tm._staged_opt_state is not None  # kept


def test_ema_checkpoints_continue_across_packages(trained, tmp_path):
    """A JAX-written EMA continues in the port, and the port's in JAX: one
    more step of each from the same checkpoint keeps the EMAs within the
    param gap of that step."""
    jm, tm, _ = trained
    jpath = jm.save(str(tmp_path / "jax"), force_save=True)
    tpath = tm.save(str(tmp_path / "port"), force_save=True)
    from_jax = FCN8s(model_load_dir=jpath, device="cpu")
    from_port = JFCN8s(model_load_dir=tpath)
    for (p, a), b in zip(_leaves(_jtree(from_port._ema_params)),
                         jax.tree.leaves(_ttree(tm.ema_params))):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))
    for a_model, b_model in ((jm, from_jax), (from_port, tm)):
        prev = _jtree(a_model.ema_params)
        _train(a_model)
        _train(b_model)
        want, got = _jtree(a_model.ema_params), _ttree(b_model.ema_params)
        params = _jtree(a_model.state.params)
        gap = jax.tree.map(lambda x, y: np.abs(x - y), params, _ttree(b_model.params))
        for (path, w), g, d, e, p in zip(_leaves(want), jax.tree.leaves(got),
                                         jax.tree.leaves(gap), jax.tree.leaves(prev),
                                         jax.tree.leaves(params)):
            assert (np.abs(g - w) <= (1 - DECAY) * d + _bound(e, p)).all(), \
                jax.tree_util.keystr(path)
        assert a_model.g_step == int(b_model.state.step) == 4


# ---------------------------------------------------------------------------
# tests/test_ema.py, on the port
# ---------------------------------------------------------------------------


def test_ema_recurrence_matches_numpy_replay():
    model = _port_model()
    _train(model)
    p1, e1 = _ttree(model.params), _ttree(model.ema_params)
    jax.tree.map(np.testing.assert_array_equal, e1, p1)
    _train(model)  # persists across train() calls
    p2 = _ttree(model.params)
    expected = jax.tree.map(lambda e, p: e * np.float32(DECAY) + p * np.float32(1 - DECAY), e1, p2)
    actual = _ttree(model.ema_params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-6), actual, expected)
    assert max(float(np.abs(a - p).max())
               for a, p in zip(jax.tree.leaves(actual), jax.tree.leaves(p2))) > 0


def test_use_ema_serving_and_adopt():
    model = _port_model()
    images, labels = _batch()
    _train(model, steps=3)
    averaged = model.predict(images, argmax=False, use_ema=True)
    ema_tree = _ttree(model.ema_params)
    vals = model.evaluate(_repeat(images, labels), num_batches=1, metrics={"loss", "accuracy"},
                          dataset="train", use_ema=True)
    assert {"loss", "accuracy"} <= set(vals)
    model.adopt_ema()
    assert model.variables_updated
    jax.tree.map(np.testing.assert_array_equal, _ttree(model.params), ema_tree)
    np.testing.assert_allclose(model.predict(images, argmax=False), averaged, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="No EMA params"):
        model.ema_params  # noqa: B018
    _train(model)  # training on after adoption re-seeds the average
    jax.tree.map(np.testing.assert_array_equal, _ttree(model.ema_params), _ttree(model.params))


def test_ema_checkpoint_roundtrip(tmp_path):
    """A resumed train(ema_decay=...) continues the running average; the
    async save carries it (snapshotted on the device); a checkpoint without
    one restores with no EMA."""
    ref = _port_model()
    _train(ref, steps=3)
    ref_ema = _ttree(ref.ema_params)

    model = _port_model()
    _train(model, steps=2)
    saved_ema = _ttree(model.ema_params)
    model.save(str(tmp_path), force_save=True)
    resumed = FCN8s.resume(str(tmp_path), device="cpu")
    assert resumed.compute_dtype == model.compute_dtype
    jax.tree.map(np.testing.assert_array_equal, _ttree(resumed.ema_params), saved_ema)
    _train(resumed)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-6),
                 _ttree(resumed.ema_params), ref_ema)

    resumed.save(str(tmp_path), name="async", force_save=True, block=False)
    snapshot = _ttree(resumed.ema_params)
    _train(resumed)  # moves the average in place while the writer may still run
    resumed._join_pending_save()
    again = FCN8s.resume(str(tmp_path), device="cpu")
    jax.tree.map(np.testing.assert_array_equal, _ttree(again.ema_params), snapshot)

    plain = _port_model()
    plain.train(_repeat(*_batch()), epochs=1, steps_per_epoch=1,
                learning_rate_schedule=constant(LR), keep_prob=1.0, record_summaries=False)
    loaded = FCN8s(model_load_dir=plain.save(str(tmp_path / "plain"), force_save=True),
                   device="cpu")
    with pytest.raises(ValueError, match="No EMA params"):
        loaded.predict(_batch()[0], use_ema=True)


def test_ema_validation():
    model = _port_model()
    images, labels = _batch()
    with pytest.raises(ValueError, match="No EMA params"):
        model.predict(images, use_ema=True)
    with pytest.raises(ValueError, match="No EMA params"):
        model.evaluate(_repeat(images, labels), 1, use_ema=True)
    with pytest.raises(ValueError, match="ema_decay"):
        model.train(_repeat(images, labels), epochs=1, steps_per_epoch=1,
                    learning_rate_schedule=constant(1e-3), metrics=set(), eval_frequency=10**9,
                    record_summaries=False, ema_decay=1.5)
    _train(model)
    with pytest.raises(ValueError, match="mutually exclusive"):
        model.predict(images, use_ema=True, quantized=True)
