"""PyTorch port, checkpoints: the msgpack codec against flax, checkpoints
crossing between the two packages, and the facade's persistence.

Narrow models (``width_mult=1/32, fc_channels=32``, 3 classes, fp32) on
32x64 batches at keep_prob 1. Tolerances: the codec is byte-identical to
flax and decodes to equal values; a checkpoint read by the other package
restores params, step and optimizer state exactly (fp32 values are copied,
never recomputed); predicted ids are equal; one more training step from the
same checkpoint in both packages matches as in
tests/test_torch_train.py::test_loss_and_grads_match_jax_train_step (loss
rtol 1e-5; gradients, read back from Adam's first moment, rtol 1e-4 and
atol 1e-4 * max|g| per leaf).
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.engine import checkpoint as jck  # noqa: E402
from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu.parallel import steps as jsteps  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine import checkpoint as tck  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine import msgpack as tmsgpack  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 3
SMALL = dict(width_mult=1 / 32, fc_channels=32)


def _batch(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 32, 64, 3), dtype=np.uint8),
            rng.integers(0, C, (n, 32, 64)).astype(np.uint8))


def _repeat(images, labels):
    while True:
        yield images, labels


def _train_kw(steps=2, lr=1e-3):
    return dict(epochs=1, steps_per_epoch=steps, learning_rate_schedule=lambda s: lr,
                keep_prob=1.0, record_summaries=False)


def _port_tree(params, tensors):
    """A list aligned with ``bridge.param_leaves(params)`` as a JAX-layout
    numpy tree."""
    it = iter(tensors)
    return bridge.to_numpy({part: {name: {k: next(it) for k in layer}
                                   for name, layer in layers.items()}
                            for part, layers in params.items()})


def _numpy_params(params):
    """A copy of a port tree as a JAX-layout numpy tree (``to_numpy`` shares
    the memory of CPU biases, which the optimizer updates in place)."""
    return jax.tree.map(np.copy, bridge.to_numpy(params))


def _assert_trees_equal(got, want):
    """Equal structure and exactly equal leaves (numpy trees)."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def _adam_inner(opt_state):
    """The ScaleByAdamTF1State in a JAX ``make_optimizer`` state."""
    return next(s for s in opt_state.inner_state if isinstance(s, jsteps.ScaleByAdamTF1State))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _payloads():
    rng = np.random.default_rng(0)
    f32 = functools.partial(lambda shape: rng.standard_normal(shape).astype(np.float32))
    return {
        "checkpoint_like": {"step": np.asarray(7, np.int32),
                            "params_leaves": [f32((2,)), f32((3, 3, 4, 5)), _bf16(f32((4, 6)))],
                            "opt_leaves": [np.asarray(2, np.int32), np.asarray(1e-3, np.float32),
                                           f32((300,)), np.arange(17, dtype=np.uint8)],
                            "ema_leaves": []},
        "nested": {"z": 1, "a": {"y": [1.5, None, True, False, "word" * 20, -5, 300, -300,
                                       2**40, -2**40, 70000, "é"]},
                   "m": np.float32(2.5), "empty": [], "zero": np.zeros((0, 3), np.float32)},
        "long_list": {"params_leaves": [np.asarray(i, np.int64) for i in range(40)]},
    }


@pytest.mark.parametrize("name", list(_payloads()))
def test_msgpack_bytes_equal_flax(name):
    payload = _payloads()[name]
    want = serialization.msgpack_serialize(payload)
    assert tmsgpack.packb(payload) == want
    torch_leaves = jax.tree.map(lambda a: torch.from_numpy(np.array(a)) if isinstance(
        a, np.ndarray) and a.dtype.name != "bfloat16" else a, payload)
    assert tmsgpack.packb(torch_leaves) == want  # tensors encode as their arrays do


def _assert_decoded_equal(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_decoded_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_decoded_equal(a, b)
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", list(_payloads()))
def test_msgpack_decodes_flax_bytes_as_msgpack_restore(name):
    data = serialization.msgpack_serialize(_payloads()[name])
    got = tmsgpack.unpackb(data)
    _assert_decoded_equal(got, serialization.msgpack_restore(data))
    assert tmsgpack.packb(got) == data  # and re-encodes to the same bytes


def test_msgpack_rejects_unknown_ext_dtype_and_huge_arrays():
    array_ext = tmsgpack.packb({"a": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="extension type 5"):
        tmsgpack.unpackb(array_ext.replace(b"\xc7\x15\x01", b"\xc7\x15\x05"))
    with pytest.raises(ValueError, match="dtype 'flaat32'"):
        tmsgpack.unpackb(array_ext.replace(b"float32", b"flaat32"))
    with pytest.raises(ValueError, match="unknown format byte"):
        tmsgpack.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="trailing"):
        tmsgpack.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="dtype"):
        tmsgpack.packb([np.zeros(2, np.complex64)])
    with pytest.raises(TypeError):
        tmsgpack.packb([object()])
    huge = np.lib.stride_tricks.as_strided(np.zeros(1, np.uint8), shape=(2**32,), strides=(0,))
    with pytest.raises(ValueError, match="4 GiB"):  # checked before any byte is copied
        tmsgpack.packb([huge])


# ---------------------------------------------------------------------------
# optimizer state across packages, every optimizer
# ---------------------------------------------------------------------------

OPTIMIZERS = [(name, clip) for name in ("adam", "adamw", "momentum", "sgd") for clip in (None, 0.5)]


@functools.cache
def _jax_tree():
    return jax.tree.map(np.array, jax.jit(lambda k: j_init(k, C, **SMALL))(jax.random.PRNGKey(0)))


def _config(name, clip):
    return {"num_classes": C, **SMALL, "variant": "fcn8s", "ignore_label": None,
            "compute_dtype": "float32", "optimizer": name, "optimizer_kwargs": None,
            "clip_norm": clip}


@pytest.mark.parametrize("name,clip", OPTIMIZERS)
def test_port_optimizer_state_loads_in_jax(name, clip, tmp_path):
    """Two port updates with random gradients, saved by the port: JAX's
    ``load_checkpoint`` takes the leaves into its own example tree, equal."""
    opt = tsteps.make_optimizer(name, clip_norm=clip)
    params = bridge.to_port(_jax_tree())
    state = tsteps.create_train_state(params, opt)
    rng = np.random.default_rng(1)
    for lr in (1e-3, 2e-3):
        grads = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
                 for t in bridge.param_leaves(params)]
        opt.apply(params, grads, state.opt_state, lr)
    state.step = 2
    tck.save_checkpoint(str(tmp_path), state, {"model_config": _config(name, clip)})
    jopt = jsteps.make_optimizer(name, clip_norm=clip)
    jparams = jax.tree.map(jnp.asarray, _jax_tree())
    example = {"step": jnp.zeros((), jnp.int32), "params": jparams,
               "opt_state": jopt.init(jparams)}
    got = jck.load_checkpoint(str(tmp_path), example)
    _assert_trees_equal(jax.tree.map(np.asarray, got["params"]), bridge.to_numpy(params))
    assert int(got["step"]) == 2
    ostate = got["opt_state"]
    assert int(ostate.count) == 2 and ostate.count.dtype == np.int32
    assert float(ostate.hyperparams["learning_rate"]) == np.float32(2e-3)
    inner = state.opt_state.inner
    if name in ("adam", "adamw"):
        adam = _adam_inner(ostate)
        assert int(adam.count) == inner.count == 2
        _assert_trees_equal(jax.tree.map(np.asarray, adam.mu), _port_tree(params, inner.mu))
        _assert_trees_equal(jax.tree.map(np.asarray, adam.nu), _port_tree(params, inner.nu))
    elif name == "momentum":
        trace = next(s for s in ostate.inner_state if hasattr(s, "trace")).trace
        _assert_trees_equal(jax.tree.map(np.asarray, trace), _port_tree(params, inner))


@pytest.mark.parametrize("name,clip", OPTIMIZERS)
def test_jax_optimizer_state_loads_in_port(name, clip, tmp_path):
    """Two JAX updates with random gradients, saved by the JAX package: the
    port restores params, step, the inject count and learning rate and the
    rule's state exactly, and writes the same payload bytes back."""
    jopt = jsteps.make_optimizer(name, clip_norm=clip)
    jparams = jax.tree.map(jnp.asarray, _jax_tree())
    ostate = jopt.init(jparams)
    rng = np.random.default_rng(2)

    @jax.jit
    def step(params, opt_state, grads, lr):
        updates, opt_state = jopt.update(grads, jsteps._set_lr(opt_state, lr), params)
        return jax.tree.map(lambda p, u: p + u, params, updates), opt_state

    for lr in (1e-3, 2e-3):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
                             jparams)
        jparams, ostate = step(jparams, ostate, grads, lr)
    jstate = jsteps.TrainState(step=jnp.asarray(2, jnp.int32), params=jparams, opt_state=ostate)
    jck.save_checkpoint(str(tmp_path / "jax"), jstate, {"model_config": _config(name, clip)})
    got = tck.load_checkpoint(str(tmp_path / "jax"), tsteps.make_optimizer(name, clip_norm=clip))
    params = got["params"]
    _assert_trees_equal(bridge.to_numpy(params), jax.tree.map(np.asarray, jparams))
    opt = got["opt_state"]
    assert got["step"] == 2 and opt.count == 2 and opt.learning_rate == float(np.float32(2e-3))
    if name in ("adam", "adamw"):
        adam = _adam_inner(ostate)
        assert opt.inner.count == 2
        _assert_trees_equal(_port_tree(params, opt.inner.mu), jax.tree.map(np.asarray, adam.mu))
        _assert_trees_equal(_port_tree(params, opt.inner.nu), jax.tree.map(np.asarray, adam.nu))
    elif name == "momentum":
        trace = next(s for s in ostate.inner_state if hasattr(s, "trace")).trace
        _assert_trees_equal(_port_tree(params, opt.inner), jax.tree.map(np.asarray, trace))
    else:
        assert opt.inner is None
    back = tsteps.TrainState(step=got["step"], params=params, opt_state=opt)
    tck.save_checkpoint(str(tmp_path / "port"), back, {"model_config": _config(name, clip)})
    payload = "checkpoint.msgpack"
    assert ((tmp_path / "port" / payload).read_bytes() == (tmp_path / "jax" / payload).read_bytes())


def test_optimizer_leaf_count_mismatch_raises(tmp_path):
    state = tsteps.create_train_state(bridge.to_port(_jax_tree()), tsteps.make_optimizer("sgd"))
    tck.save_checkpoint(str(tmp_path), state, {"model_config": _config("sgd", None)})
    with pytest.raises(ValueError, match="optimizer config mismatch"):
        tck.load_checkpoint(str(tmp_path), tsteps.make_optimizer("adam"))


# ---------------------------------------------------------------------------
# whole models across packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A narrow JAX ``FCN8s`` trained 2 steps at keep_prob 1, saved."""
    model = JFCN8s(num_classes=C, compute_dtype=jnp.float32, **SMALL)
    images, labels = _batch()
    model.train(_repeat(images, labels), **_train_kw())
    path = model.save(str(tmp_path_factory.mktemp("jax_ckpt")))
    return model, path


def test_jax_checkpoint_loads_in_port_exactly(jax_checkpoint):
    jm, path = jax_checkpoint
    tm = FCN8s(model_load_dir=path, device="cpu")
    assert tm.compute_dtype == torch.float32 and tm.model_config == jm.model_config
    assert tm.state.step == tm.g_step == int(jm.state.step) == 2
    _assert_trees_equal(bridge.to_numpy(tm.params), jax.tree.map(np.asarray, jm.state.params))
    staged = tm._staged_opt_state  # on the host until the first train()
    adam = _adam_inner(jm.state.opt_state)
    assert staged.count == int(jm.state.opt_state.count) and staged.inner.count == int(adam.count)
    assert all(t.device.type == "cpu" for t in staged.inner.mu)
    _assert_trees_equal(_port_tree(tm.params, staged.inner.mu), jax.tree.map(np.asarray, adam.mu))
    _assert_trees_equal(_port_tree(tm.params, staged.inner.nu), jax.tree.map(np.asarray, adam.nu))
    images = _batch(5)[0]
    np.testing.assert_array_equal(tm.predict(images), jm.predict(images))


def test_one_more_step_from_a_jax_checkpoint_matches(jax_checkpoint, tmp_path):
    """Both packages load the same checkpoint and take one more Adam step on
    the same batch: the losses agree, and so do the step's gradients, read
    back from Adam's first moment (g = (mu' - b1 mu) / (1 - b1))."""
    _, path = jax_checkpoint
    images, labels = _batch(7)
    jm = JFCN8s(model_load_dir=path)
    mu0 = jax.tree.map(np.asarray, _adam_inner(jm.state.opt_state).mu)
    jm.train(_repeat(images, labels), **_train_kw(steps=1))
    tm = FCN8s(model_load_dir=path, device="cpu")
    tm.train(_repeat(images, labels), prefetch=0, **_train_kw(steps=1))
    assert tm.state.step == int(jm.state.step) == 3
    np.testing.assert_allclose(tm.training_loss, jm.training_loss, rtol=1e-5)
    mu_j = jax.tree.map(np.asarray, _adam_inner(jm.state.opt_state).mu)
    mu_t = _port_tree(tm.params, tm.state.opt_state.inner.mu)
    for (p, m0), mj, mt in zip(jax.tree_util.tree_leaves_with_path(mu0), jax.tree.leaves(mu_j),
                               jax.tree.leaves(mu_t)):
        gj, gt = (mj - 0.9 * m0) / 0.1, (mt - 0.9 * m0) / 0.1
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(p))


@pytest.fixture(scope="module")
def port_model():
    """A narrow port ``FCN8s`` trained 3 steps at keep_prob 1."""
    model = FCN8s(num_classes=C, compute_dtype=torch.float32, device="cpu", **SMALL)
    images, labels = _batch()
    model.train(_repeat(images, labels), prefetch=0, **_train_kw(steps=3))
    return model


def test_port_checkpoint_loads_in_jax_exactly(port_model, tmp_path):
    """The reverse: JAX's ``FCN8s(model_load_dir=...)`` restores the port's
    params, step and Adam state exactly and predicts the same ids; both
    packages' ``load_params_tree`` and ``describe_checkpoint`` agree."""
    port_model.variables_updated = True
    path = port_model.save(str(tmp_path))
    jm = JFCN8s(model_load_dir=path)
    assert int(jm.state.step) == 3 and jm.model_config == port_model.model_config
    _assert_trees_equal(jax.tree.map(np.asarray, jm.state.params),
                        bridge.to_numpy(port_model.params))
    opt = port_model.state.opt_state
    adam = _adam_inner(jm.state.opt_state)
    assert int(jm.state.opt_state.count) == opt.count == 3 and int(adam.count) == 3
    _assert_trees_equal(jax.tree.map(np.asarray, adam.mu),
                        _port_tree(port_model.params, opt.inner.mu))
    _assert_trees_equal(jax.tree.map(np.asarray, adam.nu),
                        _port_tree(port_model.params, opt.inner.nu))
    images = _batch(6)[0]
    np.testing.assert_array_equal(jm.predict(images), port_model.predict(images))
    tree_t, meta_t = tck.load_params_tree(path)
    tree_j, meta_j = jck.load_params_tree(path)
    _assert_trees_equal(tree_t, tree_j)
    assert meta_t == meta_j and meta_t["param_paths"][0] == "decoder/fc7_1x1/bias"
    assert tck.describe_checkpoint(path) == jck.describe_checkpoint(path)


def test_ema_leaves_and_train_observer_survive_a_port_load_and_save(jax_checkpoint, tmp_path):
    """A JAX checkpoint with an EMA average and observer counters passes
    through a port load and save unchanged: JAX reads both back."""
    jm, path = jax_checkpoint
    with open(os.path.join(path, "checkpoint.msgpack"), "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    raw["ema_leaves"] = [np.asarray(x) * np.float32(0.5) for x in raw["params_leaves"]]
    src = tmp_path / "with_ema"
    src.mkdir()
    (src / "checkpoint.msgpack").write_bytes(serialization.msgpack_serialize(raw))
    meta = tck.load_metadata(path)
    meta["train_observer"] = {"es_best": 0.25, "es_stale": 1}
    (src / "metadata.json").write_text(json.dumps(meta))
    tm = FCN8s(model_load_dir=str(src), device="cpu")
    out = tm.save(str(tmp_path / "out"), force_save=True)
    assert tck.load_metadata(out)["train_observer"] == {"es_best": 0.25, "es_stale": 1}
    with open(os.path.join(out, "checkpoint.msgpack"), "rb") as f:
        back = serialization.msgpack_restore(f.read())
    for a, b in zip(back["ema_leaves"], raw["ema_leaves"]):
        np.testing.assert_array_equal(a, b)
    jm2 = JFCN8s(model_load_dir=out)
    _assert_trees_equal(jax.tree.map(np.asarray, jm2._ema_params),
                        jax.tree.map(lambda p: np.asarray(p) * np.float32(0.5),
                                     jm.state.params))
    assert jm2._observer_state == {"es_best": 0.25, "es_stale": 1}


# ---------------------------------------------------------------------------
# the facade (counterparts of tests/test_engine.py's checkpoint tests)
# ---------------------------------------------------------------------------


def test_save_async_roundtrip(port_model, tmp_path):
    model = port_model
    images = _batch(3)[0]
    model.variables_updated = True
    path = model.save(str(tmp_path / "async"), block=False)
    assert model._save_thread is not None
    model._join_pending_save()
    assert os.path.isfile(os.path.join(path, "checkpoint.msgpack"))
    assert not os.path.isdir(path + ".tmp")  # rename completed
    reloaded = FCN8s(model_load_dir=path, device="cpu")
    np.testing.assert_array_equal(model.predict(images), reloaded.predict(images))
    model.variables_updated = True
    model.save(str(tmp_path / "async2"), block=False)  # joined by the next save
    model.save(str(tmp_path / "async2"), force_save=True)
    assert model._save_thread is None
    os.makedirs(str(tmp_path / "async3" / "x.tmp"))
    open(str(tmp_path / "async3" / "x.tmp" / "checkpoint.msgpack"), "wb").close()
    assert tck.latest_checkpoint(str(tmp_path / "async3")) is None


def test_save_dirty_flag(port_model, tmp_path):
    port_model.variables_updated = False
    assert port_model.save(str(tmp_path / "x")) is None  # no-op skip
    assert port_model.save(str(tmp_path / "x"), force_save=True) is not None


def test_resume_from_latest(port_model, tmp_path):
    port_model.save(str(tmp_path / "r"), force_save=True)
    resumed = FCN8s.resume(str(tmp_path / "r"), device="cpu")
    assert resumed.state.step == port_model.state.step
    images = _batch(4)[0]
    np.testing.assert_array_equal(resumed.predict(images), port_model.predict(images))
    with pytest.raises(FileNotFoundError):
        FCN8s.resume(str(tmp_path / "nothing"), device="cpu")


def test_async_save_failure_surfaces(port_model, tmp_path, monkeypatch):
    """A failed background write raises at the join and re-arms the dirty
    flag."""
    port_model.variables_updated = True

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tck.os, "rename", boom)
    port_model.save(str(tmp_path / "will_fail"), block=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        port_model._join_pending_save()
    assert port_model.variables_updated
    assert port_model._save_thread is None


def test_describe_checkpoint(port_model, tmp_path):
    path = port_model.save(str(tmp_path / "d"), force_save=True)
    text = tck.describe_checkpoint(path)
    assert "model_config" in text and "encoder/conv1_1/kernel" in text
    assert "+ optimizer state" in text
    assert "checkpoint:" in tck.describe_checkpoint(str(tmp_path / "d"))  # parent -> latest
    with pytest.raises(FileNotFoundError):
        tck.describe_checkpoint(str(tmp_path / "nope"))


def test_checkpoint_format_version_enforced(port_model, tmp_path):
    path = port_model.save(str(tmp_path / "ver"), force_save=True)
    meta = tck.load_metadata(path)
    assert meta["format_version"] == tck.CHECKPOINT_FORMAT_VERSION == jck.CHECKPOINT_FORMAT_VERSION
    meta["format_version"] = tck.CHECKPOINT_FORMAT_VERSION + 1
    (tmp_path / "ver" / os.path.basename(path) / "metadata.json").write_text(json.dumps(meta))
    example = bridge.to_numpy(port_model.params)
    with pytest.raises(ValueError, match="format_version"):
        tck.load_params_only(path, example)
    with pytest.raises(ValueError, match="format_version"):
        FCN8s(model_load_dir=path, device="cpu")
    del meta["format_version"]  # pre-versioning checkpoints load as v1
    (tmp_path / "ver" / os.path.basename(path) / "metadata.json").write_text(json.dumps(meta))
    tck.load_params_only(path, example)


def test_async_save_replaces_existing_checkpoint_safely(port_model, tmp_path):
    for _ in range(2):
        port_model.variables_updated = True
        target = port_model.save(str(tmp_path / "replace_me"), block=False)
        port_model._join_pending_save()
    assert os.path.isfile(os.path.join(target, "checkpoint.msgpack"))
    assert not os.path.isdir(target + ".tmp") and not os.path.isdir(target + ".old")
    images = _batch(4)[0]
    np.testing.assert_array_equal(port_model.predict(images),
                                  FCN8s(model_load_dir=target, device="cpu").predict(images))


def test_custom_optimizer_checkpoint_load_rejected(tmp_path):
    """``model_load_dir`` cannot rebuild a user-supplied optimizer; the error
    points at ``variables_load_dir``, which works."""
    custom = tsteps.make_optimizer("momentum", momentum=0.5)
    model = FCN8s(num_classes=C, optimizer=custom, compute_dtype=torch.float32, device="cpu",
                  **SMALL)
    images, labels = _batch()
    model.train(_repeat(images, labels), prefetch=0, **_train_kw(steps=1))
    model.save(str(tmp_path / "ckpt"))
    path = tck.latest_checkpoint(str(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="variables_load_dir"):
        FCN8s(model_load_dir=path, device="cpu")
    with pytest.raises(ValueError, match="variables_load_dir"):
        FCN8s(model_load_dir=path, optimizer=custom, device="cpu")
    m2 = FCN8s(num_classes=C, optimizer=custom, variables_load_dir=path,
               compute_dtype=torch.float32, device="cpu", **SMALL)
    np.testing.assert_array_equal(m2.predict(images), model.predict(images))


def test_load_variables_and_vgg16_dir_restore_by_path(port_model, tmp_path):
    """``load_variables`` replaces every param of a fresh model, keeping its
    optimizer state; ``vgg16_dir`` only the encoder's, the decoder staying
    fresh."""
    path = port_model.save(str(tmp_path / "vars"), force_save=True)
    images = _batch(8)[0]
    fresh = FCN8s(num_classes=C, seed=9, compute_dtype=torch.float32, device="cpu", **SMALL)
    before = _numpy_params(fresh.params)
    fresh.load_variables(path)
    _assert_trees_equal(bridge.to_numpy(fresh.params), bridge.to_numpy(port_model.params))
    np.testing.assert_array_equal(fresh.predict(images), port_model.predict(images))
    assert fresh.state.step == 0 and fresh.state.opt_state is None
    enc = FCN8s(num_classes=C, seed=9, vgg16_dir=path, compute_dtype=torch.float32,
                device="cpu", **SMALL)
    got = bridge.to_numpy(enc.params)
    _assert_trees_equal(got["encoder"], bridge.to_numpy(port_model.params)["encoder"])
    _assert_trees_equal(got["decoder"], before["decoder"])
    assert all(t.requires_grad for t in bridge.param_leaves(enc.params))


def test_train_saves_at_save_frequency_and_only_on_improvement(tmp_path):
    """``save_during_training`` writes every ``save_frequency`` epochs; with
    ``save_best_only`` (monitor 'loss', training loss) an epoch whose loss
    did not improve writes nothing."""
    images, labels = _batch()
    model = FCN8s(num_classes=C, compute_dtype=torch.float32, device="cpu", **SMALL)
    model.train(_repeat(images, labels), epochs=4, steps_per_epoch=1,
                learning_rate_schedule=lambda s: 1e-3, keep_prob=1.0, record_summaries=False,
                prefetch=0, save_during_training=True, save_dir=str(tmp_path / "all"),
                save_frequency=2, save_best_only=False)
    steps = sorted(tck.load_metadata(str(tmp_path / "all" / d))["global_step"]
                   for d in os.listdir(tmp_path / "all"))
    assert steps == [2, 4]
    assert model._save_thread is None  # train() joined its last save
    # lr 0 keeps the loss flat: after the first save nothing improves
    flat = FCN8s(num_classes=C, compute_dtype=torch.float32, device="cpu", **SMALL)
    flat.train(_repeat(images, labels), epochs=3, steps_per_epoch=1,
               learning_rate_schedule=lambda s: 0.0, keep_prob=1.0, record_summaries=False,
               prefetch=0, save_during_training=True, save_dir=str(tmp_path / "best"),
               save_frequency=1, save_best_only=True)
    steps = [tck.load_metadata(str(tmp_path / "best" / d))["global_step"]
             for d in os.listdir(tmp_path / "best")]
    assert steps == [1]


def test_async_snapshot_holds_the_state_at_the_call(tmp_path):
    """``save(block=False)`` and then two more in-place steps: the checkpoint
    holds the params and Adam moments of the call, not the later ones."""
    images, labels = _batch()
    model = FCN8s(num_classes=C, compute_dtype=torch.float32, device="cpu", **SMALL)
    model.train(_repeat(images, labels), prefetch=0, **_train_kw(steps=1))
    want_params = _numpy_params(model.params)
    want_mu = _port_tree(model.params, [t.clone() for t in model.state.opt_state.inner.mu])
    path = model.save(str(tmp_path), block=False)
    # the two steps run in place while the writer may still be writing
    model.train(_repeat(images, labels), prefetch=0, **_train_kw(steps=2))
    model._join_pending_save()
    assert not np.array_equal(bridge.to_numpy(model.params)["decoder"]["fc7_1x1"]["kernel"],
                              want_params["decoder"]["fc7_1x1"]["kernel"])
    got = tck.load_checkpoint(path, model.optimizer)
    assert got["step"] == 1 and got["opt_state"].count == 1
    _assert_trees_equal(bridge.to_numpy(got["params"]), want_params)
    _assert_trees_equal(_port_tree(got["params"], got["opt_state"].inner.mu), want_mu)


def test_persistence_imports_no_jax_flax_optax_or_msgpack(tmp_path):
    """In a fresh interpreter where ``jax``, ``flax``, ``optax`` and
    ``msgpack`` cannot be imported: the checkpoint and codec modules, KB's
    module, the mesh, the collectives, the VGG-16 import and the serving CLI
    import; a model trains, saves, reloads, is described by the checkpoint
    CLI and served by the serving CLI on the CPU."""
    code = textwrap.dedent(f"""
        import runpy, sys, json, urllib.request, threading
        for name in ("jax", "flax", "optax", "msgpack"):
            sys.modules[name] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from fcn8s_tensorflow_tpu_torch.engine import checkpoint, msgpack, serving
        from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
        from fcn8s_tensorflow_tpu_torch.ops import conv1_core
        from fcn8s_tensorflow_tpu_torch.models import import_vgg16
        from fcn8s_tensorflow_tpu_torch.parallel import collectives, mesh
        model = FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32,
                      compute_dtype=torch.float32, device="cpu")
        rng = np.random.default_rng(0)
        batch = (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
                 rng.integers(0, 3, (2, 32, 32), dtype=np.uint8))
        model.train(iter([batch] * 2), 1, 2, lambda s: 1e-3, record_summaries=False)
        path = model.save({str(tmp_path)!r}, block=False)
        model.close()
        again = FCN8s(model_load_dir=path, device="cpu")
        assert again.state.step == 2
        sys.argv = ["checkpoint", path]
        runpy.run_module("fcn8s_tensorflow_tpu_torch.engine.checkpoint", run_name="__main__")
        server = serving.main([path, "0", "--device", "cpu"], serve=False)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = "http://127.0.0.1:%d/healthz" % server.server_address[1]
        with urllib.request.urlopen(url, timeout=60) as r:
            assert json.loads(r.read())["model_config"]["num_classes"] == 3
        server.shutdown(); server.server_close(); server.service.close()
        banned = sorted(m for m in sys.modules if sys.modules[m] is not None and
                        m.split(".")[0] in ("jax", "flax", "optax", "msgpack",
                                            "fcn8s_tensorflow_tpu"))
        assert not banned, banned
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "encoder/conv1_1/kernel" in proc.stdout  # the checkpoint CLI's description
    assert proc.stdout.strip().endswith("ok")
