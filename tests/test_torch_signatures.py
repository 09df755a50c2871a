"""PyTorch port, the call forms of the JAX package that the port had lost:
the facade's positional constructor, ``ema_params=`` on the checkpoint
writers, ``normalize=`` on the encoders and the calibration pass,
``variant=``/``subpixel=`` on the decoder, and ``conv2d_transpose``,
``space_to_depth_labels`` and ``native_available``. Each is run in both
packages on the same numpy inputs. Tolerances: fp32 forwards as the
model tests hold them (rtol 1e-4, atol 1e-4 of the largest logit:
XLA:CPU and oneDNN sum convolutions in different orders); files byte for
byte; integer layouts exactly.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fcn8s_tensorflow_tpu.engine import checkpoint as jckpt  # noqa: E402
from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu.evaluation import confmat as jconfmat  # noqa: E402
from fcn8s_tensorflow_tpu.models import fcn8s as jfcn  # noqa: E402
from fcn8s_tensorflow_tpu.models import vgg16 as jvgg  # noqa: E402
from fcn8s_tensorflow_tpu.ops import nn as jnn  # noqa: E402
from fcn8s_tensorflow_tpu.ops import quantize as JQ  # noqa: E402
from fcn8s_tensorflow_tpu.ops import subpixel as jsub  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine import checkpoint as tckpt  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.evaluation import confmat as tconfmat  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models import fcn8s as tfcn  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models import vgg16 as tvgg  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import nn as tnn  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import quantize as TQ  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import subpixel as tsub  # noqa: E402

C = 5
SMALL = dict(width_mult=1 / 32, fc_channels=32)
F32 = dict(compute_dtype=jnp.float32)
TF32 = dict(compute_dtype=torch.float32)


@functools.cache
def _tree(variant="fcn8s"):
    init = jax.jit(lambda key: jfcn.init_fcn8s(key, C, variant=variant, **SMALL))
    tree = jax.tree.map(np.array, init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for layer in tree["decoder"].values():  # unit fan-in scale: logits well apart
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
    return tree


def _images(seed=1, n=2, h=64, w=64):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# the facade's constructor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A small JAX checkpoint, for the positional ``FCN8s(ckpt_dir)``."""
    jm = JFCN8s(num_classes=C, **SMALL, **F32)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree()))
    path = jm.save(str(tmp_path_factory.mktemp("ckpt")), force_save=True)
    jm.close()
    return path


def _leaves(tree):
    return {"/".join(p): v for p, v in _flat(tree)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("form", ["keywords", "positional", "checkpoint"])
def test_constructor_call_forms_of_the_jax_facade(form, ckpt_dir):
    """``FCN8s(model_load_dir=None, tags=None, num_classes=C)`` (the
    migration guide's form), ``FCN8s(None, None, None, C)`` and
    ``FCN8s(ckpt_dir)`` build the same model in both packages."""
    args, kwargs = {
        "keywords": ((), dict(model_load_dir=None, tags=None, num_classes=C, **SMALL)),
        "positional": ((None, None, None, C), dict(SMALL)),
        "checkpoint": ((ckpt_dir,), {}),
    }[form]
    jm = JFCN8s(*args, **kwargs)
    model = FCN8s(*args, **kwargs, device="cpu")
    assert model.num_classes == jm.num_classes == C
    assert model.model_config["width_mult"] == jm.model_config["width_mult"]
    assert model.model_config["fc_channels"] == jm.model_config["fc_channels"]
    got = bridge.to_numpy(model.params)
    assert jax.tree.structure(got) == jax.tree.structure(jm.state.params)
    if form == "checkpoint":
        for path, want in _leaves(jm.state.params).items():
            np.testing.assert_array_equal(_leaves(got)[path], want, err_msg=path)
    else:
        for path, want in _leaves(jm.state.params).items():
            assert _leaves(got)[path].shape == want.shape, path
    jm.close()


def test_constructor_keeps_device_and_mesh_keyword_only():
    import inspect

    params = inspect.signature(FCN8s.__init__).parameters
    jparams = inspect.signature(JFCN8s.__init__).parameters
    positional = [n for n, p in params.items() if p.kind == p.POSITIONAL_OR_KEYWORD][1:]
    assert positional == [n for n, p in jparams.items()
                          if p.kind == p.POSITIONAL_OR_KEYWORD][1:]
    for name in ("mesh", "tensor_parallel", "device"):
        assert params[name].kind == params[name].KEYWORD_ONLY
    with pytest.raises(TypeError):
        FCN8s(None, None, None, C, None, "cpu")


# ---------------------------------------------------------------------------
# checkpoints: ema_params=
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["save_checkpoint", "save_checkpoint_async"])
def test_checkpoint_writers_take_ema_params(tmp_path, writer):
    """A bare params tree with its EMA average: both packages write the
    same bytes."""
    tree = _tree()
    ema = jax.tree.map(lambda x: x * np.float32(0.5), tree)
    meta = {"model_config": {"num_classes": C}}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for mod, directory, params, avg in (
            (jckpt, jdir, jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, ema)),
            (tckpt, tdir, bridge.to_port(tree), bridge.to_port(ema))):
        out = getattr(mod, writer)(directory, params, meta, ema_params=avg)
        if writer == "save_checkpoint_async":
            out.join()
    for name in ("checkpoint.msgpack", "metadata.json"):
        with open(os.path.join(jdir, name), "rb") as f, open(os.path.join(tdir, name), "rb") as g:
            assert f.read() == g.read(), name
    got = tckpt.load_checkpoint(tdir)["ema"]
    for path, want in _leaves(ema).items():
        np.testing.assert_array_equal(_leaves(bridge.to_numpy(got))[path], want)


# ---------------------------------------------------------------------------
# the forwards: normalize=, variant=, subpixel=
# ---------------------------------------------------------------------------


def test_apply_vgg16_normalize_false_matches_jax():
    tree, images = _tree(), _images()
    want = jax.jit(lambda p, x: jvgg.apply_vgg16(p, x, normalize=False, **F32))(
        tree["encoder"], jnp.asarray(images))
    run = bridge.cast_params(bridge.to_port(tree), torch.float32)
    with torch.no_grad():
        got = tvgg.apply_vgg16(run["encoder"], torch.from_numpy(images), normalize=False, **TF32)
        plain = tvgg.apply_vgg16(run["encoder"], torch.from_numpy(images), **TF32)
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
    assert not np.allclose(_nhwc(plain[2]), _nhwc(got[2]))


@pytest.mark.parametrize("variant", ["fcn8s", "fcn16s", "fcn32s"])
@pytest.mark.parametrize("normalize", [True, False])
def test_apply_fcn8s_variant_and_normalize_match_jax(variant, normalize):
    tree, images = _tree(variant), _images()
    want = jax.jit(lambda p, x: jfcn.apply_fcn8s(p, x, normalize=normalize, variant=variant,
                                                 **F32))(tree, jnp.asarray(images))
    with torch.no_grad():
        got = tfcn.apply_fcn8s(bridge.cast_params(bridge.to_port(tree), torch.float32),
                               torch.from_numpy(images), normalize=normalize, variant=variant,
                               **TF32)
    _close(got, want)


@pytest.mark.parametrize("variant", ["fcn8s", "fcn16s", "fcn32s"])
def test_decoder_subpixel_false_matches_jax(variant):
    """``subpixel=False`` runs JAX's input-dilated deconvs on the master
    kernels; it agrees with JAX's own and with the subpixel rewrite."""
    tree = _tree(variant)
    rng = np.random.default_rng(2)
    enc = tree["encoder"]
    taps = [rng.normal(size=(2, s, s, enc[name]["kernel"].shape[-1])).astype(np.float32)
            for name, s in (("conv3_3", 8), ("conv4_3", 4), ("fc7", 2))]
    want = jfcn.apply_fcn8s_decoder(tree["decoder"], *map(jnp.asarray, taps), subpixel=False,
                                    variant=variant, **F32)
    masters = bridge.to_port(tree)["decoder"]
    nchw = [torch.from_numpy(t).permute(0, 3, 1, 2) for t in taps]
    with torch.no_grad():
        got = tfcn.apply_fcn8s_decoder(masters, *nchw, subpixel=False, variant=variant, **TF32)
        rewrite = tfcn.apply_fcn8s_decoder(masters, *nchw, variant=variant, **TF32)
        cast = bridge.cast_params({"decoder": masters}, torch.float32)["decoder"]
        with pytest.raises(ValueError, match="subpixel=False"):
            tfcn.apply_fcn8s_decoder(cast, *nchw, subpixel=False, **TF32)
    _close(got, want)
    _close(rewrite, got.numpy())


@pytest.mark.parametrize("stage", ["vgg16_int8", "fcn8s_int8", "absmax"])
def test_int8_entry_points_take_normalize_false(stage):
    tree, images = _tree(), _images()
    jx = jnp.asarray(images)
    if stage == "absmax":
        want = jax.jit(lambda p, x: JQ.collect_activation_absmax(p, x, normalize=False, **F32))(
            tree, jx)
        got = TQ.collect_activation_absmax(bridge.to_port(tree), torch.from_numpy(images),
                                           normalize=False, **TF32)
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5)
        return
    jq = jax.tree.map(np.asarray, jax.jit(JQ.quantize_fcn8s_params)(tree, None))
    tq = bridge.quantized_to_port(jq, torch.float32)
    with torch.inference_mode():
        if stage == "vgg16_int8":
            want = jax.jit(lambda q, x: JQ.apply_vgg16_int8(q, x, normalize=False, **F32))(
                jq["encoder_q"], jx)
            got = TQ.apply_vgg16_int8(tq["encoder_q"], torch.from_numpy(images),
                                      normalize=False, **TF32)
            for g, w in zip(got, want):
                _close(_nhwc(g), w)
        else:
            want = jax.jit(lambda q, x: JQ.apply_fcn8s_int8(q, x, normalize=False, **F32))(
                jq, jx)
            got = TQ.apply_fcn8s_int8(tq, torch.from_numpy(images), normalize=False, **TF32)
            _close(got, want)


# ---------------------------------------------------------------------------
# the functions the port had not ported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,s,cin,cout", [(4, 2, 3, 5), (16, 8, 5, 5), (3, 2, 2, 4),
                                          (2, 3, 3, 2)])
def test_conv2d_transpose_matches_jax(k, s, cin, cout):
    rng = np.random.default_rng(k * 10 + s)
    x = rng.normal(size=(2, 5, 6, cin)).astype(np.float32)
    kernel = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    want = jnn.conv2d_transpose(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                                strides=(s, s))
    got = tnn.conv2d_transpose(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.from_numpy(kernel), torch.from_numpy(bias), strides=(s, s))
    assert got.shape == (2, cout, 5 * s, 6 * s)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("s", [2, 8])
def test_space_to_depth_labels_matches_jax(s):
    labels = np.random.default_rng(s).integers(0, 255, (2, 32, 48), dtype=np.uint8)
    want = np.asarray(jsub.space_to_depth_labels(jnp.asarray(labels), s))
    got = tsub.space_to_depth_labels(torch.from_numpy(labels), s)
    np.testing.assert_array_equal(got.numpy(), want)


def test_space_to_depth_labels_pair_with_the_packed_logits():
    """The packed CE of ``packed_final`` logits against the packed labels is
    the plain CE (the JAX test's pairing, ``tests/test_subpixel.py``)."""
    from fcn8s_tensorflow_tpu_torch.ops.losses import mean_softmax_cross_entropy

    tree, images = _tree(), _images()
    labels = torch.from_numpy(np.random.default_rng(3).integers(0, C, (2, 64, 64)))
    run = bridge.cast_params(bridge.to_port(tree), torch.float32)
    with torch.no_grad():
        full = tfcn.apply_fcn8s(run, torch.from_numpy(images), **TF32)
        packed = tfcn.apply_fcn8s(run, torch.from_numpy(images), packed_final=True, **TF32)
    np.testing.assert_allclose(
        float(mean_softmax_cross_entropy(packed, tsub.space_to_depth_labels(labels, 8))),
        float(mean_softmax_cross_entropy(full, labels)), rtol=1e-6)


def test_native_available_reports_the_build(monkeypatch, tmp_path):
    """True where g++ builds the library (JAX's binding agrees where its
    Makefile's build is present); False, without raising, when the
    compiler is missing."""
    assert tconfmat.native_available() is True
    if jconfmat.native_available():
        assert tconfmat.native_available() == jconfmat.native_available()
    monkeypatch.setattr(tconfmat, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    tconfmat.library.cache_clear()
    try:
        assert tconfmat.native_available() is False
    finally:
        tconfmat.library.cache_clear()
