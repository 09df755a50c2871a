"""PyTorch port, ``torch.export`` serving artifacts against the JAX package
on the CPU.

A narrow model (``width_mult=1/32, fc_channels=32``, fp32) on 64x96 inputs,
its decoder redrawn at unit fan-in scale so that ids have margins, the same
numpy weights in both packages. Tolerances:

* the port's artifact against the port's ``predict``: exact (the same
  functions on the same inputs);
* against the JAX package's StableHLO artifact: ids equal wherever JAX's
  top-2 margin exceeds ``1e-3 * max|logits|`` and on >= 99.9% of pixels,
  softmax within ``rtol = 1e-4, atol = 1e-4 * max|logits|``
  (``tests/test_torch_model.py``'s: XLA:CPU and oneDNN sum the convolutions
  in different orders).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.engine.export import load_serving_artifact as j_load  # noqa: E402
from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu.models.fcn8s import apply_fcn8s as j_apply  # noqa: E402
from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine import checkpoint as ckpt  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.export import load_serving_artifact  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402

C = 5
SMALL = dict(width_mult=1 / 32, fc_channels=32)
HW = (64, 96)


@functools.cache
def _tree():
    init = jax.jit(lambda key: j_init(key, C, **SMALL))
    tree = jax.tree.map(np.array, init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = rng.normal(size=layer["bias"].shape).astype(np.float32) * 0.1
    return tree


def _port_model():
    return FCN8s.from_params(_tree(), device="cpu", compute_dtype=torch.float32, **SMALL)


@pytest.fixture(scope="module")
def model():
    return _port_model()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(11).integers(0, 256, (3,) + HW + (3,), dtype=np.uint8)


@pytest.fixture(scope="module")
def artifacts(model, tmp_path_factory):
    """{argmax: port artifact directory}, exported once at batch 2."""
    return {argmax: model.export_serving(str(tmp_path_factory.mktemp(f"art_{argmax}")),
                                         input_hw=HW, argmax=argmax)
            for argmax in (True, False)}


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    jm = JFCN8s(num_classes=C, compute_dtype=jnp.float32, mesh=create_mesh(data=1, model=1),
                **SMALL)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree()))
    return {argmax: jm.export_serving(str(tmp_path_factory.mktemp(f"jart_{argmax}")),
                                      input_hw=HW, argmax=argmax)
            for argmax in (True, False)}


@pytest.mark.parametrize("argmax", [True, False])
def test_artifact_equals_predict(model, artifacts, images, argmax):
    art = load_serving_artifact(artifacts[argmax], device="cpu")
    got = art.predict(images)
    want = model.predict(images, argmax=argmax)
    assert got.dtype == (np.int32 if argmax else np.float32) and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("argmax", [True, False])
def test_artifact_agrees_with_the_jax_artifact(artifacts, jax_artifacts, images, argmax):
    got = load_serving_artifact(artifacts[argmax], device="cpu").predict(images)
    want = j_load(jax_artifacts[argmax]).predict(images)
    assert got.dtype == want.dtype and got.shape == want.shape
    logits = np.asarray(j_apply(jax.tree.map(jnp.asarray, _tree()), jnp.asarray(images),
                                compute_dtype=jnp.float32))
    if argmax:
        top2 = np.sort(logits, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 1e-3 * np.abs(logits).max()
        np.testing.assert_array_equal(got[clear], want[clear])
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(logits).max())


@pytest.mark.parametrize("n", [1, 3])
def test_symbolic_batch(model, artifacts, images, n):
    """Exported at batch 2, the artifact runs at batch 1 and 3 (and takes
    an (H, W, 3) image)."""
    art = load_serving_artifact(artifacts[True], device="cpu")
    np.testing.assert_array_equal(art.predict(images[:n]), model.predict(images[:n]))
    assert art.predict(images[0]).shape == (1,) + HW


def test_graph_holds_the_registered_pool_op(artifacts):
    """Five K4f calls as ``fcn8s_torch::maxpool2x2_nhwc`` nodes, and no
    other max pool: the artifact carries the kernel op, not its twin. The
    program keeps no example inputs: the params live in ``params/`` only."""
    for directory in artifacts.values():
        program = torch.export.load(os.path.join(directory, "forward.pt2"))
        assert program.example_inputs is None
        targets = [str(node.target) for node in program.graph.nodes
                   if node.op == "call_function"]
        assert targets.count("fcn8s_torch.maxpool2x2_nhwc.default") == 5
        assert not [t for t in targets if "max_pool" in t]


def test_params_checkpoint_is_the_jax_format(model, artifacts):
    """``params/`` holds the live fp32 params in the JAX package's layout."""
    tree, meta = ckpt.load_params_tree(os.path.join(artifacts[True], "params"))
    assert meta["model_config"]["num_classes"] == C
    want = bridge.to_numpy(model.params)
    for got, ref in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, ref)
    from fcn8s_tensorflow_tpu.engine.checkpoint import load_params_tree as j_load_params

    jtree, _ = j_load_params(os.path.join(artifacts[True], "params"))
    for got, ref in zip(jax.tree.leaves(jtree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(got), ref)


def test_manifest_keys(artifacts, jax_artifacts):
    with open(os.path.join(artifacts[True], "manifest.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax_artifacts[True], "manifest.json")) as f:
        want = json.load(f)
    assert set(got) == set(want) | {"format", "device"}
    assert got["format"] == "torch.export" and got["device"] == "cpu"
    for key in ("artifact_version", "input_hw", "argmax", "id_dtype", "num_classes",
                "compute_dtype", "ema"):
        assert got[key] == want[key], key


def test_wrong_resolution_raises(artifacts, images):
    art = load_serving_artifact(artifacts[True], device="cpu")
    with pytest.raises(ValueError, match="exported for"):
        art.predict(images[:, : HW[0] // 2])


def test_input_hw_not_divisible_by_32_raises(model, tmp_path):
    with pytest.raises(ValueError, match="divisible by 32"):
        model.export_serving(str(tmp_path / "a"), input_hw=(64, 80))


def test_version_and_manifest_guards(artifacts, tmp_path):
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        load_serving_artifact(str(tmp_path), device="cpu")
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(os.path.join(artifacts[True], "manifest.json")) as f:
        manifest = json.load(f)
    manifest["artifact_version"] = 999
    (bad / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="artifact_version"):
        load_serving_artifact(str(bad), device="cpu")


def test_jax_artifact_raises_naming_the_format(jax_artifacts):
    with pytest.raises(ValueError, match="jax.export StableHLO"):
        load_serving_artifact(jax_artifacts[True], device="cpu")


def test_other_device_raises_naming_both(artifacts):
    """A CPU-traced artifact asked to run on the card raises before it
    needs one, naming both devices."""
    with pytest.raises(ValueError, match="traced on cpu.*asked for cuda"):
        load_serving_artifact(artifacts[True], device="cuda")


def test_ema_export_uses_the_average(tmp_path):
    model = _port_model()
    rng = np.random.default_rng(0)
    im = rng.integers(0, 256, (2, 32, 32, 3), np.uint8)
    lb = rng.integers(0, C, (2, 32, 32)).astype(np.uint8)

    def gen():
        while True:
            yield im, lb

    model.train(gen(), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-3,
                record_summaries=False, ema_decay=0.5)
    out = model.export_serving(str(tmp_path / "ema"), input_hw=(32, 32), argmax=False,
                               use_ema=True)
    got = load_serving_artifact(out, device="cpu").predict(im)
    np.testing.assert_array_equal(got, model.predict(im, argmax=False, use_ema=True))
    assert not np.array_equal(got, model.predict(im, argmax=False))
    model.close()
