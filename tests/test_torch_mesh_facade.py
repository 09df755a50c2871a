"""PyTorch port, the facade on a mesh: ``FCN8s(mesh=..., tensor_parallel=True)``
in a gloo group of 4 CPU processes on the (2, 2) mesh, against the JAX
facade on its 8-device virtual mesh of the same shape, on the same numpy
weights. The group runner and the tolerances are ``test_torch_mesh.py``'s:

* training (momentum, two steps on batches of 3 and 4, padded to the
  'data' axis, with an EMA): the loss rtol 1e-5, the params rtol 2e-4,
  atol 1e-6 (momentum's first steps are linear in the gradient, as SGD's);
* evaluate: loss rtol 1e-5, the confusion matrix up to the pixels within
  JAX's probability margin; predict, tiled predict: ids where the margin
  is clear, at least 99.9% overall; predict_tta, calibrated int8 predict:
  probabilities rtol 1e-4, atol 1e-4 (the int8 tests' tolerance);
* the LR finder's losses: rtol 1e-4 over three SGD-like steps;
* checkpoints: the mesh's file is byte for byte the mesh-less save of the
  same state, and both facades load each other's.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine import checkpoint as ckpt  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.export import load_serving_artifact  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel.steps import make_optimizer  # noqa: E402
from tests.test_torch_mesh import (  # noqa: E402
    BATCHES,
    C,
    L2,
    LR,
    SMALL,
    _tree,
    assert_conf_agree,
    assert_ids_agree,
    assert_params_close,
    launch,
)

SHAPE = (2, 2)
TRAIN = ["pad3", "b4b"]
EVAL = ["b4", "pad3"]
OPT = "momentum"
EMA = 0.9


def _images(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


IMAGES = _images(5, 3, 50, 70)
FRAME = _images(6, 2, 100, 150)
TILE = dict(tile=(64, 64), tile_overlap=32)
TTA = dict(scales=(1.0, 0.75), flip=True)


def _gen(names):
    return iter([(im[:int(mk.sum())], lb[:int(mk.sum())])
                 for im, lb, mk in (BATCHES[n] for n in names)])


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX facade on the (2, 2) mesh with tensor parallelism: the
    results the port's group is held against, and a checkpoint of it."""
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s
    from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh

    root = tmp_path_factory.mktemp("jax")
    mesh = create_mesh(*SHAPE, devices=jax.devices()[:4])
    jm = JFCN8s(num_classes=C, mesh=mesh, tensor_parallel=True, compute_dtype=jnp.float32,
                optimizer=OPT, **SMALL)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree()))
    out = {"lr": jm.find_learning_rate(_gen(TRAIN + TRAIN), min_lr=1e-4, max_lr=1e-2,
                                       steps=3)}
    jm.train(_gen(TRAIN), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: LR,
             keep_prob=1.0, l2_regularization=L2, metrics=set(), record_summaries=False,
             prefetch=0, ema_decay=EMA)
    out["train_loss"] = jm.training_loss
    out["params"] = jax.tree.map(np.asarray, jm.state.params)
    out["evaluate"] = jm.evaluate(_gen(EVAL), len(EVAL))
    # the JAX facade keeps no confusion matrix: count its predict's ids
    real = [(BATCHES[n][0][:int(BATCHES[n][2].sum())], BATCHES[n][1][:int(BATCHES[n][2].sum())])
            for n in EVAL]
    gt = np.concatenate([lb for _, lb in real]).astype(np.int64)
    pred = np.concatenate([jm.predict(im) for im, _ in real]).astype(np.int64)
    out["conf"] = np.bincount((gt * C + pred).ravel(), minlength=C * C).reshape(C, C)
    out["eval_probs"] = np.concatenate([jm.predict(im, argmax=False) for im, _ in real])
    out["probs"] = jm.predict(IMAGES, argmax=False)
    out["ids"] = jm.predict(IMAGES)
    out["tile_probs"] = jm.predict(FRAME, argmax=False, **TILE)
    out["tile_ids"] = jm.predict(FRAME, **TILE)
    out["tta"] = jm.predict_tta(IMAGES, argmax=False, **TTA)
    out["ckpt"] = jm.save(str(root), force_save=True)
    jm.close()
    # int8 replicates its params in both packages; the JAX facade's quantized
    # predict under tensor_parallel=True fails on its own sharding check, so
    # JAX's int8 side runs on the same (2, 2) mesh without it
    jq = JFCN8s(num_classes=C, mesh=mesh, compute_dtype=jnp.float32, **SMALL)
    jq.state = jq.state._replace(params=jax.tree.map(jnp.asarray, out["params"]))
    jq.calibrate_quantization(IMAGES, batch_size=2)
    out["int8"] = jq.predict(IMAGES, argmax=False, quantized=True)
    jq.close()
    return out


@pytest.fixture(scope="module")
def port_side(tmp_path_factory, jax_side):
    """The port's facade in a group of 4 on the (2, 2) mesh with tensor
    parallelism: the same calls, then the JAX checkpoint loaded on the
    mesh."""
    root = tmp_path_factory.mktemp("port")
    calls = [("lr", TRAIN + TRAIN), ("train", TRAIN, dict(ema_decay=EMA)), ("evaluate", EVAL),
             ("predict", "probs", IMAGES, dict(argmax=False)),
             ("predict", "ids", IMAGES, {}),
             ("predict", "tile_ids", FRAME, TILE),
             ("tta", IMAGES, TTA),
             ("calibrate", IMAGES),
             ("predict", "int8", IMAGES, dict(argmax=False, quantized=True)),
             ("save", str(root / "saved")),
             ("predict_and_save", str(root / "pngs"), str(root / "images")),
             ("export", str(root / "artifact")),
             ("serve", IMAGES[0]),
             ("summaries", str(root / "tb"), ["b4"]),
             ("observers", ["b4", "b4b", "b4", "b4b", "b4", "b4b"])]
    os.makedirs(root / "images")
    from PIL import Image

    for i, image in enumerate(IMAGES):
        Image.fromarray(image).save(root / "images" / f"img{i}.png")
    jobs = {"facade": dict(kind="facade", mesh=SHAPE, tp=True, opt=OPT, calls=calls),
            "loaded": dict(kind="facade", mesh=SHAPE, tp=True, load=jax_side["ckpt"],
                           calls=[("predict", "ids", IMAGES, {}), ("params",)])}
    ranks = launch(root, 4, jobs)
    return {"ranks": ranks, "root": root}


def _every_rank(port_side, job="facade"):
    return [r[job] for r in port_side["ranks"]]


def test_facade_train_matches_jax(port_side, jax_side):
    for got in _every_rank(port_side):
        np.testing.assert_allclose(got["train_loss"], jax_side["train_loss"], rtol=1e-5)
        assert_params_close(got["params"], jax_side["params"])


def test_facade_evaluate_matches_jax(port_side, jax_side):
    for got in _every_rank(port_side):
        for k, v in jax_side["evaluate"].items():
            np.testing.assert_allclose(got["evaluate"][k], v, rtol=1e-5, atol=1e-3, err_msg=k)
        assert_conf_agree(got["conf"], jax_side["conf"], jax_side["eval_probs"])


@pytest.mark.parametrize("key,probs", [("ids", "probs"), ("tile_ids", "tile_probs")])
def test_facade_predict_and_tiled_predict_match_jax(port_side, jax_side, key, probs):
    for got in _every_rank(port_side):
        assert got[key].shape == jax_side[key].shape and got[key].dtype == np.int32
        assert_ids_agree(got[key], jax_side[key], jax_side[probs])


@pytest.mark.parametrize("key", ["probs", "tta", "int8"])
def test_facade_probabilities_match_jax(port_side, jax_side, key):
    for got in _every_rank(port_side):
        assert got[key].shape == jax_side[key].shape
        np.testing.assert_allclose(got[key], jax_side[key], rtol=1e-4, atol=1e-4)


def test_facade_find_learning_rate_matches_jax(port_side, jax_side):
    for got in _every_rank(port_side):
        np.testing.assert_allclose(got["lr"]["learning_rates"],
                                   jax_side["lr"]["learning_rates"], rtol=1e-12)
        np.testing.assert_allclose(got["lr"]["losses"], jax_side["lr"]["losses"], rtol=1e-4)
        # the sweep left the model as it found it: training then matched JAX
        assert got["lr_restored"]


def test_mesh_checkpoint_is_the_meshless_save_byte_for_byte(port_side, tmp_path):
    """Rank 0 wrote the gathered state; a mesh-less model loaded from it
    saves the same payload byte for byte and the same manifest."""
    got = _every_rank(port_side)
    path = got[0]["save_dir"]
    assert all(r["save_dir"] == path for r in got)
    saved = ckpt.load_checkpoint(path, make_optimizer(OPT))
    assert_params_close(bridge.to_numpy(saved["params"]), got[0]["params"], rtol=0, atol=0)
    assert saved["ema"] is not None and saved["opt_state"].inner is not None
    meta = ckpt.load_metadata(path)
    single = FCN8s(model_load_dir=path, device="cpu")
    # the bookkeeping the manifest names the checkpoint by
    single.training_loss, single.eval_dataset = meta["training_loss"], meta["eval_dataset"]
    single.metric_names, single.metric_values = list(meta["metrics"]), list(
        meta["metrics"].values())
    again = single.save(str(tmp_path), force_save=True)
    assert os.path.basename(again) == os.path.basename(path)
    for name in ("checkpoint.msgpack",):
        with open(os.path.join(path, name), "rb") as f, open(os.path.join(again, name),
                                                             "rb") as g:
            assert f.read() == g.read()
    meta2 = ckpt.load_metadata(again)
    meta.pop("saved_at"), meta2.pop("saved_at")
    assert json.dumps(meta, sort_keys=True) == json.dumps(meta2, sort_keys=True)


def test_mesh_checkpoint_loads_in_the_jax_facade(port_side):
    import jax
    from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s

    got = _every_rank(port_side)[0]
    jm = JFCN8s(model_load_dir=got["save_dir"])
    assert_params_close(jax.tree.map(np.asarray, jm.state.params), got["params"], rtol=0,
                        atol=0)
    assert jm.ema_params is not None
    jm.close()


def test_jax_checkpoint_loads_into_the_port_mesh(port_side, jax_side):
    for got in _every_rank(port_side, "loaded"):
        assert_params_close(got["params"], jax_side["params"], rtol=0, atol=0)
        assert_ids_agree(got["ids"], jax_side["ids"], jax_side["probs"])


def test_mesh_predict_and_save_writes_once_what_predict_gives(port_side):
    """Rank 0 wrote one id PNG per image (the others only predicted), each
    the ids of ``predict`` on the mesh."""
    from PIL import Image

    got = _every_rank(port_side)[0]
    out = port_side["root"] / "pngs"
    assert sorted(os.listdir(out)) == [f"img{i}.png" for i in range(len(IMAGES))]
    for i in range(len(IMAGES)):
        np.testing.assert_array_equal(np.asarray(Image.open(out / f"img{i}.png")),
                                      got["ids"][i].astype(np.uint8))


def test_mesh_export_serving_runs_the_gathered_params(port_side):
    """Rank 0 exported the whole trained params: the artifact predicts what
    a mesh-less model on those params predicts."""
    got = _every_rank(port_side)[0]
    artifact = load_serving_artifact(str(port_side["root"] / "artifact"), "cpu")
    images = IMAGES[:, :32, :64]
    single = FCN8s.from_params(got["params"], device="cpu", compute_dtype=torch.float32)
    np.testing.assert_array_equal(artifact.predict(images), single.predict(images))


def test_inference_service_on_the_mesh_answers_like_its_predict(port_side):
    """``InferenceService`` on the (2, 2) tensor-parallel mesh: rank 0
    answers a /predict body while the other ranks follow it, and its ids
    are the facade's own ``predict`` of that image on the mesh, which every
    rank returns alike."""
    ranks = _every_rank(port_side)
    for got in ranks:
        np.testing.assert_array_equal(got["serve_predict"], ranks[0]["serve_predict"])
    assert ranks[0]["served"].dtype == np.uint8
    np.testing.assert_array_equal(ranks[0]["served"], ranks[0]["serve_predict"])


def test_mesh_summaries_are_written_once(port_side):
    """Rank 0 alone wrote the training and evaluation event files (the
    weight summaries read the gathered fc6/fc7)."""
    tb = port_side["root"] / "tb"
    assert sorted(os.listdir(tb)) == ["summaries_evaluation", "summaries_training"]
    assert len(os.listdir(tb / "summaries_training")) == 1


def test_mesh_observers_take_the_same_branch_on_every_rank(port_side):
    """Early stopping and the LR plateau at patience 1 over six epochs at a
    diverging learning rate: every rank stops at the same step with the
    same counters (they read the loss summed over 'data')."""
    seen = [got["observers"] for got in _every_rank(port_side)]
    assert all(s == seen[0] for s in seen)
    step, _, counters = seen[0]
    # 2 train steps and 1 summaries step before; six epochs of one step at most
    assert counters and step < 3 + 6, (step, counters)
