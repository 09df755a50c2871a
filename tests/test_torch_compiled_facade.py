"""PyTorch port, the facade on the compiled steps, on the CPU.

``FCN8s`` runs ``train``, ``find_learning_rate``, ``evaluate``, ``predict``
(ids, softmax, overlay, int8, ``use_ema``, tiled), ``predict_tta`` and
``predict_and_save`` through its caches of ``compile_*_step``
(``_get_train_step`` and its siblings). On the CPU a compiled step warms
its body up ``graphs.WARMUP`` times, puts back what the warm-up wrote and
then calls it, so these tests hold the facade's captured bodies and its
caches' bookkeeping:

* against the eager steps bit for bit: ``train`` against a loop of eager
  ``train_step`` plus the EMA update from a copy of the same weights
  (keep_prob 0.5, device augmentation, ``gradient_accumulation=2`` on an
  odd batch, class weights, a periodic evaluation on 'train'), the other
  paths against the same facade with ``_eager_steps`` set (the eager
  steps, the facade as it ran before);
* the capture counts (``capture_counts``): one train and one eval capture
  over a run with three periodic evaluations; none more when the live,
  EMA and int8 trees alternate, for a tiled or ``predict_and_save`` tail,
  after training (the trees are refreshed in place) or ``load_variables``;
  a new one after ``calibrate_quantization``; four train steps kept of
  five augment configs, the evicted one collected; a tree that is gone
  takes its capture with it;
* ``spatial_partition=True`` and a mesh of two gloo ranks run compiled
  too: they make captures, and give the eager facade's results bit for
  bit.

A narrow fp32 model (``width_mult=1/32, fc_channels=32``) on 64x96 inputs
keeps each warm-up cheap. Run as a script, this file is a gloo rank of
``test_torch_mesh.launch``.
"""

import gc
import os
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine import model as M  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.augment_device import make_augment_fn  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.metrics import (empty_metrics_state,  # noqa: E402
                                                    finalize_metrics)
from fcn8s_tensorflow_tpu_torch.ops.quantize import quantize_fcn8s_params  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import graphs as G  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402

C = 5
HW = (64, 96)
SMALL = dict(width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32, device="cpu")
AUG = dict(flip=0.5, brightness=(0.8, 1.2, 0.5), translate=(8, 4, 0.5))
CW = (0.5, 1.0, 2.0, 0.0, 1.5)
LUT = {0: (255, 0, 0, 128), 1: (0, 255, 0, 0), 2: (0, 0, 255, 255), 3: (9, 9, 9, 77)}
F32 = torch.float32
NONE = {"train": 0, "eval": 0, "predict": 0, "tta": 0}


def _model(seed=0, eager=False, **kw):
    """The narrow model; ``eager``: the same facade on the eager steps."""
    model = FCN8s(num_classes=C, seed=seed, **SMALL, **kw)
    if eager:
        model._eager_steps = True
    return model


def _batches(seed, count, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8),
             rng.integers(0, C, (n, *HW), dtype=np.uint8)) for _ in range(count)]


def _gen(seed, n=3):
    rng = np.random.default_rng(seed)
    while True:
        yield (rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8),
               rng.integers(0, C, (n, *HW), dtype=np.uint8))


def _images(seed, n=2, hw=HW):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _trained_pair(**train_kw):
    """A compiled and an eager facade from one seed, trained alike (two
    steps, with an EMA)."""
    pair = [_model(), _model(eager=True)]
    for model in pair:
        model.train(_gen(5), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-3,
                    keep_prob=0.5, metrics=set(), record_summaries=False, ema_decay=0.9,
                    device_augment=AUG, **train_kw)
    return pair


def _same_tensors(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _captured_trees(cache) -> int:
    """The captures a step cache's steps hold now."""
    return sum(len(step.captures) for step in cache._steps.values())


# ---------------------------------------------------------------------------
# train, against a loop of the eager step
# ---------------------------------------------------------------------------


def _host_batch(model, images, labels):
    """The facade's host pipeline: the batch padded to a multiple of 2
    with masked copies of its last sample."""
    return [torch.from_numpy(a) for a in model._pad_batch_dim(images, labels, multiple=2)]


def test_train_equals_an_eager_loop():
    """Three epochs of two steps, each followed by an evaluation on the
    next two batches of the training stream: params, Adam's moments and
    counters, the EMA, the training loss and the metrics equal a loop of
    ``train_step`` and the EMA update on a copy of the weights; one train
    and one eval capture."""
    model = _model()
    params = {part: {name: {k: t.detach().clone().requires_grad_(True) for k, t in layer.items()}
                     for name, layer in layers.items()} for part, layers in model.params.items()}
    opt = tsteps.make_optimizer("adam")
    state = tsteps.create_train_state(params, opt)
    model.train(_gen(11), epochs=3, steps_per_epoch=2,
                learning_rate_schedule=lambda s: 1e-3 * (1 + s), keep_prob=0.5,
                l2_regularization=1e-3, eval_dataset="train", eval_frequency=1,
                metrics={"loss", "mean_iou", "accuracy"}, record_summaries=False,
                device_augment=AUG, gradient_accumulation=2, ema_decay=0.9, class_weights=CW,
                prefetch=2)

    batches = iter(_batches(11, 12))
    aug, cw = make_augment_fn(**AUG), torch.tensor(CW, dtype=F32)
    ema, losses, values = None, [], None
    d = np.float32(0.9)
    for _ in range(3):
        for _ in range(2):
            im, lb, mk = _host_batch(model, *next(batches))
            state, loss = tsteps.train_step(
                state, im, lb, mk, 0, 1e-3 * (1 + state.step), 1e-3, 0.5, optimizer=opt,
                num_classes=C, compute_dtype=F32, grad_accum=2, class_weights=cw, augment_fn=aug)
            losses.append(loss)
            leaves = bridge.param_leaves(state.params)
            with torch.no_grad():
                if ema is None:
                    ema = [t.detach().clone() for t in leaves]
                else:
                    torch._foreach_mul_(ema, float(d))
                    torch._foreach_add_(ema, leaves, alpha=float(np.float32(1) - d))
        metrics = empty_metrics_state(C, device="cpu")
        run = bridge.cast_params(state.params, F32)
        with torch.no_grad():
            for _ in range(2):
                tsteps.eval_step(run, metrics, *_host_batch(model, *next(batches)),
                                 num_classes=C, compute_dtype=F32, class_weights=cw)
        values = {k: float(v) for k, v in finalize_metrics(metrics).items()}

    assert model.state.step == state.step == 6
    assert _same_tensors(bridge.param_leaves(model.params), bridge.param_leaves(state.params))
    got, want = model.state.opt_state, state.opt_state
    assert (got.count, got.inner.count) == (want.count, want.inner.count)
    assert _same_tensors(got.inner.mu + got.inner.nu, want.inner.mu + want.inner.nu)
    assert _same_tensors(bridge.param_leaves(model.ema_params), ema)
    assert model.training_loss == float(torch.stack(losses[-3:]).numpy().mean())
    assert model.metric_values == [values[n] for n in ("loss", "mean_iou", "accuracy")]
    assert model.capture_counts() == {**NONE, "train": 1, "eval": 1}


# ---------------------------------------------------------------------------
# the other paths, against the eager facade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fresh", [True, False])
def test_find_learning_rate_equals_the_eager_sweep(fresh):
    """The sweep's curve and the restored state equal the eager facade's;
    a fresh model's transient optimizer state takes its capture with it."""
    pair = [_model(), _model(eager=True)] if fresh else _trained_pair()
    out = [m.find_learning_rate(_gen(7), steps=12, min_lr=1e-4, max_lr=1.0, keep_prob=0.5)
           for m in pair]
    assert out[0] == out[1]
    assert _same_tensors(bridge.param_leaves(pair[0].params), bridge.param_leaves(pair[1].params))
    if fresh:
        assert pair[0].state.opt_state is None
        assert pair[0].capture_counts()["train"] == 1
        assert _captured_trees(pair[0]._train_steps) == 0
    else:  # the train capture (keep_prob 0.5 both times) replays
        assert pair[0].capture_counts() == {**NONE, "train": 1}


def test_evaluate_equals_the_eager_facade():
    model, eager = _trained_pair(class_weights=CW)
    for use_ema in (False, True, False):
        want = eager.evaluate(_gen(9), 2, use_ema=use_ema)
        assert model.evaluate(_gen(9), 2, use_ema=use_ema) == want
        assert all(torch.equal(model.metrics_state[k], eager.metrics_state[k])
                   for k in model.metrics_state)
    # one step, two trees: the live params and the EMA's cast
    assert model.capture_counts() == {**NONE, "train": 1, "eval": 2}


PREDICTS = {"ids": {}, "softmax": dict(argmax=False), "overlay": dict(overlay=LUT),
            "int8": dict(quantized=True), "ema": dict(use_ema=True),
            "ema_softmax": dict(argmax=False, use_ema=True)}


def test_predict_equals_the_eager_facade_and_trees_alternate_without_capture():
    model, eager = _trained_pair()
    images = _images(3, n=2, hw=(60, 90))  # padded to 64x96 and cropped back
    for kw in PREDICTS.values():
        got, want = model.predict(images, **kw), eager.predict(images, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    first = model.capture_counts()
    # ids, softmax, overlay and int8 are four steps; the EMA is a second
    # tree of the ids and softmax steps
    assert first == {**NONE, "train": 1, "predict": 6}
    for kw in (PREDICTS["ids"], PREDICTS["ema"], PREDICTS["int8"], PREDICTS["ids"],
               PREDICTS["int8"], PREDICTS["ema"]):
        assert np.array_equal(model.predict(images, **kw), eager.predict(images, **kw))
    assert model.capture_counts() == first


def test_training_refreshes_the_trees_in_place():
    """After more training the compute-dtype params, the EMA's cast and the
    int8 tree are the same tensors with the new values (the captures over
    them replay), and each predict equals the eager facade's."""
    model, eager = _trained_pair()
    images = _images(4)
    for kw in (PREDICTS["ids"], PREDICTS["ema"], PREDICTS["int8"]):
        model.predict(images, **kw)
    trees = [G.tensors_of(t) for t in (model._run_params, model._ema_run, model._qparams)]
    counts = model.capture_counts()
    for m in (model, eager):
        m.train(_gen(6), epochs=1, steps_per_epoch=1, learning_rate_schedule=lambda s: 1e-2,
                keep_prob=0.5, metrics=set(), record_summaries=False, ema_decay=0.9,
                device_augment=AUG)
    for kw in (PREDICTS["ids"], PREDICTS["ema"], PREDICTS["int8"]):
        assert np.array_equal(model.predict(images, **kw), eager.predict(images, **kw))
    now = [G.tensors_of(t) for t in (model._run_params, model._ema_run, model._qparams)]
    assert all(a is b for old, new in zip(trees, now) for a, b in zip(old, new))
    want = [bridge.cast_params(model.params, F32), bridge.cast_params(model.ema_params, F32),
            quantize_fcn8s_params(model.params, compute_dtype=F32)]
    assert all(_same_tensors(got, G.tensors_of(w)) for got, w in zip(now, want))
    assert model.capture_counts() == counts


def test_calibration_drops_the_int8_captures():
    model, eager = _trained_pair()
    images = _images(5, n=3)
    model.predict(images, quantized=True)
    model.predict(images)
    counts = model.capture_counts()
    for m in (model, eager):
        m.calibrate_quantization(images, batch_size=2)
    assert np.array_equal(model.predict(images, quantized=True),
                          eager.predict(images, quantized=True))
    assert model.capture_counts()["predict"] == counts["predict"] + 1
    model.predict(images)
    assert model.capture_counts()["predict"] == counts["predict"] + 1


@pytest.mark.parametrize("blend", [False, True])
def test_tiled_predict_pads_its_tail_into_one_capture(blend):
    """2 images x 6 tiles = 12: a chunk of 8 and a tail of 4 padded to 8,
    one capture for both and none for a second call."""
    model, eager = _trained_pair()
    frames = _images(6, n=2, hw=(64, 96))
    kw = dict(tile=(32, 32), tile_overlap=0, tile_blend=blend)
    for q in (False, True):
        got = model.predict(frames, quantized=q, **kw)
        assert np.array_equal(got, eager.predict(frames, quantized=q, **kw))
    assert model.capture_counts()["predict"] == 2
    model.predict(frames, **kw)
    model.predict(frames[:1], **kw)  # 6 tiles: one chunk, padded to 8
    assert model.capture_counts()["predict"] == 2
    if not blend:
        ids = model.predict(frames, argmax=False, **kw)
        assert ids.shape == (2, 64, 96, C)


def test_predict_tta_equals_the_eager_facade():
    model, eager = _trained_pair()
    images = _images(7)
    for kw in (dict(scales=(0.75, 1.0)), dict(scales=(1.0,), flip=False, argmax=False),
               dict(scales=(0.75, 1.0), quantized=True), dict(scales=(1.0,), use_ema=True)):
        assert np.array_equal(model.predict_tta(images, **kw), eager.predict_tta(images, **kw))
    # (0.75, flip), (1.0, flip), (1.0, no flip), the int8 pair; the EMA on (1.0, flip)
    assert model.capture_counts()["tta"] == 6


@pytest.mark.parametrize("fmt", ["ids", "overlay"])
def test_predict_and_save_pads_its_tail(tmp_path, fmt):
    """5 images in chunks of 2: the tail of 1 replays the chunks' step, and
    the PNGs are the eager facade's byte for byte."""
    from PIL import Image

    src = tmp_path / "images"
    src.mkdir()
    for i, image in enumerate(_images(8, n=5)):
        Image.fromarray(image).save(src / f"img{i}.png")
    model, eager = _trained_pair()
    kw = dict(output_format=fmt, batch_size=2, verbose=False,
              color_map=LUT if fmt == "overlay" else None)
    model.predict_and_save(str(tmp_path / "got"), str(src), **kw)
    eager.predict_and_save(str(tmp_path / "want"), str(src), **kw)
    names = sorted(os.listdir(src))
    assert sorted(os.listdir(tmp_path / "got")) == names
    for name in names:
        assert (tmp_path / "got" / name).read_bytes() == (tmp_path / "want" / name).read_bytes()
    assert model.capture_counts()["predict"] == 1


def test_load_variables_refreshes_in_place(tmp_path):
    """``load_variables`` copies into the masters and refreshes the trees in
    place: no new capture, the loaded model's predictions. A checkpoint of
    other shapes raises, as in the JAX facade, and changes nothing."""
    model, _ = _trained_pair()
    saved = model.save(str(tmp_path / "a"), force_save=True)
    images = _images(9)
    model.predict(images)
    model.train(_gen(12), epochs=1, steps_per_epoch=1, learning_rate_schedule=lambda s: 1e-2,
                keep_prob=0.5, metrics=set(), record_summaries=False)
    counts = model.capture_counts()
    model.load_variables(saved)
    want = FCN8s(model_load_dir=saved, compute_dtype=F32, device="cpu").predict(images)
    assert np.array_equal(model.predict(images), want)
    assert model.capture_counts() == counts
    other = FCN8s(num_classes=C, **{**SMALL, "width_mult": 1 / 16})
    other_dir = other.save(str(tmp_path / "b"), force_save=True)
    with pytest.raises(ValueError, match="shape"):
        model.load_variables(other_dir)
    assert np.array_equal(model.predict(images), want)
    assert model.capture_counts() == counts


# ---------------------------------------------------------------------------
# the caches
# ---------------------------------------------------------------------------


def test_five_augment_configs_keep_four_train_steps():
    """The train cache keeps four steps, the least recently used evicted;
    the evicted step, its capture and its buffers are collected."""
    model = _model()
    refs = []
    for i in range(5):
        cfg = dict(flip=0.5, brightness=(0.8, 1.2 + 0.1 * i, 0.5))
        model.train(_gen(20 + i), epochs=1, steps_per_epoch=1,
                    learning_rate_schedule=lambda s: 1e-3, keep_prob=1.0, metrics=set(),
                    record_summaries=False, device_augment=cfg, prefetch=0)
        if i == 0:
            step, = model._train_steps._steps.values()
            entry, = step.captures.values()
            refs = [weakref.ref(step), weakref.ref(entry), weakref.ref(entry.statics[0])]
            del step, entry
    gc.collect()
    assert len(model._train_steps.keys()) == 4 and model.capture_counts()["train"] == 5
    assert all(r() is None for r in refs)
    first = FCN8s._freeze_cfg(dict(flip=0.5, brightness=(0.8, 1.2, 0.5)))
    assert first not in [cfg for _, cfg, _ in model._train_steps.keys()]


def test_a_tree_that_is_gone_takes_its_capture_with_it():
    """The capture over the EMA's cast holds no reference to it: after
    ``adopt_ema`` the cast is collected, and the next call of that step
    releases the capture."""
    model, _ = _trained_pair()
    images = _images(10)
    model.predict(images)
    model.predict(images, use_ema=True)
    step, = model._predict_steps._steps.values()
    assert len(step.captures) == 2
    leaf = weakref.ref(G.tensors_of(model._ema_run)[0])
    model.adopt_ema()
    gc.collect()
    assert leaf() is None
    model.predict(images)
    assert len(step.captures) == 1 and model.capture_counts()["predict"] == 2


def test_class_weights_and_accumulation_rebuild_the_steps():
    """As in the JAX facade: new class weights clear the train and eval
    steps, a new accumulation the train steps; the same ones keep them."""
    model = _model()
    kw = dict(epochs=1, steps_per_epoch=1, learning_rate_schedule=lambda s: 1e-3,
              keep_prob=1.0, metrics={"loss"}, eval_frequency=1, record_summaries=False,
              prefetch=0)
    model.train(_gen(30), class_weights=CW, **kw)
    model.train(_gen(31), class_weights=CW, **kw)
    assert model.capture_counts() == {**NONE, "train": 1, "eval": 1}
    model.train(_gen(32), **kw)
    assert model.capture_counts() == {**NONE, "train": 2, "eval": 2}
    model.train(_gen(33), gradient_accumulation=3, **kw)
    assert model.capture_counts() == {**NONE, "train": 3, "eval": 2}


def test_step_cache_is_least_recently_used():
    made = []

    class Step:
        captures_made = 1

        def __init__(self, key):
            self.key, self.released = key, False
            made.append(self)

        def release(self):
            self.released = True

    cache = M._StepCache(2)
    for key in ("a", "b", "a", "c"):
        cache.get(key, lambda key=key: Step(key))
    assert cache.keys() == ["a", "c"] and [s.key for s in made] == ["a", "b", "c"]
    assert made[1].released and not made[0].released
    assert cache.captures_made == 3
    cache.drop(lambda key: key == "a")
    assert cache.keys() == ["c"] and made[0].released and cache.captures_made == 3


def test_refill_writes_in_place_only_on_the_same_layout():
    master = bridge.to_port(init_fcn8s(torch.Generator().manual_seed(0), C,
                                       width_mult=1 / 32, fc_channels=32))
    old = bridge.cast_params(master, torch.bfloat16)
    for t in bridge.param_leaves(master):
        t.mul_(1.5)
    new = bridge.cast_params(master, torch.bfloat16)
    assert M._refill(old, new) is old
    assert _same_tensors(G.tensors_of(old), G.tensors_of(new))
    other = bridge.cast_params(master, F32)
    assert M._refill(old, other) is other


# ---------------------------------------------------------------------------
# the layouts: spatial_partition and a mesh of two ranks, compiled
# ---------------------------------------------------------------------------


def _layout_calls(model, gen, spatial):
    """train (a periodic evaluation), evaluate, predict and the LR sweep,
    each with ``spatial_partition=spatial`` where it takes one; returns
    their results."""
    model.train(gen(40), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-3,
                keep_prob=0.5, metrics={"loss"}, eval_frequency=1, record_summaries=False,
                spatial_partition=spatial, prefetch=0)
    return {"loss": model.training_loss,
            "params": [t.detach().clone() for t in bridge.param_leaves(model.params)],
            "evaluate": model.evaluate(gen(41), 1, spatial_partition=spatial),
            "predict": model.predict(_images(42), argmax=False, spatial_partition=spatial),
            "lr": model.find_learning_rate(gen(43), steps=2)}


def _same_results(a: dict, b: dict) -> bool:
    return (a["loss"] == b["loss"] and a["evaluate"] == b["evaluate"]
            and _same_tensors(a["params"], b["params"])
            and np.array_equal(a["predict"], b["predict"]) and a["lr"] == b["lr"])


def test_spatial_partition_runs_the_compiled_steps():
    """``spatial_partition=True`` on the one-position mesh (the plain layout)
    captures train, eval and predict steps of its own layout, and equals
    the eager facade bit for bit."""
    models = [_model(), _model(eager=True)]
    got, want = (_layout_calls(m, _gen, spatial=True) for m in models)
    assert _same_results(got, want)
    counts = models[0].capture_counts()
    # the LR sweep trains without the split: a train step of the plain layout beside it
    assert counts == {"train": 2, "eval": 1, "predict": 1, "tta": 0}, counts
    assert models[1].capture_counts() == NONE


def _job_mesh(job, mesh, tree):
    """A gloo rank: the facade on a mesh of two positions, compiled and on
    its eager steps, from the same weights."""
    out = {}
    for name in ("compiled", "eager"):
        model = FCN8s.from_params(tree, mesh=mesh, device="cpu", compute_dtype=F32,
                                  width_mult=1 / 16, fc_channels=64)
        model._eager_steps = name == "eager"
        rng = np.random.default_rng(1)
        images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        labels = rng.integers(0, C, (2, 64, 64), dtype=np.uint8)
        model.train(iter([(images, labels)] * 4), epochs=1, steps_per_epoch=2,
                    learning_rate_schedule=lambda s: 1e-3, keep_prob=0.5, metrics={"loss"},
                    eval_frequency=1, record_summaries=False, prefetch=0)
        out[name] = {"loss": model.training_loss, "metrics": list(model.metric_values),
                     "params": bridge.to_numpy(model._gather(model.params)),
                     "predict": model.predict(images),
                     "tta": model.predict_tta(images, argmax=False),
                     "captures": model.capture_counts()}
        model.close()
    return out


def test_a_mesh_of_two_ranks_runs_the_compiled_steps(tmp_path):
    from tests.test_torch_mesh import launch

    ranks = launch(tmp_path, 2, {"m": dict(kind="mesh", mesh=(2, 1))},
                   script=os.path.abspath(__file__))
    for rank in ranks:
        got, want = rank["m"]["compiled"], rank["m"]["eager"]
        assert got["captures"] == {"train": 1, "eval": 1, "predict": 1, "tta": 1}
        assert want["captures"] == NONE
        assert got["loss"] == want["loss"] and got["metrics"] == want["metrics"]
        for key in ("predict", "tta"):
            np.testing.assert_array_equal(got[key], want[key])
        for part in want["params"]:
            for layer in want["params"][part]:
                for k in want["params"][part][layer]:
                    np.testing.assert_array_equal(got["params"][part][layer][k],
                                                  want["params"][part][layer][k])


def _job_tp_spatial(job, mesh, tree):
    """A gloo rank of a (1, 2) tensor-parallel facade: spatial predicts and
    evaluates, compiled and on its eager steps, from the same weights."""
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (2, 64, 64), dtype=np.uint8)
    out = {}
    for name in ("compiled", "eager"):
        model = FCN8s.from_params(tree, mesh=mesh, tensor_parallel=True, device="cpu",
                                  compute_dtype=F32, width_mult=1 / 16, fc_channels=64)
        model._eager_steps = name == "eager"
        out[name] = {"predict": [model.predict(images, argmax=False, spatial_partition=True)
                                 for _ in range(2)],
                     "evaluate": [model.evaluate(iter([(images, labels)]), 1,
                                                 spatial_partition=True) for _ in range(2)],
                     "captures": model.capture_counts()}
        model.close()
    return out


def test_spatial_calls_on_a_tensor_parallel_mesh_replay_their_captures(tmp_path):
    """A spatial predict or evaluate on a tensor-parallel facade runs on its
    params gathered into one tree refreshed in place: a second call
    replays, and both equal the eager steps bit for bit."""
    from tests.test_torch_mesh import launch

    ranks = launch(tmp_path, 2, {"t": dict(kind="tp_spatial", mesh=(1, 2))},
                   script=os.path.abspath(__file__))
    for rank in ranks:
        got, want = rank["t"]["compiled"], rank["t"]["eager"]
        assert got["captures"] == {"train": 0, "eval": 1, "predict": 1, "tta": 0}
        assert got["evaluate"] == want["evaluate"]
        for a, b in zip(got["predict"], want["predict"]):
            np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tests.test_torch_mesh import _rank_main

    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
               jobs={"mesh": _job_mesh, "tp_spatial": _job_tp_spatial})
