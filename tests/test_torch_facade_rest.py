"""PyTorch port, the rest of the facade against the JAX facade on the CPU:
``summary``, ``find_learning_rate``, ``predict_and_save`` and
``score_benchmark``.

A narrow fp32 model (``width_mult=1/32, fc_channels=32``), 20 classes, its
decoder redrawn at unit fan-in scale as in tests/test_torch_model.py, on
the same numpy weights in both packages. Tolerances, with their reasons:

* ``summary``: the same text;
* the LR sweep at keep_prob 1: losses and the smoothed curve within rtol
  1e-4 (XLA:CPU and oneDNN sum in different orders, and twelve Adam steps
  carry the difference along), the suggestion and the validation errors
  equal; the model after a sweep bit-equal to the model before;
* ``predict_and_save``: ids and host-composited overlays equal wherever
  JAX's softmax top-2 margin exceeds ``MARGIN`` and on >= 99.9% of pixels;
  the on-device overlay within 1 LSB there (FMA contraction);
* ``score_benchmark``: the confusion matrices differ by at most 2 counts
  per pixel below that margin (a flipped id moves one count), and the
  mechanics of tests/test_offline_eval.py's facade test hold exactly.
"""

import functools
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu.labels import TRAINIDS_TO_IDS_ARRAY, TRAINIDS_TO_RGBA_DICT  # noqa: E402
from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh  # noqa: E402
from fcn8s_tensorflow_tpu.utils.summary import model_summary_rows as j_rows  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402

C = 20
SMALL = dict(width_mult=1 / 32, fc_channels=32)
MARGIN = 1e-4  # of JAX's fp32 softmax, top-1 minus top-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def _tree(variant="fcn8s"):
    """JAX-initialised numpy weights, the decoder redrawn at unit fan-in
    scale (O(1) logits, so ids have margins). Cached: callers only read it."""
    init = jax.jit(lambda key: j_init(key, C, variant=variant, **SMALL))
    tree = jax.tree.map(np.array, init(jax.random.PRNGKey(8)))
    rng = np.random.default_rng(8)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = rng.normal(size=layer["bias"].shape).astype(np.float32) * 0.1
    return tree


def _jax_model(variant="fcn8s"):
    jm = JFCN8s(num_classes=C, compute_dtype=jnp.float32, variant=variant,
                mesh=create_mesh(data=1, model=1), **SMALL)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree(variant)))
    return jm


def _port_model(variant="fcn8s", **kw):
    return FCN8s.from_params(_tree(variant), device="cpu", compute_dtype=torch.float32,
                             **SMALL, **kw)


@pytest.fixture(scope="module")
def jax_model():
    jm = _jax_model()
    yield jm
    jm.close()


def _snapshot(model):
    """Everything a sweep could touch, as host copies."""
    from fcn8s_tensorflow_tpu_torch.engine.model import _opt_scalars

    opt = model.state.opt_state
    tensors = [] if opt is None else [t.detach().clone() for t in _opt_tensors(opt)]
    scalars = None if opt is None else _opt_scalars(opt)
    return {"params": [t.detach().clone() for t in bridge.param_leaves(model.params)],
            "run": [t.clone() for t in bridge.param_leaves(model._run_params)],
            "step": model.state.step, "g_step": model.g_step, "opt": opt is not None,
            "opt_tensors": tensors, "opt_scalars": scalars,
            "dirty": model.variables_updated, "loss": model.training_loss}


def _opt_tensors(opt):
    from fcn8s_tensorflow_tpu_torch.engine.model import _opt_tensors

    return _opt_tensors(opt)


def _assert_same(a, b):
    assert {k: v for k, v in a.items() if k not in ("params", "run", "opt_tensors")} == \
        {k: v for k, v in b.items() if k not in ("params", "run", "opt_tensors")}
    for key in ("params", "run", "opt_tensors"):
        assert len(a[key]) == len(b[key])
        assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), key


def _batches(rng, n=2, h=64, w=64):
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (n, h, w), dtype=np.uint8)

    def gen():
        while True:
            yield images, labels

    return gen


# ---------------------------------------------------------------------------
# summary
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("input_hw,batch", [((64, 96), 1), ((1024, 512), 8)])
@pytest.mark.parametrize("variant", ["fcn8s", "fcn16s", "fcn32s"])
def test_summary_text_equals_the_jax_facades(variant, input_hw, batch):
    jm = _jax_model(variant)
    model = _port_model(variant)
    assert model.summary(input_hw, batch) == jm.summary(input_hw, batch)
    assert model.summary() == jm.summary()
    jm.close()


@pytest.mark.parametrize("input_hw", [(65, 96), (64, 100)])
def test_summary_raises_on_sizes_off_the_stride(input_hw):
    model = _port_model()
    with pytest.raises(ValueError, match="divisible by 32"):
        model.summary(input_hw=input_hw)


def test_smoke_summary_constants_are_the_jax_packages():
    """chip_smoke.py phase 18a holds the full-width summary's totals against
    constants; they are the JAX package's rows for the full-width 20-class
    fcn8s at 8 x 1024x512 (shapes only, from ``jax.eval_shape``)."""
    import chip_smoke

    shapes = jax.eval_shape(lambda k: j_init(k, C), jax.random.PRNGKey(0))
    rows = j_rows(shapes, chip_smoke.SUMMARY_HW, chip_smoke.SUMMARY_BATCH)
    assert chip_smoke.SUMMARY_TOTALS == {
        "params": sum(r["params"] for r in rows), "macs": sum(r["macs"] for r in rows),
        "act_bytes": sum(r["act_bytes"] for r in rows)}


# ---------------------------------------------------------------------------
# find_learning_rate
# ---------------------------------------------------------------------------
SWEEP = dict(steps=12, min_lr=1e-5, max_lr=1e-2)


@pytest.fixture(scope="module")
def jax_sweep(jax_model):
    return jax_model.find_learning_rate(_batches(np.random.default_rng(3))(), **SWEEP)


def test_lr_sweep_equals_the_jax_facades(jax_sweep):
    model = _port_model()
    before = _snapshot(model)
    got = model.find_learning_rate(_batches(np.random.default_rng(3))(), **SWEEP)
    want = jax_sweep
    assert len(got["losses"]) == len(want["losses"]) == SWEEP["steps"]
    np.testing.assert_allclose(got["learning_rates"], want["learning_rates"], rtol=1e-12)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["smoothed"], want["smoothed"], rtol=1e-4)
    assert got["suggestion"] == want["suggestion"]
    assert model.state.opt_state is None  # a fresh model gets its None back
    _assert_same(_snapshot(model), before)


@pytest.mark.parametrize("kwargs", [dict(min_lr=0.0), dict(min_lr=1e-2, max_lr=1e-3),
                                    dict(steps=1)])
def test_lr_sweep_validation_equals_the_jax_facades(jax_model, kwargs):
    messages = []
    for m in (jax_model, _port_model()):
        with pytest.raises(ValueError) as err:
            m.find_learning_rate(_batches(np.random.default_rng(0))(), **kwargs)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("optimizer", ["adam", "momentum", "sgd"])
def test_lr_sweep_after_training_restores_everything(optimizer):
    """After two train() steps: params, the optimizer's tensors and
    counters, the step, the inference tree and predict come back bit-equal;
    the int8 tree is rebuilt from the restored params."""
    model = _port_model(optimizer=optimizer)
    gen = _batches(np.random.default_rng(4))
    model.train(gen(), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-3,
                keep_prob=1.0, record_summaries=False, prefetch=0)
    images = next(gen())[0]
    ids, q_ids = model.predict(images), model.predict(images, quantized=True)
    before = _snapshot(model)
    result = model.find_learning_rate(gen(), steps=6, min_lr=1e-4, max_lr=1e-1)
    assert len(result["losses"]) == 6
    _assert_same(_snapshot(model), before)
    assert model.state.opt_state.count == 2
    np.testing.assert_array_equal(model.predict(images), ids)
    np.testing.assert_array_equal(model.predict(images, quantized=True), q_ids)


def test_lr_sweep_that_ends_on_nan_or_raises_leaves_no_trace():
    model = _port_model()
    before = _snapshot(model)
    result = model.find_learning_rate(_batches(np.random.default_rng(5))(), steps=8,
                                      min_lr=1e3, max_lr=1e9)
    assert not math.isfinite(result["losses"][-1]) and len(result["losses"]) < 8
    assert result["suggestion"] == 1e3
    _assert_same(_snapshot(model), before)

    def failing():
        gen = _batches(np.random.default_rng(5))()
        for _ in range(3):
            yield next(gen)
        raise RuntimeError("the input pipeline failed")

    with pytest.raises(RuntimeError, match="input pipeline"):
        model.find_learning_rate(failing(), steps=8)
    assert model.state.opt_state is None
    _assert_same(_snapshot(model), before)


def test_lr_sweep_on_a_loaded_model_leaves_the_staged_state(tmp_path):
    """A checkpoint-loaded model stages Adam's moments on the host; the
    sweep runs from a copy of them and leaves the staged state as it was
    and the live state None."""
    model = _port_model()
    model.train(_batches(np.random.default_rng(6))(), epochs=1, steps_per_epoch=2,
                learning_rate_schedule=lambda s: 1e-3, keep_prob=1.0, record_summaries=False)
    path = model.save(str(tmp_path))
    loaded = FCN8s(model_load_dir=path, device="cpu")
    staged = loaded._staged_opt_state
    staged_copy = [t.clone() for t in _opt_tensors(staged)]
    before = _snapshot(loaded)
    loaded.find_learning_rate(_batches(np.random.default_rng(6))(), steps=4)
    assert loaded._staged_opt_state is staged and staged.count == 2
    assert all(torch.equal(a, b) for a, b in zip(_opt_tensors(staged), staged_copy))
    _assert_same(_snapshot(loaded), before)
    # the first train() after it still starts from the checkpoint's moments
    loaded.train(_batches(np.random.default_rng(7))(), epochs=1, steps_per_epoch=1,
                 learning_rate_schedule=lambda s: 1e-3, keep_prob=1.0, record_summaries=False)
    assert loaded.state.opt_state.count == 3


# ---------------------------------------------------------------------------
# predict_and_save
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Three 64x128 images and one 96x64 (two size groups, a short chunk)."""
    rng = np.random.default_rng(9)
    d = tmp_path_factory.mktemp("images")
    for i, (h, w) in enumerate([(64, 128), (64, 128), (96, 64), (64, 128)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(d / f"im{i}.jpg")
    return d


def _read_dir(d):
    return {name: np.asarray(Image.open(os.path.join(d, name)))
            for name in sorted(os.listdir(d))}


def _clear(jm, image_dir, resize=None, **kw):
    """Per file: JAX's top-2 softmax margin > MARGIN."""
    out = {}
    for name in sorted(os.listdir(image_dir)):
        if name.endswith(".png"):
            img = np.asarray(Image.open(image_dir / name).convert("RGB"))
            if resize:
                import cv2

                img = cv2.resize(img, (resize[1], resize[0]), interpolation=cv2.INTER_LINEAR)
            probs = jm.predict(img[None], argmax=False, **kw)[0]
            top2 = np.sort(probs, axis=-1)[..., -2:]
            out[name] = (top2[..., 1] - top2[..., 0]) > MARGIN
    return out


CASES = {
    "ids": dict(output_format="ids", id_map=TRAINIDS_TO_IDS_ARRAY),
    "ids_raw": dict(output_format="ids"),
    "ids_uint16": dict(output_format="ids", id_map=np.arange(C) * 1000 + 7),
    "overlay_device": dict(color_map=TRAINIDS_TO_RGBA_DICT),
    "overlay_host_vertical": dict(color_map=TRAINIDS_TO_RGBA_DICT, on_device_overlay=False,
                                  include_unprocessed_image=True),
    "overlay_host_horizontal": dict(color_map=TRAINIDS_TO_RGBA_DICT, on_device_overlay=False,
                                    include_unprocessed_image=True, arrangement="horizontal"),
    "tiled_ids": dict(output_format="ids", tile=(64, 64), tile_overlap=32),
    "resized_ids": dict(output_format="ids", resize=(48, 96)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_and_save_files_equal_the_jax_facades(jax_model, image_dir, tmp_path, case):
    kw = CASES[case]
    model = _port_model()
    for m, tag in ((jax_model, "jax"), (model, "port")):
        m.predict_and_save(str(tmp_path / tag), str(image_dir), batch_size=2, verbose=False,
                           **kw)
    want, got = _read_dir(tmp_path / "jax"), _read_dir(tmp_path / "port")
    assert sorted(got) == sorted(want) == ["im0.png", "im1.png", "im2.png", "im3.png"]
    clear = _clear(jax_model, image_dir, resize=kw.get("resize"),
                   **{k: kw[k] for k in ("tile", "tile_overlap") if k in kw})
    agree = []
    for name in want:
        g, w, c = got[name], want[name], clear[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if kw.get("include_unprocessed_image"):  # the image half is exact
            h = c.shape[0]
            half = (slice(h, None), slice(None)) if kw.get("arrangement", "vertical") == \
                "vertical" else (slice(None), slice(c.shape[1], None))
            np.testing.assert_array_equal(g[half], w[half])
            g, w = g[:h, :c.shape[1]], w[:h, :c.shape[1]]
        if case == "overlay_device":
            assert np.abs(g[c].astype(int) - w[c]).max() <= 1, name
        else:
            np.testing.assert_array_equal(g[c], w[c], err_msg=name)
        agree.append(np.all(g == w, axis=-1) if g.ndim == 3 else g == w)
    assert np.concatenate([a.ravel() for a in agree]).mean() >= 0.999
    if case == "ids_uint16":
        assert got["im0.png"].dtype == np.uint16 and got["im0.png"].max() > 255
    timings = model.predict_and_save_timings
    assert timings["images"] == 4 and timings["seconds"] > 0
    assert set(timings) == {"images", "seconds", "decode", "decode_wait", "dispatch", "d2h",
                            "encode", "encode_wait"}


@pytest.mark.parametrize("kwargs", [
    dict(tile_blend=True, output_format="ids"),
    dict(output_format="png"),
    dict(output_format="ids", include_unprocessed_image=True),
    dict(output_format="overlay"),
])
def test_predict_and_save_validation_equals_the_jax_facades(jax_model, image_dir, tmp_path,
                                                            kwargs):
    messages = []
    for m, tag in ((jax_model, "jax"), (_port_model(), "port")):
        with pytest.raises(ValueError) as err:
            m.predict_and_save(str(tmp_path / tag), str(image_dir), verbose=False, **kwargs)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_predict_and_save_ema_quantized_and_overwrite(image_dir, tmp_path, capsys):
    """``use_ema`` without an EMA and with ``quantized`` raise; the banner
    and progress line print with ``verbose``; ``overwrite_existing=False``
    keeps other files; ``quantized`` writes the int8 predict's ids."""
    model = _port_model()
    with pytest.raises(ValueError, match="No EMA params"):
        model.predict_and_save(str(tmp_path / "a"), str(image_dir), output_format="ids",
                               use_ema=True)
    model.train(_batches(np.random.default_rng(1))(), epochs=1, steps_per_epoch=1,
                learning_rate_schedule=lambda s: 1e-4, keep_prob=1.0, ema_decay=0.5,
                record_summaries=False)
    with pytest.raises(ValueError, match="mutually exclusive"):
        model.predict_and_save(str(tmp_path / "a"), str(image_dir), output_format="ids",
                               use_ema=True, quantized=True)
    out = tmp_path / "out"
    out.mkdir()
    (out / "keep.txt").write_text("x")
    capsys.readouterr()
    model.predict_and_save(str(out), str(image_dir), output_format="ids", quantized=True,
                           overwrite_existing=False, batch_size=3)
    printed = capsys.readouterr().out
    assert f'saved to "{out}"' in printed and "Processing images: 4/4" in printed
    assert (out / "keep.txt").exists()
    img = np.asarray(Image.open(image_dir / "im2.png").convert("RGB"))
    np.testing.assert_array_equal(np.asarray(Image.open(out / "im2.png")),
                                  model.predict(img[None], quantized=True)[0])
    model.predict_and_save(str(out), str(image_dir), output_format="ids", use_ema=True,
                           verbose=False)
    assert not (out / "keep.txt").exists()
    np.testing.assert_array_equal(np.asarray(Image.open(out / "im2.png")),
                                  model.predict(img[None], use_ema=True)[0])


# ---------------------------------------------------------------------------
# score_benchmark
# ---------------------------------------------------------------------------
def _benchmark_dir(root, h=64, w=128, cities=("aachen", "bonn"), frames=2):
    """A Cityscapes-layout split: labelId GT (road, building, car, void)
    and instanceIds with car instances."""
    rng = np.random.default_rng(12)
    for city in cities:
        img_dir = root / "leftImg8bit" / "val" / city
        gt_dir = root / "gtFine" / "val" / city
        img_dir.mkdir(parents=True)
        gt_dir.mkdir(parents=True)
        for n in range(frames):
            gt = np.full((h, w), 7, np.uint8)
            gt[: h // 2] = 11
            gt[h // 2:, w // 2:] = 26
            gt[:4] = 0
            inst = gt.astype(np.uint16)
            inst[h // 2:, w // 2: 3 * w // 4] = 26001
            inst[h // 2:, 3 * w // 4:] = 26002
            name = f"{city}_{n:06d}_000019"
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                img_dir / f"{name}_leftImg8bit.png")
            Image.fromarray(gt).save(gt_dir / f"{name}_gtFine_labelIds.png")
            Image.fromarray(inst).save(gt_dir / f"{name}_gtFine_instanceIds.png")
    return root


def test_score_benchmark_equals_the_jax_facades(jax_model, tmp_path, monkeypatch, capsys):
    """The same split through both facades: the same files, every score
    from the same matrix, and the matrices apart only where JAX's margin is
    below ``MARGIN``; quiet output; a stale CITYSCAPES_EXPORT_DIR ignored."""
    ds = _benchmark_dir(tmp_path / "ds")
    monkeypatch.setenv("CITYSCAPES_EXPORT_DIR", str(tmp_path / "gone"))
    model = _port_model()
    capsys.readouterr()
    want = jax_model.score_benchmark(str(ds), str(tmp_path / "jax"))
    capsys.readouterr()
    got = model.score_benchmark(str(ds), str(tmp_path / "port"))
    assert capsys.readouterr().out == ""
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert os.path.isfile(tmp_path / "port" / "resultPixelLevelSemanticLabeling.json")
    conf_got, conf_want = (np.asarray(r["confMatrix"], np.int64) for r in (got, want))
    assert conf_got.sum() == 4 * 64 * 128
    unclear = 0
    for city_img in sorted((ds / "leftImg8bit" / "val").glob("*/*.png")):
        img = np.asarray(Image.open(city_img).convert("RGB"))
        top2 = np.sort(jax_model.predict(img[None], argmax=False)[0], axis=-1)[..., -2:]
        unclear += int(((top2[..., 1] - top2[..., 0]) <= MARGIN).sum())
    assert np.abs(conf_got - conf_want).sum() <= 2 * unclear
    if unclear == 0:
        assert json_equal(got, want)


def json_equal(a, b):
    import json

    return json.dumps(a, sort_keys=True, default=float) == json.dumps(b, sort_keys=True,
                                                                       default=float)


def test_score_benchmark_mechanics(tmp_path):
    """As tests/test_offline_eval.py's facade test: the image root and the
    ground truth are checked before any inference, ``id_map`` is required
    off the 20-class scheme, ``instance_level=False`` needs no instanceIds,
    ``export_file`` is honoured, and ``quiet=False`` prints the report."""
    model = _port_model()
    with pytest.raises(ValueError, match="image root"):
        model.score_benchmark(str(tmp_path / "nope"), str(tmp_path / "r"))
    ds2 = tmp_path / "ds2"
    (ds2 / "leftImg8bit" / "val" / "x").mkdir(parents=True)
    with pytest.raises(ValueError, match="no ground truth"):
        model.score_benchmark(str(ds2), str(tmp_path / "r2"))
    assert not os.path.isdir(tmp_path / "r2")
    five = FCN8s(num_classes=5, device="cpu", compute_dtype=torch.float32, **SMALL)
    ds = _benchmark_dir(tmp_path / "ds", h=32, w=64, cities=("c",), frames=1)
    with pytest.raises(ValueError, match="id_map is required"):
        five.score_benchmark(str(ds), str(tmp_path / "r3"))
    for f in (ds / "gtFine" / "val" / "c").glob("*instanceIds*"):
        f.unlink()
    export = tmp_path / "export.json"
    out = five.score_benchmark(str(ds), str(tmp_path / "r3"), id_map=np.array([0, 7, 11, 26, 24]),
                               instance_level=False, export_file=str(export), quiet=False)
    assert export.is_file() and np.asarray(out["confMatrix"]).sum() == 32 * 64


def test_facade_rest_imports_no_jax():
    """In a fresh interpreter the new modules, ``summary``,
    ``find_learning_rate``, ``predict_and_save`` and one ``score_benchmark``
    leave ``jax`` and the JAX package out of ``sys.modules``."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import numpy as np
        import torch
        from PIL import Image
        from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
        from fcn8s_tensorflow_tpu_torch.evaluation import instance_eval, pixel_eval
        from fcn8s_tensorflow_tpu_torch.labels import TRAINIDS_TO_RGBA_DICT
        from fcn8s_tensorflow_tpu_torch.utils import summary
        from fcn8s_tensorflow_tpu_torch.viz import overlay
        torch.set_num_threads(1)
        model = FCN8s(num_classes=20, width_mult=1 / 32, fc_channels=32,
                      compute_dtype=torch.float32, device="cpu")
        assert "fc7" in model.summary((64, 64))
        rng = np.random.default_rng(0)
        im = rng.integers(0, 256, (1, 32, 64, 3), np.uint8)
        lb = rng.integers(0, 20, (1, 32, 64), np.uint8)
        def gen():
            while True:
                yield im, lb
        assert len(model.find_learning_rate(gen(), steps=2)["losses"]) == 2
        root = tempfile.mkdtemp()
        img_dir = os.path.join(root, "leftImg8bit", "val", "c")
        gt_dir = os.path.join(root, "gtFine", "val", "c")
        os.makedirs(img_dir); os.makedirs(gt_dir)
        Image.fromarray(im[0]).save(os.path.join(img_dir, "c_000000_000000_leftImg8bit.png"))
        gt = np.full((32, 64), 7, np.uint8)
        Image.fromarray(gt).save(os.path.join(gt_dir, "c_000000_000000_gtFine_labelIds.png"))
        Image.fromarray(gt.astype(np.uint16)).save(
            os.path.join(gt_dir, "c_000000_000000_gtFine_instanceIds.png"))
        model.predict_and_save(os.path.join(root, "o"), img_dir, color_map=TRAINIDS_TO_RGBA_DICT,
                               include_unprocessed_image=True, on_device_overlay=False,
                               verbose=False)
        out = model.score_benchmark(root, os.path.join(root, "r"))
        assert np.asarray(out["confMatrix"]).sum() == 32 * 64
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
