"""PyTorch port, the host data pipeline against the JAX package on the CPU.

``fcn8s_tensorflow_tpu_torch/data`` computes OpenCV's results with numpy;
the JAX package's ``data/`` calls OpenCV (here cv2 5.0.0). Every comparison
is exact — same shapes, dtypes and bytes — for the conversions, each
transform, the generator's batches under every option set of
``tests/test_data.py`` (``workers`` and ``shard`` included), ``process_all``'s
files, ``class_pixel_counts`` and the KITTI generator. The torch
conversions equal their ``jax_*`` counterparts exactly too. Two steps of
the port's ``FCN8s`` fed by the port's generator end with the params of two
steps fed by the JAX package's generator, bit for bit (the batches are the
same bytes).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.data import augment as J  # noqa: E402
from fcn8s_tensorflow_tpu.data import conversions as JC  # noqa: E402
from fcn8s_tensorflow_tpu.data.generator import BatchGenerator as JBatchGenerator  # noqa: E402
from fcn8s_tensorflow_tpu.data.generator import DataError as JDataError  # noqa: E402
from fcn8s_tensorflow_tpu.data.generator import apply_augmentations as j_apply  # noqa: E402
from fcn8s_tensorflow_tpu.data.kitti import batch_generator as j_kitti  # noqa: E402
from fcn8s_tensorflow_tpu.labels import IDS_TO_TRAINIDS_ARRAY  # noqa: E402
from fcn8s_tensorflow_tpu.labels import TRAINIDS_TO_COLORS_ARRAY  # noqa: E402
from fcn8s_tensorflow_tpu_torch.data import augment as T  # noqa: E402
from fcn8s_tensorflow_tpu_torch.data import conversions as TC  # noqa: E402
from fcn8s_tensorflow_tpu_torch.data.generator import BatchGenerator, DataError  # noqa: E402
from fcn8s_tensorflow_tpu_torch.data.generator import apply_augmentations  # noqa: E402
from fcn8s_tensorflow_tpu_torch.data.kitti import batch_generator as t_kitti  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = (48, 100)  # 100 = 3 x 32 + 4: brightness's vector blocks and its scalar tail
CITIES = ("aachen", "bochum")
PER_CITY = 4
# one colour per class id for the colour-GT tree (ids 0..19)
COLORS = {i: tuple(int(c) for c in TRAINIDS_TO_COLORS_ARRAY[i]) for i in range(19)}


def _write_tree(root, rng, gt_kind="ids"):
    """images/<city>/*_leftImg8bit.png + gt/<city>/*_gtFine_labelIds.png,
    piecewise-smooth images; ``gt_kind`` 'ids' (uint8 labelIds 0..33),
    'ids16' (uint16 ids) or 'colors' (RGB colour GT of 19 classes)."""
    img_root, gt_root = root / "images", root / "gt"
    h, w = FRAME
    for city in CITIES:
        (img_root / city).mkdir(parents=True)
        (gt_root / city).mkdir(parents=True)
        for i in range(PER_CITY):
            stem = f"{city}_{i:06d}_000019"
            base = rng.integers(0, 256, (6, 10, 3)).astype(np.uint8)
            img = np.repeat(np.repeat(base, 8, 0), 10, 1)[:h, :w]
            img = np.clip(img.astype(np.int16) + rng.integers(-6, 7, img.shape), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(img_root / city / f"{stem}_leftImg8bit.png")
            ids = np.repeat(np.repeat(rng.integers(0, 34, (6, 10)), 8, 0), 10, 1)[:h, :w]
            if gt_kind == "ids":
                gt = ids.astype(np.uint8)
            elif gt_kind == "ids16":
                gt = (ids * 97).astype(np.uint16)  # ids up to 3201
            else:
                gt = TRAINIDS_TO_COLORS_ARRAY[ids % 19].astype(np.uint8)
            Image.fromarray(gt).save(gt_root / city / f"{stem}_gtFine_labelIds.png")
    return {"img_root": str(img_root), "gt_root": str(gt_root), "tmp": root}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("cityscapes"), np.random.default_rng(42))


def _gens(tree, **kw):
    """The JAX package's and the port's generator over ``tree``."""
    args = dict(image_dirs=[tree["img_root"]], ground_truth_dirs=[tree["gt_root"]],
                image_name_split_separator="leftImg8bit",
                ground_truth_suffix="gtFine_labelIds", num_classes=20, **kw)
    return JBatchGenerator(**args), BatchGenerator(**args)


def _assert_same(got, want):
    """Same nesting, shapes, dtypes and bytes."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    if want is None:
        assert got is None
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


def _take(it, n):
    out = [next(it) for _ in range(n)]
    it.close()
    return out


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------
_IDS = np.random.default_rng(0).integers(0, 34, (2, 9, 11)).astype(np.uint8)
_COLOR_TO_ID = {c: i for i, c in COLORS.items()}
_COLOR_IMG = TRAINIDS_TO_COLORS_ARRAY[_IDS[0] % 19].astype(np.uint8)


@pytest.mark.parametrize("name, args", [
    ("convert_ids_to_ids", (_IDS, IDS_TO_TRAINIDS_ARRAY)),
    ("convert_ids_to_ids_partial", (_IDS, {7: 0, 8: 1, 26: 13, 33: 255})),
    ("convert_between_ids_and_colors", (_COLOR_IMG, _COLOR_TO_ID)),
    ("convert_between_ids_and_colors", (_IDS[0] % 19, COLORS)),
    ("convert_ids_to_colors", (_IDS % 19, TRAINIDS_TO_COLORS_ARRAY)),
    ("convert_one_hot_to_ids", (np.eye(34, dtype=np.int32)[_IDS],)),
    ("convert_ids_to_one_hot", (_IDS, 34)),
])
def test_numpy_conversions_equal_jax(name, args):
    _assert_same(getattr(TC, name)(*args), getattr(JC, name)(*args))


@pytest.mark.parametrize("name, args", [
    ("convert_ids_to_ids", (IDS_TO_TRAINIDS_ARRAY,)),
    ("convert_ids_to_one_hot", (34,)),
    ("convert_ids_to_colors", (TRAINIDS_TO_COLORS_ARRAY,)),
])
def test_torch_conversions_equal_jax(name, args):
    ids = _IDS % (20 if name == "convert_ids_to_colors" else 34)
    got = getattr(TC, "torch_" + name)(torch.from_numpy(ids), *args).numpy()
    want = np.asarray(getattr(JC, "jax_" + name)(jnp.asarray(ids), *args))
    np.testing.assert_array_equal(got, want)


def test_torch_one_hot_dtype_and_device():
    out = TC.torch_convert_ids_to_one_hot(torch.from_numpy(_IDS), 34, dtype=torch.int32)
    assert out.dtype == torch.int32 and out.device.type == "cpu" and out.shape == _IDS.shape + (34,)


# ---------------------------------------------------------------------------
# transforms, each against the JAX package's OpenCV calls
# ---------------------------------------------------------------------------
def _gt(kind, rng, h, w):
    if kind == "ids":
        return rng.integers(0, 34, (h, w)).astype(np.uint8)
    if kind == "ids16":
        return rng.integers(0, 5000, (h, w)).astype(np.uint16)
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


GT_KINDS = ["ids", "ids16", "colors"]
SHAPES = [(5, 7), (31, 33), (48, 100), (64, 64), (17, 129)]


@pytest.mark.parametrize("gt_kind", GT_KINDS)
@pytest.mark.parametrize("size", [(24, 50), (96, 200), (31, 17), (5, 301)])
def test_resize_pair_equals_cv2(size, gt_kind):
    rng = np.random.default_rng(size[0] * 1000 + size[1])
    image = rng.integers(0, 256, (48, 100, 3)).astype(np.uint8)
    gt = _gt(gt_kind, rng, 48, 100)
    _assert_same(T.resize_pair(image, gt, size), J.resize_pair(image, gt, size))


def test_resize_pair_full_frame_equals_cv2():
    """A 1024x2048 Cityscapes frame to the flagship 512x1024."""
    rng = np.random.default_rng(5)
    image = np.repeat(np.repeat(rng.integers(0, 256, (64, 128, 3)).astype(np.uint8), 16, 0), 16, 1)
    gt = np.repeat(np.repeat(rng.integers(0, 34, (64, 128)).astype(np.uint8), 16, 0), 16, 1)
    _assert_same(T.resize_pair(image, gt, (512, 1024)), J.resize_pair(image, gt, (512, 1024)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", SHAPES + [(4, 2048)])
def test_brightness_equals_cv2(shape, seed):
    """The HSV round trip, exact: OpenCV's vector blocks and scalar tail."""
    image = np.random.default_rng(seed).integers(0, 256, shape + (3,)).astype(np.uint8)
    got = T.brightness_hsv(np.random.default_rng(seed), image, 0.5, 1.6)
    want = J.brightness_hsv(np.random.default_rng(seed), image, 0.5, 1.6)
    _assert_same(got, want)


def test_hsv_round_trip_equals_cv2_on_every_value():
    """RGB -> HSV on all 2^24 colours and HSV -> RGB on all 180 x 2^16
    triples, laid out 4096 wide (OpenCV's vector path) and 31 wide (its
    scalar path), in chunks of 2^20 pixels."""
    import cv2

    v = np.arange(256, dtype=np.uint8)
    for r in range(0, 256, 16):
        rgb = np.stack(np.meshgrid(v[r:r + 16], v, v, indexing="ij"), -1).reshape(-1, 4096, 3)
        np.testing.assert_array_equal(T.rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hues = np.arange(180, dtype=np.uint8)
    for h in range(0, 180, 16):
        hsv = np.stack(np.meshgrid(hues[h:h + 16], v, v, indexing="ij"), -1).reshape(-1, 3)
        for width in (4096, 31):
            x = hsv[: len(hsv) // width * width].reshape(-1, width, 3)
            np.testing.assert_array_equal(T.hsv_to_rgb_u8(x), cv2.cvtColor(x, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("gt_kind", GT_KINDS + [None])
def test_flip_equals_cv2(gt_kind):
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, (31, 33, 3)).astype(np.uint8)
    gt = None if gt_kind is None else _gt(gt_kind, rng, 31, 33)
    _assert_same(T.horizontal_flip(image, gt), J.horizontal_flip(image, gt))


@pytest.mark.parametrize("gt_kind", GT_KINDS)
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ranges", [((0, 9), (0, 9)), ((40, 120), (0, 60))])
def test_translate_equals_cv2(ranges, seed, gt_kind):
    """Integer shifts, inside and past the frame; void 250 (uint8) or 4000
    (uint16) on the GT, OpenCV's (void, 0, 0) on a colour GT."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (48, 100, 3)).astype(np.uint8)
    gt = _gt(gt_kind, rng, 48, 100)
    void = 4000 if gt_kind == "ids16" else 250
    got = T.translate(np.random.default_rng(seed), image, gt, *ranges, void)
    want = J.translate(np.random.default_rng(seed), image, gt, *ranges, void)
    _assert_same(got, want)


@pytest.mark.parametrize("gt_kind", ["ids", "ids16", None])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(48, 100), (31, 33)])
@pytest.mark.parametrize("factors", [(0.6, 0.95), (1.05, 1.5)])
def test_scale_zoom_equals_cv2(factors, shape, seed, gt_kind):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    gt = None if gt_kind is None else _gt(gt_kind, rng, *shape)
    got = T.scale_zoom(np.random.default_rng(seed), image, gt, *factors, 7)
    want = J.scale_zoom(np.random.default_rng(seed), image, gt, *factors, 7)
    _assert_same(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_grayscale_equals_cv2(shape):
    image = np.random.default_rng(shape[1]).integers(0, 256, shape + (3,)).astype(np.uint8)
    _assert_same(T.grayscale(image), J.grayscale(image))


@pytest.mark.parametrize("gt_kind", GT_KINDS)
@pytest.mark.parametrize("crop_hw", [(20, 40), (60, 40), (20, 130), (64, 128)])
def test_random_and_fixed_crop_equal_jax(crop_hw, gt_kind):
    """Crops smaller than the image, and larger in one or both dims (the
    image placed on a black / void canvas)."""
    rng = np.random.default_rng(crop_hw[0] + crop_hw[1])
    image = rng.integers(0, 256, (48, 100, 3)).astype(np.uint8)
    gt = _gt(gt_kind, rng, 48, 100)
    got = T.random_crop_with_void(np.random.default_rng(3), image, gt, crop_hw, 9)
    want = J.random_crop_with_void(np.random.default_rng(3), image, gt, crop_hw, 9)
    _assert_same(got, want)
    _assert_same(T.fixed_crop(image, gt, (3, 5, 7, 2)), J.fixed_crop(image, gt, (3, 5, 7, 2)))


@pytest.mark.parametrize("name, args", [("contrast", (0.5, 1.6)), ("saturation", (0.2, 1.8)),
                                        ("gamma", (0.5, 2.0)), ("hue_rotate", (0.4,))])
def test_photometric_extras_equal_jax(name, args):
    image = np.random.default_rng(4).integers(0, 256, (31, 33, 3)).astype(np.uint8)
    for seed in range(3):
        got = getattr(T, name)(np.random.default_rng(seed), image, *args)
        want = getattr(J, name)(np.random.default_rng(seed), image, *args)
        _assert_same(got, want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("gt_kind", ["ids", "ids16"])
def test_apply_augmentations_equal_jax(seed, gt_kind):
    """The whole pipeline, every option on, in the reference's order."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (48, 100, 3)).astype(np.uint8)
    gt = _gt(gt_kind, rng, 48, 100)
    kw = dict(random_crop=(40, 90), crop=(1, 2, 3, 4), resize=(40, 72),
              brightness=(0.6, 1.4, 0.7), contrast=(0.7, 1.3, 0.5),
              saturation=(0.6, 1.4, 0.5), hue=(0.1, 0.5), gamma=(0.7, 1.4, 0.5),
              flip=0.5, translate=((0, 8), (0, 8), 0.7), scale=(0.8, 1.25, 0.7),
              gray=seed == 3, void_class_id=3)
    got = apply_augmentations(image, gt, np.random.default_rng(seed), **kw)
    want = j_apply(image, gt, np.random.default_rng(seed), **kw)
    _assert_same(got, want)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------
AUG = dict(flip=0.5, brightness=(0.7, 1.3, 0.5), translate=((0, 6), (0, 4), 0.5),
           scale=(0.8, 1.2, 0.5), void_class_id=0)
GENERATE_CASES = {
    "one_hot": dict(batch_size=3, seed=0, convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY),
    "id_maps": dict(batch_size=3, convert_to_one_hot=False, seed=1),
    "resize_remap": dict(batch_size=2, resize=(24, 48), convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY,
                         convert_to_one_hot=False, seed=2),
    "remap_dict": dict(batch_size=2, convert_ids_to_ids={7: 0, 8: 1, 26: 13},
                       convert_to_one_hot=False, shuffle=False),
    "pad_to_multiple": dict(batch_size=2, pad_to_multiple=32, void_class_id=0,
                            convert_to_one_hot=False, shuffle=False),
    "augmentations": dict(batch_size=3, convert_to_one_hot=False, seed=123,
                          convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY, resize=(40, 80), **AUG),
    "crops_gray": dict(batch_size=3, convert_to_one_hot=False, seed=4, random_crop=(56, 90),
                       crop=(2, 2, 4, 4), gray=True, void_class_id=255),
    "photometric": dict(batch_size=2, convert_to_one_hot=False, seed=1,
                        contrast=(1.8, 1.8, 1.0), gamma=(0.5, 0.5, 1.0),
                        saturation=(0.2, 0.2, 1.0), hue=(0.3, 1.0)),
    "epoch_wrap": dict(batch_size=3, convert_to_one_hot=False, shuffle=False),
    "workers3": dict(batch_size=3, convert_to_one_hot=False, seed=7, workers=3, resize=(32, 64),
                     **AUG),
    "shard_even": dict(batch_size=1, convert_to_one_hot=False, seed=11, shard=(1, 2), **AUG),
    "shard_uneven": dict(batch_size=1, convert_to_one_hot=False, seed=5, shard=(2, 3), **AUG),
    "shard_workers": dict(batch_size=2, convert_to_one_hot=False, seed=13, shard=(0, 3),
                          workers=2, **AUG),
    "shard_unshuffled": dict(batch_size=2, convert_to_one_hot=False, shuffle=False, shard=(1, 3)),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_equals_jax(tree, case):
    """Batches across two epoch boundaries, byte for byte."""
    kw = GENERATE_CASES[case]
    jgen, tgen = _gens(tree)
    n = 2 * -(-8 // kw["batch_size"]) + 1
    for got, want in zip(_take(tgen.generate(**kw), n), _take(jgen.generate(**kw), n)):
        _assert_same(got, want)


@pytest.mark.parametrize("gt_kind, kw", [
    ("ids16", dict(convert_to_one_hot=False, resize=(24, 50), **AUG)),
    ("colors", dict(convert_colors_to_ids=_COLOR_TO_ID, convert_to_one_hot=True, **AUG)),
    ("colors", dict(convert_to_one_hot=False, flip=0.5, translate=((0, 30), (0, 20), 1.0),
                    void_class_id=19)),
])
def test_generate_uint16_and_colour_gt_equal_jax(tmp_path, gt_kind, kw):
    t = _write_tree(tmp_path, np.random.default_rng(3), gt_kind)
    jgen, tgen = _gens(t)
    for got, want in zip(_take(tgen.generate(batch_size=3, seed=9, **kw), 4),
                         _take(jgen.generate(batch_size=3, seed=9, **kw), 4)):
        _assert_same(got, want)


def test_images_only_generator_equals_jax(tree):
    args = dict(image_dirs=[tree["img_root"]])
    got = _take(BatchGenerator(**args).generate(batch_size=3, convert_to_one_hot=False, seed=2,
                                                flip=0.5), 3)
    want = _take(JBatchGenerator(**args).generate(batch_size=3, convert_to_one_hot=False,
                                                  seed=2, flip=0.5), 3)
    for g, w in zip(got, want):
        _assert_same(g, w)


def _raises_like_jax(make, call=None):
    """Both packages raise the same exception type with the same message."""
    errors = []
    for pkg in ("jax", "torch"):
        with pytest.raises(Exception) as info:
            obj = make(pkg)
            if call is not None:
                call(obj)
        errors.append(info.value)
    assert type(errors[0]).__name__ == type(errors[1]).__name__
    assert str(errors[0]) == str(errors[1])
    return errors[1]


def _make(tree, pkg, **kw):
    cls = JBatchGenerator if pkg == "jax" else BatchGenerator
    return cls(image_dirs=[tree["img_root"]], ground_truth_dirs=[tree["gt_root"]],
               image_name_split_separator="leftImg8bit", ground_truth_suffix="gtFine_labelIds",
               num_classes=20, **kw)


@pytest.mark.parametrize("case", ["one_hot_without_classes", "convert_without_gt", "hue_triple",
                                  "shard_index", "shard_without_seed", "shard_past_dataset"])
def test_generate_guards_raise_like_jax(tree, case):
    def gen(pkg, **kw):
        return _make(tree, pkg, **kw)

    calls = {
        "one_hot_without_classes": (
            lambda pkg: (JBatchGenerator if pkg == "jax" else BatchGenerator)(
                image_dirs=[tree["img_root"]], ground_truth_dirs=[tree["gt_root"]],
                image_name_split_separator="leftImg8bit", ground_truth_suffix="gtFine_labelIds"),
            dict(batch_size=1)),
        "convert_without_gt": (
            lambda pkg: (JBatchGenerator if pkg == "jax" else BatchGenerator)(
                image_dirs=[tree["img_root"]]), dict(batch_size=1)),
        "hue_triple": (gen, dict(batch_size=1, convert_to_one_hot=False, hue=(0.1, 0.5, 1.0))),
        "shard_index": (gen, dict(batch_size=1, convert_to_one_hot=False, shuffle=False,
                                  shard=(2, 2))),
        "shard_without_seed": (gen, dict(batch_size=1, convert_to_one_hot=False, shard=(0, 2))),
        "shard_past_dataset": (gen, dict(batch_size=1, convert_to_one_hot=False, shuffle=False,
                                         shard=(0, 9))),
    }
    make, kw = calls[case]
    err = _raises_like_jax(make, lambda g: next(g.generate(**kw)))
    assert isinstance(err, DataError if case == "shard_past_dataset" else ValueError)


@pytest.mark.parametrize("case", ["missing_gt", "empty", "dir_count"])
def test_discovery_guards_raise_like_jax(tmp_path, case):
    t = _write_tree(tmp_path / "t", np.random.default_rng(1))
    if case == "missing_gt":
        os.remove(os.path.join(t["gt_root"], "aachen", "aachen_000001_000019_gtFine_labelIds.png"))
        make = lambda pkg: _make(t, pkg)  # noqa: E731
    elif case == "empty":
        (tmp_path / "empty").mkdir()
        make = lambda pkg: (JBatchGenerator if pkg == "jax" else BatchGenerator)(  # noqa: E731
            image_dirs=[str(tmp_path / "empty")])
    else:
        make = lambda pkg: (JBatchGenerator if pkg == "jax" else BatchGenerator)(  # noqa: E731
            image_dirs=[t["img_root"]], ground_truth_dirs=[t["gt_root"], t["gt_root"]])
    err = _raises_like_jax(make)
    assert isinstance(err, ValueError if case == "dir_count" else DataError)
    assert not isinstance(err, JDataError)


def test_process_all_writes_the_same_files(tree, tmp_path, capsys):
    """``process_all`` with its deterministic transforms (``generate``
    draws from an unseeded stream there) mirrors the tree into files with
    the JAX package's exact pixels."""
    out = {}
    for pkg in ("jax", "torch"):
        export = str(tmp_path / pkg)
        gen = _make(tree, pkg, root_dir=str(tree["tmp"]), export_dir=export)
        gen.process_all(resize=(24, 50), convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY,
                        crop=(1, 3, 2, 5), batch_size=3)
        files = sorted(os.path.relpath(os.path.join(d, f), export)
                       for d, _, fs in os.walk(export) for f in fs)
        out[pkg] = {f: np.asarray(Image.open(os.path.join(export, f))) for f in files}
    assert list(out["torch"]) == list(out["jax"]) and len(out["jax"]) == 16
    for f, want in out["jax"].items():
        _assert_same(out["torch"][f], want)
    assert "Processing images: 3/3" in capsys.readouterr().out


@pytest.mark.parametrize("kw", [dict(), dict(ids_to_classes=IDS_TO_TRAINIDS_ARRAY,
                                             ignore_label=0)])
def test_class_pixel_counts_equal_jax(tree, kw):
    jgen, tgen = _gens(tree)
    num_classes = 34 if not kw else 20
    _assert_same(tgen.class_pixel_counts(num_classes, **kw),
                 jgen.class_pixel_counts(num_classes, **kw))


def test_class_pixel_counts_out_of_range_raises_like_jax(tree):
    err = _raises_like_jax(lambda pkg: _make(tree, pkg), lambda g: g.class_pixel_counts(20))
    assert isinstance(err, DataError)


# ---------------------------------------------------------------------------
# KITTI
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    img_dir, gt_dir = root / "image_2", root / "gt_image_2"
    img_dir.mkdir()
    gt_dir.mkdir()
    rng = np.random.default_rng(4)
    for i in range(5):
        img = rng.integers(0, 256, (37, 124, 3)).astype(np.uint8)
        gt = np.full((37, 124, 3), [255, 0, 0], dtype=np.uint8)
        gt[rng.integers(10, 30):, rng.integers(0, 60):] = [255, 0, 255]
        Image.fromarray(img).save(img_dir / f"um_{i:06d}.png")
        Image.fromarray(gt).save(gt_dir / f"um_road_{i:06d}.png")
    return str(img_dir), str(gt_dir)


@pytest.mark.parametrize("one_hot", [True, False])
@pytest.mark.parametrize("resize", [False, (32, 115)])
def test_kitti_equals_jax(kitti_tree, one_hot, resize):
    kw = dict(resize=resize, flip=0.5, seed=3, one_hot=one_hot)
    got = _take(t_kitti(2, *kitti_tree, **kw), 6)
    want = _take(j_kitti(2, *kitti_tree, **kw), 6)
    for g, w in zip(got, want):
        _assert_same(g, w)


# ---------------------------------------------------------------------------
# into the facade, and imports
# ---------------------------------------------------------------------------
def test_generator_feeds_train_like_jax_generator(tree):
    """Two ``FCN8s.train`` steps at keep_prob 1 fed by the port's generator
    end with the params of two steps fed by the JAX package's generator."""
    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s

    kw = dict(batch_size=2, convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY, convert_to_one_hot=False,
              void_class_id=0, resize=(32, 64), seed=6, **{k: v for k, v in AUG.items()
                                                            if k != "void_class_id"})
    params = []
    for gen in _gens(tree):
        model = FCN8s(num_classes=20, width_mult=1 / 32, fc_channels=32, seed=1,
                      compute_dtype=torch.float32, device="cpu")
        model.train(gen.generate(**kw), epochs=1, steps_per_epoch=2,
                    learning_rate_schedule=lambda s: 1e-3, keep_prob=1.0,
                    record_summaries=False)
        params.append(bridge.param_leaves(model.params))
        model.close()
    for a, b in zip(*params):
        assert torch.equal(a, b)


def test_data_export_and_pool_import_no_jax_or_cv2():
    """In a fresh interpreter, the port's data pipeline, export and pool op
    leave ``jax``, ``cv2`` and the JAX package out of ``sys.modules``.
    (``import torch`` itself may load tqdm, through ``torch.hub``.)"""
    code = textwrap.dedent("""
        import sys
        import fcn8s_tensorflow_tpu_torch.data
        import fcn8s_tensorflow_tpu_torch.data.augment
        import fcn8s_tensorflow_tpu_torch.data.kitti
        import fcn8s_tensorflow_tpu_torch.engine.export
        import fcn8s_tensorflow_tpu_torch.ops.pool
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "cv2", "fcn8s_tensorflow_tpu"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_port_module_imports_jax_cv2_or_tqdm():
    """No import statement of the port names jax, tqdm or the JAX package,
    at any level of any module; cv2 only inside the three functions of
    ``viz/overlay.py`` whose output is OpenCV's own (split-view captions and
    the two MPEG-4 writers), and there in each of them."""
    import ast

    package = os.path.join(REPO, "fcn8s_tensorflow_tpu_torch")
    cv2_allowed = {(os.path.join("viz", "overlay.py"), f) for f in
                   ("create_split_view", "segment_video", "create_video_from_images")}
    found, cv2_sites = [], set()

    def visit(node, rel, func):
        for child in ast.iter_child_nodes(node):
            names = ([a.name for a in child.names] if isinstance(child, ast.Import) else
                     [child.module or ""] if isinstance(child, ast.ImportFrom) and not child.level
                     else [])
            for n in names:
                if n.split(".")[0] == "cv2" and (rel, func) in cv2_allowed:
                    cv2_sites.add((rel, func))
                elif n.split(".")[0] in ("jax", "jaxlib", "cv2", "tqdm", "fcn8s_tensorflow_tpu"):
                    found.append((rel, func, n))
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            visit(child, rel, inner)

    for d, _, files in os.walk(package):
        for f in (f for f in files if f.endswith(".py")):
            path = os.path.join(d, f)
            visit(ast.parse(open(path).read(), path), os.path.relpath(path, package), None)
    assert not found, found
    assert cv2_sites == cv2_allowed
