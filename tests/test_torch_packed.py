"""PyTorch port, the packed dataset format against the JAX package on the CPU.

``pack_dataset`` of either package writes the same ``images.npy``,
``labels.npy`` and ``index.json``; a directory packed by either loads in
the other; the port's ``PackedDataset.generate`` equals its own
``BatchGenerator`` (the contract of ``tests/test_packed.py``) and the JAX
package's ``PackedDataset``, byte for byte, through shuffled epoch
boundaries and shards; the version and index guards raise as JAX's do.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from fcn8s_tensorflow_tpu.data import BatchGenerator as JBatchGenerator  # noqa: E402
from fcn8s_tensorflow_tpu.data import PackedDataset as JPackedDataset  # noqa: E402
from fcn8s_tensorflow_tpu.data import pack_dataset as j_pack  # noqa: E402
from fcn8s_tensorflow_tpu.labels import IDS_TO_TRAINIDS_ARRAY  # noqa: E402
from fcn8s_tensorflow_tpu_torch.data import BatchGenerator, PackedDataset  # noqa: E402
from fcn8s_tensorflow_tpu_torch.data import pack_dataset  # noqa: E402

FRAME = (40, 70)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("packed_tree")
    rng = np.random.default_rng(42)
    img_root, gt_root = root / "images", root / "gt"
    for city in ["aachen", "bochum"]:
        (img_root / city).mkdir(parents=True)
        (gt_root / city).mkdir(parents=True)
        for i in range(4):
            stem = f"{city}_{i:06d}_000019"
            img = rng.integers(0, 255, FRAME + (3,), dtype=np.uint8)
            gt = rng.integers(0, 34, FRAME, dtype=np.uint8)
            Image.fromarray(img).save(img_root / city / f"{stem}_leftImg8bit.png")
            Image.fromarray(gt).save(gt_root / city / f"{stem}_gtFine_labelIds.png")
    return {"img_root": str(img_root), "gt_root": str(gt_root), "tmp": root}


def _gen(tree, pkg="torch"):
    cls = JBatchGenerator if pkg == "jax" else BatchGenerator
    return cls(image_dirs=[tree["img_root"]], ground_truth_dirs=[tree["gt_root"]],
               image_name_split_separator="leftImg8bit", ground_truth_suffix="gtFine_labelIds",
               num_classes=20)


STATIC = {
    "plain": dict(),
    "remap_resize": dict(convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY, resize=(24, 48)),
    "remap_dict": dict(convert_ids_to_ids={7: 0, 8: 1, 26: 13}),
}


@pytest.fixture(scope="module")
def packs(tree, tmp_path_factory):
    """{(static case, packer): directory} for both packers."""
    out = {}
    for case, kw in STATIC.items():
        for pkg, pack in (("jax", j_pack), ("torch", pack_dataset)):
            directory = str(tmp_path_factory.mktemp(f"{case}_{pkg}"))
            pack(_gen(tree, pkg), directory, **kw)
            out[case, pkg] = directory
    return out


def _files(directory):
    arrays = {f: np.load(os.path.join(directory, f)) for f in ("images.npy", "labels.npy")}
    with open(os.path.join(directory, "index.json")) as f:
        return arrays, json.load(f)


@pytest.mark.parametrize("case", list(STATIC))
def test_pack_equals_jax_pack(packs, case):
    """Same arrays (shape, dtype, bytes) and the same index.json."""
    got, want = _files(packs[case, "torch"]), _files(packs[case, "jax"])
    for name, arr in want[0].items():
        assert got[0][name].dtype == arr.dtype and got[0][name].shape == arr.shape
        np.testing.assert_array_equal(got[0][name], arr)
    assert got[1] == want[1]


AUG = dict(void_class_id=0, brightness=(0.5, 1.5, 0.5), flip=0.5,
           translate=((1, 4), (1, 4), 0.5), scale=(0.8, 1.2, 0.5), contrast=(0.7, 1.3, 0.5))
GENERATE = {
    "one_hot_aug": dict(batch_size=3, convert_to_one_hot=True, shuffle=True, seed=99, **AUG),
    "ids_unshuffled": dict(batch_size=3, convert_to_one_hot=False, shuffle=False),
    "shard": dict(batch_size=2, convert_to_one_hot=False, shuffle=True, seed=7, flip=0.5,
                  shard=(1, 3)),
    "crop_gray_pad": dict(batch_size=2, convert_to_one_hot=False, seed=3, random_crop=(36, 60),
                          gray=True, pad_to_multiple=32, void_class_id=19),
}


def _batches(it, n=7):
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def _assert_batches_equal(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case, gen_case", [
    (case, gen_case) for case in ("plain", "remap_resize") for gen_case in GENERATE
    if case == "remap_resize" or not GENERATE[gen_case].get("convert_to_one_hot")])
def test_packed_generate_equals_batch_generator_and_jax(tree, packs, case, gen_case):
    """The port's PackedDataset against the port's BatchGenerator (with the
    static transforms at generate time) and against JAX's PackedDataset on
    JAX's pack, through > 2 shuffled epochs. (One-hot of 20 classes needs
    the trainId remap: raw labelIds reach 33. A pack resizes before
    generate's crops and BatchGenerator after them, so a resized pack is
    held against BatchGenerator only without crops.)"""
    kw = GENERATE[gen_case]
    got = _batches(PackedDataset(packs[case, "torch"], num_classes=20).generate(**kw))
    want = _batches(JPackedDataset(packs[case, "jax"], num_classes=20).generate(**kw))
    _assert_batches_equal(got, want)
    if "resize" not in STATIC[case] or "random_crop" not in kw:
        from_disk = _batches(_gen(tree).generate(**STATIC[case], **kw))
        _assert_batches_equal(got, from_disk)


@pytest.mark.parametrize("packer, reader", [("torch", "jax"), ("jax", "torch")])
def test_packed_directory_crosses_packages(packs, packer, reader):
    """A directory packed by one package loads in the other and streams the
    reader's own batches."""
    cls = JPackedDataset if reader == "jax" else PackedDataset
    same = JPackedDataset if packer == "jax" else PackedDataset
    kw = GENERATE["one_hot_aug"]
    got = _batches(cls(packs["remap_resize", packer], num_classes=20).generate(**kw), 4)
    want = _batches(same(packs["remap_resize", packer], num_classes=20).generate(**kw), 4)
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(ignore_label=0)])
def test_class_pixel_counts_equal_jax_and_generator(tree, packs, kw):
    got = PackedDataset(packs["remap_resize", "torch"]).class_pixel_counts(20, **kw)
    want = JPackedDataset(packs["remap_resize", "jax"]).class_pixel_counts(20, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    plain = PackedDataset(packs["plain", "torch"]).class_pixel_counts(34)
    np.testing.assert_array_equal(plain, _gen(tree).class_pixel_counts(34))


def _raise_messages(fn):
    msgs = []
    for pkg in ("jax", "torch"):
        with pytest.raises(Exception) as info:
            fn(pkg)
        msgs.append((type(info.value).__name__, str(info.value)))
    assert msgs[0] == msgs[1]
    return msgs[1]


def test_version_and_missing_index_guards(tree, packs, tmp_path):
    name, msg = _raise_messages(
        lambda pkg: (JPackedDataset if pkg == "jax" else PackedDataset)(str(tmp_path)))
    assert name == "DataError" and "not a packed dataset" in msg
    bad = tmp_path / "bad"
    bad.mkdir()
    for f in ("images.npy", "labels.npy", "index.json"):
        (bad / f).write_bytes(open(os.path.join(packs["plain", "torch"], f), "rb").read())
    index = json.loads((bad / "index.json").read_text())
    index["format_version"] = 999
    (bad / "index.json").write_text(json.dumps(index))
    name, msg = _raise_messages(
        lambda pkg: (JPackedDataset if pkg == "jax" else PackedDataset)(str(bad)))
    assert "format_version" in msg
    index["format_version"], index["count"] = 1, 9
    (bad / "index.json").write_text(json.dumps(index))
    name, msg = _raise_messages(
        lambda pkg: (JPackedDataset if pkg == "jax" else PackedDataset)(str(bad)))
    assert name == "DataError" and "index.json says 9" in msg


def test_generate_guards_raise_like_jax(packs):
    for kw in (dict(batch_size=1, hue=(0.1, 0.2, 0.3)), dict(batch_size=1, shard=(0, 9),
                                                             shuffle=False),
               dict(batch_size=1, shard=(0, 2))):
        _raise_messages(lambda pkg: next(
            (JPackedDataset if pkg == "jax" else PackedDataset)(
                packs["plain", pkg], num_classes=20).generate(convert_to_one_hot=False, **kw)))
    _raise_messages(lambda pkg: next(
        (JPackedDataset if pkg == "jax" else PackedDataset)(packs["plain", pkg]).generate(1)))


def test_nonuniform_sizes_raise(tmp_path):
    img_root, gt_root = tmp_path / "images" / "c", tmp_path / "gt" / "c"
    img_root.mkdir(parents=True)
    gt_root.mkdir(parents=True)
    for name, hw in (("a", (8, 8)), ("b", (8, 10))):
        Image.fromarray(np.zeros(hw + (3,), np.uint8)).save(img_root / f"{name}_leftImg8bit.png")
        Image.fromarray(np.zeros(hw, np.uint8)).save(gt_root / f"{name}_gtFine_labelIds.png")
    t = {"img_root": str(tmp_path / "images"), "gt_root": str(tmp_path / "gt")}
    name, msg = _raise_messages(
        lambda pkg: (j_pack if pkg == "jax" else pack_dataset)(_gen(t, pkg),
                                                                str(tmp_path / f"out_{pkg}")))
    assert name == "DataError" and "uniform size" in msg
