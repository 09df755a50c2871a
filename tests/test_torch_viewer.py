"""PyTorch port, ``viz/viewer.py`` and ``viz/serve.py`` against the JAX
package's.

Tolerances: none. ``disparity_to_rgb`` equals the JAX function (which
builds its plasma table with matplotlib) on all 65,536 uint16 values,
colormapped and gray. Panels, contact sheets and the loaders return equal
arrays. The gallery, ``view_cityscapes_split`` and the interactive viewer
write the same file names with the same bytes (PNG files and HTML text),
and ``serve_viewer`` returns the files' bytes over HTTP.
"""

import os
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from fcn8s_tensorflow_tpu.viz import serve as j_serve
from fcn8s_tensorflow_tpu.viz import viewer as j_viewer
from fcn8s_tensorflow_tpu_torch.viz import serve, viewer

CMAP = {0: (0, 0, 0, 0), 1: (255, 0, 0, 127), 2: (0, 255, 0, 255)}


def _files(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


def _assert_same_dirs(got, want):
    a, b = _files(got), _files(want)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name


# ---------------------------------------------------------------------------
# disparity and panels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("colormapped", [True, False])
def test_disparity_to_rgb_equals_jax_on_every_uint16(colormapped):
    disp = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    got = viewer.disparity_to_rgb(disp, colormapped=colormapped)
    want = j_viewer.disparity_to_rgb(disp, colormapped=colormapped)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (256, 256, 3)
    np.testing.assert_array_equal(got, want)


def test_plasma_table_is_the_jax_packages_table():
    assert viewer.PLASMA_LUT.shape == (256, 3) and viewer.PLASMA_LUT.dtype == np.uint8
    ramp = (np.arange(256, dtype=np.int64) * 128).reshape(16, 16)
    np.testing.assert_array_equal(viewer.PLASMA_LUT.reshape(16, 16, 3),
                                  j_viewer.disparity_to_rgb(ramp))


@pytest.mark.parametrize("disp_in", ["int32_negative_and_large", "float"])
def test_disparity_to_rgb_clips_like_jax(rng, disp_in):
    if disp_in == "float":
        disp = rng.uniform(-500, 40000, (9, 11))
    else:
        disp = rng.integers(-70000, 70000, (9, 11)).astype(np.int32)
    for colormapped in (True, False):
        np.testing.assert_array_equal(viewer.disparity_to_rgb(disp, colormapped=colormapped),
                                      j_viewer.disparity_to_rgb(disp, colormapped=colormapped))


@pytest.mark.parametrize("parts", ["image", "gt", "gt_pred", "pred_disp", "all", "cityscapes"])
def test_render_panel_equals_jax(rng, parts):
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    ids = rng.integers(0, 3, (16, 24), dtype=np.uint8)
    kw = {"color_map": None if parts == "cityscapes" else CMAP}
    if parts in ("gt", "gt_pred", "all", "cityscapes"):
        kw["gt_ids"] = ids
    if parts in ("gt_pred", "pred_disp", "all", "cityscapes"):
        kw["pred_ids"] = rng.integers(0, 20 if parts == "cityscapes" else 3, (16, 24))
    if parts in ("pred_disp", "all"):
        kw["disparity"] = rng.integers(0, 30000, (16, 24)).astype(np.uint16)
    got, want = viewer.render_panel(img, **kw), j_viewer.render_panel(img, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("columns,pad", [(1, 4), (2, 2), (3, 0), (5, 7)])
def test_contact_sheet_equals_jax(rng, columns, pad):
    panels = [rng.integers(0, 256, (int(rng.integers(5, 12)), int(rng.integers(8, 20)), 3),
                           dtype=np.uint8) for _ in range(5)]
    np.testing.assert_array_equal(viewer.contact_sheet(panels, columns, pad),
                                  j_viewer.contact_sheet(panels, columns, pad))


def test_contact_sheet_of_nothing_raises_as_jax():
    with pytest.raises(ValueError) as got:
        viewer.contact_sheet([])
    with pytest.raises(ValueError) as want:
        j_viewer.contact_sheet([])
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------
@pytest.fixture
def city_tree(tmp_path):
    """leftImg8bit/val/c (3 frames), gtFine labelTrainIds for frame 0,
    labelIds for frame 1 and nothing for frame 2, disparity for frames 0
    and 2, and a results directory with an exact and a suffixed prediction."""
    rng = np.random.default_rng(7)
    root = tmp_path / "cs"
    for sub in ("leftImg8bit", "gtFine", "disparity"):
        (root / sub / "val" / "c").mkdir(parents=True)
    results = tmp_path / "results"
    results.mkdir()
    for i in range(3):
        stem = f"c_{i:06d}_000019"
        Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)).save(
            root / "leftImg8bit" / "val" / "c" / f"{stem}_leftImg8bit.png")
        if i == 0:
            Image.fromarray(rng.integers(0, 20, (16, 24), dtype=np.uint8)).save(
                root / "gtFine" / "val" / "c" / f"{stem}_gtFine_labelTrainIds.png")
        if i == 1:
            Image.fromarray(rng.integers(0, 34, (16, 24), dtype=np.uint8)).save(
                root / "gtFine" / "val" / "c" / f"{stem}_gtFine_labelIds.png")
        if i != 1:
            Image.fromarray(rng.integers(0, 30000, (16, 24)).astype(np.uint16)).save(
                root / "disparity" / "val" / "c" / f"{stem}_disparity.png")
        Image.fromarray(rng.integers(0, 20, (16, 24), dtype=np.uint8)).save(
            results / f"{stem}{'' if i == 0 else '_pred'}.png")
    Image.fromarray(rng.integers(0, 20, (16, 24), dtype=np.uint8)).save(
        results / "c_000000_000019_zzz.png")  # a suffixed variant the exact name beats
    return root, results


def _images(root):
    d = root / "leftImg8bit" / "val" / "c"
    return [str(d / n) for n in sorted(os.listdir(d))]


def test_load_prediction_equals_jax(city_tree, tmp_path):
    root, results = city_tree
    for path in _images(root):
        got, want = viewer.load_prediction(path, str(results)), j_viewer.load_prediction(
            path, str(results))
        np.testing.assert_array_equal(got, want)
    assert viewer.load_prediction(_images(root)[0], str(tmp_path)) is None


@pytest.mark.parametrize("convention", ["path", "root"])
def test_load_disparity_equals_jax(city_tree, convention):
    root, _ = city_tree
    disp_root = None if convention == "path" else str(root / "disparity")
    seen = 0
    odd = "/elsewhere/not_a_cityscapes_name.png"
    if disp_root is not None:  # the core-name search cannot parse it: both raise
        with pytest.raises(ValueError) as got:
            viewer.load_disparity(odd, disp_root)
        with pytest.raises(ValueError) as want:
            j_viewer.load_disparity(odd, disp_root)
        assert str(got.value) == str(want.value)
    for path in _images(root) + ([odd] if disp_root is None else []):
        got = viewer.load_disparity(path, disp_root)
        want = j_viewer.load_disparity(path, disp_root)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
            seen += 1
    assert seen == 2


# ---------------------------------------------------------------------------
# files: gallery, split browser, interactive viewer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["gt", "gt_pred", "disp_resized", "max_images", "title"])
def test_build_gallery_writes_the_jax_functions_files(city_tree, tmp_path, case):
    root, results = city_tree
    paths = _images(root)
    ids = np.random.default_rng(3).integers(0, 3, (16, 24), dtype=np.uint8)
    kw = dict(gt_loader=lambda p: ids, color_map=CMAP)
    if case == "gt_pred":
        kw["pred_loader"] = lambda p: np.asarray(viewer.load_prediction(p, str(results)))
    if case == "disp_resized":
        kw.update(disp_loader=viewer.load_disparity, resize_to=(8, 12), gt_loader=None)
    if case == "max_images":
        kw["max_images"] = 2
    if case == "title":
        kw["title"] = "a <b> & c"
    got = viewer.build_gallery(str(tmp_path / "port"), paths, **kw)
    want = j_viewer.build_gallery(str(tmp_path / "jax"), paths, **kw)
    assert os.path.basename(got) == os.path.basename(want) == "index.html"
    _assert_same_dirs(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("disparity", [True, False])
@pytest.mark.parametrize("with_results", [True, False])
def test_view_cityscapes_split_writes_the_jax_functions_files(city_tree, tmp_path, disparity,
                                                              with_results):
    import shutil

    root, results = city_tree
    if not disparity:
        shutil.rmtree(root / "disparity")
    kw = dict(results_dir=str(results) if with_results else None, max_images=3)
    got = viewer.view_cityscapes_split(str(root), "val", str(tmp_path / "port"), **kw)
    want = j_viewer.view_cityscapes_split(str(root), "val", str(tmp_path / "jax"), **kw)
    assert os.path.basename(got) == os.path.basename(want)
    _assert_same_dirs(tmp_path / "port", tmp_path / "jax")
    panel = np.asarray(Image.open(tmp_path / "port" / "c_000000_000019_leftImg8bit_panel.png"))
    assert panel.shape == (16, 24 * (2 + with_results + disparity), 3)


def test_view_cityscapes_split_without_images_raises_as_jax(city_tree, tmp_path):
    root, _ = city_tree
    with pytest.raises(ValueError) as got:
        viewer.view_cityscapes_split(str(root), "train", str(tmp_path / "a"))
    with pytest.raises(ValueError) as want:
        j_viewer.view_cityscapes_split(str(root), "train", str(tmp_path / "b"))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["image_only", "gt_pred", "disparity", "cityscapes_cmap",
                                  "max_images"])
def test_build_interactive_viewer_writes_the_jax_functions_files(city_tree, tmp_path, case):
    root, results = city_tree
    paths = _images(root)
    kw = {"title": "v <1>"}
    if case != "cityscapes_cmap":
        kw["color_map"] = CMAP
    if case in ("gt_pred", "cityscapes_cmap", "max_images"):
        kw["gt_loader"] = lambda p: np.full((16, 24), 1, np.uint8)
        kw["pred_loader"] = lambda p: viewer.load_prediction(p, str(results))
    if case == "disparity":
        kw["disp_loader"] = viewer.load_disparity
    if case == "max_images":
        kw["max_images"] = 1
    got = serve.build_interactive_viewer(str(tmp_path / "port"), paths, **kw)
    want = j_serve.build_interactive_viewer(str(tmp_path / "jax"), paths, **kw)
    assert os.path.basename(got) == os.path.basename(want) == "viewer.html"
    _assert_same_dirs(tmp_path / "port", tmp_path / "jax")


def test_build_interactive_viewer_without_images_raises_as_jax(tmp_path):
    with pytest.raises(ValueError) as got:
        serve.build_interactive_viewer(str(tmp_path / "a"), [])
    with pytest.raises(ValueError) as want:
        j_serve.build_interactive_viewer(str(tmp_path / "b"), [])
    assert str(got.value) == str(want.value)


@pytest.fixture
def served(city_tree, tmp_path):
    root, results = city_tree
    directory = tmp_path / "v"
    serve.build_interactive_viewer(str(directory), _images(root), color_map=CMAP,
                                   pred_loader=lambda p: viewer.load_prediction(p, str(results)),
                                   disp_loader=viewer.load_disparity)
    server = serve.serve_viewer(str(directory), port=0, blocking=False)
    yield directory, f"http://{server.server_address[0]}:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def test_serve_viewer_returns_the_files_bytes(served):
    directory, base = served
    files = _files(directory)
    assert "viewer.html" in files and len(files) == 1 + 3 + 3 + 2 + 2  # img, pred, disp x2
    for name, body in files.items():
        with urllib.request.urlopen(f"{base}/{name}", timeout=10) as r:
            assert r.status == 200 and r.read() == body, name
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/missing.png", timeout=10)
    assert e.value.code == 404
