"""PyTorch port, the rest of ``viz/overlay.py`` against the JAX package's.

Tolerances: none. Split views with captions equal the JAX function's at 0
LSB (both draw with ``cv2.putText``; the port resizes with its bit-exact
``resize_linear_u8``). ``segment_video`` and ``create_video_from_images``
write byte-identical files: the JAX and the port function run on the same
port model (``device="cpu"``, fp32, narrow widths; the JAX function only
calls ``model.predict``), and OpenCV's ``mp4v`` writer is deterministic for
the same frames. The batch loop's frames equal ``model.predict(overlay=)``
batch by batch, exactly. The one difference is deliberate: the port raises
where OpenCV cannot open the output file, and the JAX function returns the
path of a file it never wrote.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from fcn8s_tensorflow_tpu.viz import overlay as j_overlay
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
from fcn8s_tensorflow_tpu_torch.viz import overlay

CMAP = {0: (255, 0, 0, 127), 1: (0, 255, 0, 127), 2: (0, 0, 255, 255)}
FRAMES, FRAME_HW = 5, (32, 64)


@pytest.fixture(scope="module")
def model():
    m = FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32,
              device="cpu", seed=3)
    yield m
    m.close()


@pytest.fixture
def video(tmp_path):
    """A seeded 5-frame 64x32 ``mp4v`` video at 5 frames/s."""
    rng = np.random.default_rng(10)
    path = str(tmp_path / "in.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, FRAME_HW[::-1])
    for _ in range(FRAMES):
        writer.write(rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8))
    writer.release()
    return path


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _decode(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, fps


# ---------------------------------------------------------------------------
# split-view captions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["vertical", "horizontal", "resized", "covered", "clipped",
                                    "some_empty", "gray"])
def test_split_view_captions_equal_the_jax_packages(rng, layout):
    """Captions at 0 LSB, drawn right after each paste: in "covered" the
    second image is pasted over the first one's caption, and in "clipped"
    the caption runs off the canvas."""
    a = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    target, images, positions, sizes, captions = {
        "vertical": ((80, 60), [a, b], [(0, 0), (40, 0)], [(40, 60)] * 2, ["image", "road"]),
        "horizontal": ((40, 120), [a, b], [(0, 0), (0, 60)], [(40, 60)] * 2, ["a", "b 2"]),
        "resized": ((90, 140), [a, b], [(0, 0), (23, 47)], [(23, 47), (67, 93)],
                    ["small", "Large caption"]),
        "covered": ((60, 90), [a, b], [(0, 0), (10, 20)], [(40, 60), (40, 60)],
                    ["under the paste", "over"]),
        "clipped": ((30, 50), [a], [(0, 0)], [(40, 60)], ["a caption wider than the canvas"]),
        "some_empty": ((40, 120), [a, b], [(0, 0), (0, 60)], [(40, 60)] * 2, ["", "b"]),
        "gray": ((40, 60), [a[..., 0]], [(0, 0)], [(40, 60)], ["gray"]),
    }[layout]
    got = overlay.create_split_view(target, images, positions, sizes, captions=captions)
    want = j_overlay.create_split_view(target, images, positions, sizes, captions=captions)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got == 255).any()  # the text was drawn


def test_split_view_without_opencv_raises_only_for_captions(rng, monkeypatch):
    a = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(
        overlay.create_split_view((8, 8), [a], [(0, 0)], [(8, 8)], captions=["", ""]), a)
    with pytest.raises(ImportError, match="OpenCV"):
        overlay.create_split_view((8, 8), [a], [(0, 0)], [(8, 8)], captions=["road"])


# ---------------------------------------------------------------------------
# segment_video and its batch loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,suffix", [
    (dict(batch_size=5), ".mp4"),  # one full batch
    (dict(batch_size=2), ".mp4"),  # two full batches and a tail of 1
    (dict(batch_size=3, frame_rate=12.5), ""),  # a tail of 2; a name without .mp4
    (dict(batch_size=8, frame_rate=7.0), ""),  # only a short batch
    (dict(batch_size=2, quantized=True), ".mp4"),
    (dict(batch_size=4, tile=(32, 32), tile_overlap=8), ".mp4"),
])
def test_segment_video_writes_the_jax_functions_bytes(model, video, tmp_path, kw, suffix):
    got = overlay.segment_video(model, video, str(tmp_path / f"port{suffix}"), CMAP, **kw)
    want = j_overlay.segment_video(model, video, str(tmp_path / f"jax{suffix}"), CMAP, **kw)
    assert got == str(tmp_path / "port.mp4") and want == str(tmp_path / "jax.mp4")
    assert _bytes(got) == _bytes(want)
    frames, fps = _decode(got)
    assert len(frames) == FRAMES and frames[0].shape == (*FRAME_HW, 3)
    assert fps == pytest.approx(kw.get("frame_rate", 5.0))


@pytest.mark.parametrize("batch_size", [1, 3, 7])
def test_overlay_frames_equal_predict_batch_by_batch(model, rng, batch_size):
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(7)]
    got = list(overlay.overlay_frames(model, iter(frames), CMAP, batch_size=batch_size))
    want = np.concatenate([model.predict(np.stack(frames[i:i + batch_size]), overlay=CMAP)
                           for i in range(0, len(frames), batch_size)])
    assert len(got) == len(frames)
    np.testing.assert_array_equal(np.stack(got), want)


def test_overlay_frames_of_no_frames_predicts_nothing():
    class NoPredict:
        def predict(self, *a, **k):
            raise AssertionError("predict called")

    assert list(overlay.overlay_frames(NoPredict(), iter([]), CMAP)) == []


def test_segment_video_frames_are_the_overlaid_decoded_frames(model, video, tmp_path):
    """What ``segment_video`` encodes is ``overlay_frames`` of the decoded
    RGB frames: re-encoding those frames with the same writer gives the
    same bytes."""
    out = overlay.segment_video(model, video, str(tmp_path / "out"), CMAP, batch_size=2)
    decoded, fps = _decode(video)
    frames = list(overlay.overlay_frames(model, (f[:, :, ::-1] for f in decoded), CMAP,
                                         batch_size=2))
    again = str(tmp_path / "again.mp4")
    writer = cv2.VideoWriter(again, cv2.VideoWriter_fourcc(*"mp4v"), fps, FRAME_HW[::-1])
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
    writer.release()
    assert _bytes(out) == _bytes(again)


def test_could_not_open_video_matches_jax(model, tmp_path):
    missing = str(tmp_path / "missing.mp4")
    with pytest.raises(ValueError) as got:
        overlay.segment_video(model, missing, str(tmp_path / "x"), CMAP)
    with pytest.raises(ValueError) as want:
        j_overlay.segment_video(model, missing, str(tmp_path / "y"), CMAP)
    assert str(got.value) == str(want.value) == f"could not open video {missing}"


def test_unopened_writer_raises_where_jax_returns_a_missing_file(model, video, tmp_path):
    """The documented difference: an output in a missing directory."""
    out = str(tmp_path / "no_such_dir" / "out")
    with pytest.raises(ValueError, match="could not open .*out.mp4 for writing"):
        overlay.segment_video(model, video, out, CMAP)
    returned = j_overlay.segment_video(model, video, out, CMAP)
    assert returned == out + ".mp4" and not os.path.exists(returned)


def test_segment_video_without_opencv_raises(model, video, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="segment_video needs OpenCV"):
        overlay.segment_video(model, video, str(tmp_path / "x"), CMAP)


# ---------------------------------------------------------------------------
# create_video_from_images
# ---------------------------------------------------------------------------
@pytest.fixture
def image_dir(tmp_path):
    rng = np.random.default_rng(11)
    d = tmp_path / "frames"
    d.mkdir()
    for i in (3, 0, 2, 1):  # written out of order: the glob is sorted
        Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(
            d / f"frame_{i:03d}.png")
    Image.fromarray(rng.integers(0, 256, (24, 40), dtype=np.uint8)).save(d / "frame_004.png")
    Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(d / "other.jpg")
    return str(d)


@pytest.mark.parametrize("imageio", ["present", "blocked"])
@pytest.mark.parametrize("name,ext,fps", [("vid", "png", 30.0), ("clip.mp4", "png", 5.0),
                                          ("one", "jpg", 12.0)])
def test_create_video_from_images_writes_the_jax_functions_bytes(image_dir, tmp_path,
                                                                 monkeypatch, imageio, name,
                                                                 ext, fps):
    if imageio == "blocked":
        monkeypatch.setitem(sys.modules, "imageio", None)
    got = overlay.create_video_from_images(str(tmp_path / f"port_{name}"), image_dir, fps, ext)
    want = j_overlay.create_video_from_images(str(tmp_path / f"jax_{name}"), image_dir, fps, ext)
    assert got.endswith(".mp4") and os.path.basename(want) == "jax_" + os.path.basename(
        got)[len("port_"):]
    assert _bytes(got) == _bytes(want)
    frames, got_fps = _decode(got)
    assert len(frames) == (5 if ext == "png" else 1) and got_fps == pytest.approx(fps)


def test_create_video_from_images_errors(image_dir, tmp_path, monkeypatch):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError) as got:
        overlay.create_video_from_images(str(tmp_path / "v"), str(empty))
    with pytest.raises(ValueError) as want:
        j_overlay.create_video_from_images(str(tmp_path / "v"), str(empty))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="could not open .* for writing"):
        overlay.create_video_from_images(str(tmp_path / "no_dir" / "v"), image_dir)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        overlay.create_video_from_images(str(tmp_path / "v"), image_dir)


# ---------------------------------------------------------------------------
# what the port's viz and prep modules import
# ---------------------------------------------------------------------------
def test_viz_and_prep_import_no_jax_no_matplotlib_no_cv2():
    modules = ["viz.overlay", "viz.viewer", "viz.serve", "prep.annotation", "prep.corrections",
               "prep.rasterize", "prep.create_gt_imgs", "prep.label_tool"]
    code = ("import sys\n"
            + "".join(f"import fcn8s_tensorflow_tpu_torch.{m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'fcn8s_tensorflow_tpu', 'matplotlib', 'cv2'))\n"
              "print(bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
