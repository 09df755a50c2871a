"""Segmentation overlay, split views and video on the host. Port of
``fcn8s_tensorflow_tpu/viz/overlay.py``.

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``, which the
card's installation does not have. ``resize_linear_u8``, re-exported here
from ``ops/resize_host.py``, is the port's uint8 bilinear resize with
OpenCV's semantics, bit for bit.

OpenCV is imported in exactly three places, inside the function, because
there the output is OpenCV's own artifact: the Hershey-font anti-aliased
text of a split view's captions (``cv2.putText``), and the MPEG-4
container of ``segment_video`` and ``create_video_from_images``
(``cv2.VideoCapture``/``VideoWriter``). Without OpenCV those raise
``ImportError``; nothing else here needs it. Unlike the JAX functions, both
video writers raise when OpenCV cannot open the output file, where the JAX
ones write nothing and return the path.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
from PIL import Image

from ..ops.resize_host import resize_linear_u8  # callers of viz.overlay import it from here


def print_segmentation_onto_image(image, prediction, color_map) -> np.ndarray:
    """Overlay a segmentation onto ``image``.

    ``prediction``: (H, W) integer class ids, (1, H, W), or (1, H, W, C) /
    (H, W, C) class scores (argmaxed here — the reference argmaxes softmax
    output on host at `visualization_utils.py:39`).
    ``color_map``: dict class_id -> RGBA (alpha 0..255), e.g.
    ``TRAINIDS_TO_RGBA_DICT``. Returns an RGB uint8 array of image size.
    """
    image = np.asarray(image)
    if image.ndim != 3:
        raise ValueError(f"Expected image of rank 3, got shape {image.shape}")
    pred = np.asarray(prediction)
    if pred.ndim == 4:
        pred = pred[0]
    if pred.ndim == 3 and pred.shape[:2] == image.shape[:2]:
        pred = np.argmax(pred, axis=-1)
    elif pred.ndim == 3:  # (1, H, W)
        pred = pred[0]
    if pred.shape != image.shape[:2]:
        raise ValueError(
            f"Prediction spatial dims {pred.shape} do not match image {image.shape[:2]}"
        )

    num_ids = int(max(color_map.keys())) + 1
    lut = np.zeros((num_ids, 4), dtype=np.float32)
    for class_id, rgba in color_map.items():
        if class_id >= 0:
            lut[class_id] = rgba
    rgba = lut[np.clip(pred, 0, num_ids - 1)]
    alpha = rgba[..., 3:4] / 255.0
    out = image.astype(np.float32) * (1 - alpha) + rgba[..., :3] * alpha
    return out.astype(np.uint8)


def create_split_view(target_size, images, positions, sizes, captions=None) -> np.ndarray:
    """Compose ``images`` onto a black canvas of ``target_size`` (H, W):
    each image i is resized to ``sizes[i]`` (H, W) (``resize_linear_u8``)
    and pasted at ``positions[i]`` (y, x); optional caption strings are
    drawn top-left of each, right after its paste, so that a later paste
    may cover an earlier caption (reference `visualization_utils.py:54-100`).
    Captions need OpenCV."""
    if captions is not None and any(captions):
        try:
            import cv2
        except ImportError as e:
            raise ImportError("create_split_view's captions need OpenCV (cv2.putText)") from e
    canvas = np.zeros((target_size[0], target_size[1], 3), dtype=np.uint8)
    for i, img in enumerate(images):
        img = np.asarray(img)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        h, w = sizes[i]
        img = resize_linear_u8(img, (h, w))
        y, x = positions[i]
        h = min(h, target_size[0] - y)
        w = min(w, target_size[1] - x)
        canvas[y : y + h, x : x + w] = img[:h, :w]
        if captions is not None and captions[i]:
            cv2.putText(
                canvas, captions[i], (x + 8, y + 24), cv2.FONT_HERSHEY_SIMPLEX,
                0.7, (255, 255, 255), 2, cv2.LINE_AA,
            )
    return canvas


def overlay_frames(model, frames, color_map: dict, *, batch_size: int = 8,
                   quantized: bool = False, tile=None, tile_overlap: int = 128):
    """Yield the RGB frames of the iterable ``frames`` overlaid with their
    predicted classes, in order: full batches of ``batch_size`` through
    ``model.predict(overlay=color_map, ...)``, then a short tail.
    ``segment_video``'s batch loop, without the video container."""
    def predict(batch):
        return model.predict(np.stack(batch), overlay=color_map, quantized=quantized,
                             tile=tile, tile_overlap=tile_overlap)

    batch = []
    for frame in frames:
        batch.append(frame)
        if len(batch) == batch_size:
            yield from predict(batch)
            batch = []
    if batch:
        yield from predict(batch)


def segment_video(
    model,
    video_input_path: str,
    video_output_path: str,
    color_map: dict,
    *,
    batch_size: int = 8,
    frame_rate: float | None = None,
    quantized: bool = False,
    tile=None,
    tile_overlap: int = 128,
) -> str:
    """Video -> segmented-overlay video, batched through the model.

    Reads ``video_input_path`` with OpenCV, runs the frames through
    ``overlay_frames`` (class colors composited by ``model.predict``, on
    the card for the port's ``FCN8s``) and writes an ``mp4v`` MP4 at
    ``frame_rate`` (default: the input's, else 30). Decode, predict and
    encode do not overlap. ``quantized``/``tile``/``tile_overlap`` pass
    through to ``predict``. Returns the output path (``.mp4`` appended if
    missing); raises ``ValueError`` if either file cannot be opened.
    """
    try:
        import cv2
    except ImportError as e:
        raise ImportError("segment_video needs OpenCV (cv2.VideoCapture/VideoWriter)") from e

    cap = cv2.VideoCapture(video_input_path)
    if not cap.isOpened():
        raise ValueError(f"could not open video {video_input_path}")
    fps = frame_rate or cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    out_path = (video_output_path if video_output_path.endswith(".mp4")
                else video_output_path + ".mp4")
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        if not writer.isOpened():
            raise ValueError(f"could not open {out_path} for writing")

        def rgb_frames():
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield frame[:, :, ::-1]  # BGR -> RGB

        for f in overlay_frames(model, rgb_frames(), color_map, batch_size=batch_size,
                                quantized=quantized, tile=tile, tile_overlap=tile_overlap):
            writer.write(np.asarray(f)[:, :, ::-1])  # RGB -> BGR
    finally:
        writer.release()
        cap.release()
    return out_path


def create_video_from_images(
    video_output_name: str,
    image_input_dir: str,
    frame_rate: float = 30.0,
    image_file_extension: str = "png",
) -> str:
    """Encode every ``*.ext`` image in a directory (sorted) into an MP4
    (reference `visualization_utils.py:102-120`): imageio's writer where it
    has an MP4 backend, else OpenCV's ``mp4v``. Returns the output path."""
    paths = sorted(glob(os.path.join(image_input_dir, "*." + image_file_extension)))
    if not paths:
        raise ValueError(f"No .{image_file_extension} images in {image_input_dir}")
    out_path = video_output_name if video_output_name.endswith(".mp4") else video_output_name + ".mp4"

    first = np.asarray(Image.open(paths[0]).convert("RGB"))
    h, w = first.shape[:2]
    try:
        import imageio

        with imageio.get_writer(out_path, fps=frame_rate) as writer:
            for p in paths:
                writer.append_data(np.asarray(Image.open(p).convert("RGB")))
    except Exception:
        try:
            import cv2
        except ImportError as e:
            raise ImportError("create_video_from_images needs imageio's MP4 writer or OpenCV "
                              "(cv2.VideoWriter)") from e

        vw = cv2.VideoWriter(
            out_path, cv2.VideoWriter_fourcc(*"mp4v"), frame_rate, (w, h)
        )
        try:
            if not vw.isOpened():
                raise ValueError(f"could not open {out_path} for writing")
            for p in paths:
                frame = np.asarray(Image.open(p).convert("RGB"))
                vw.write(frame[:, :, ::-1])  # RGB -> BGR
        finally:
            vw.release()
    return out_path
