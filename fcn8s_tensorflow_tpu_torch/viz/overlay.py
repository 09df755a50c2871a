"""Segmentation overlay and split views on the host. Port of
``fcn8s_tensorflow_tpu/viz/overlay.py`` (``print_segmentation_onto_image``,
``create_split_view``), without OpenCV.

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``, which the
card's installation does not have. ``resize_linear_u8``, re-exported here
from ``ops/resize_host.py``, is the port's uint8 bilinear resize with
OpenCV's semantics, bit for bit.

Not ported: captions (``cv2.putText``), ``segment_video`` and
``create_video_from_images`` (OpenCV's text rendering and video I/O);
``create_split_view`` raises on a caption.
"""

from __future__ import annotations

import numpy as np

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
    and pasted at ``positions[i]`` (y, x). Captions are not ported (they
    need OpenCV's text rendering): a non-empty one raises."""
    if captions is not None and any(captions):
        raise NotImplementedError("split-view captions need OpenCV's text rendering and are "
                                  "not ported to the PyTorch package yet")
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
    return canvas
