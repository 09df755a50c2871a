"""Segmentation overlay and split views on the host. Port of
``fcn8s_tensorflow_tpu/viz/overlay.py`` (``print_segmentation_onto_image``,
``create_split_view``), without OpenCV.

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``, which the
card's installation does not have. ``resize_linear_u8`` is its own uint8
bilinear resize with OpenCV's semantics: half-pixel centres, no
antialiasing, 11-bit fixed-point weights, borders clamped as OpenCV clamps
them (a column past the edge takes the edge pixel at full weight; a row
past it reads the edge row through both taps), and the vertical pass
rounded as OpenCV's vector path rounds it. At the image's own size it is a
copy. ``tests/test_torch_overlay.py`` holds it bit-exact against
``cv2.resize`` on up- and downscales of 1- and 3-channel images.

Not ported: captions (``cv2.putText``), ``segment_video`` and
``create_video_from_images`` (OpenCV's text rendering and video I/O);
``create_split_view`` raises on a caption.
"""

from __future__ import annotations

import numpy as np

COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _taps(src: int, dst: int, clamp_weight: bool):
    """Per output index: the two source indices and their fixed-point
    weights. ``clamp_weight``: OpenCV's horizontal rule (an index past an
    edge moves onto it with weight 0 on the second tap); otherwise its
    vertical one (the indices are clamped, the weights kept)."""
    scale = 1.0 / (dst / src)  # OpenCV's scale_x = 1 / inv_scale_x, in double
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weight:
        f[s < 0] = 0.0
        s[s < 0] = 0
        past = s >= src - 1
        f[past] = 0.0
        s[past] = src - 1
    s0, s1 = np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1)
    w0 = np.rint((np.float32(1.0) - f) * COEF_SCALE).astype(np.int64)
    w1 = np.rint(f * COEF_SCALE).astype(np.int64)
    return s0, s1, w0, w1


def resize_linear_u8(image, size) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)`` for a
    uint8 (H, W) or (H, W, C) image and ``size = (h, w)``."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 (H, W[, C]) image, got {image.dtype} {image.shape}")
    h, w = int(size[0]), int(size[1])
    if h < 1 or w < 1:
        raise ValueError(f"size must be positive, got {size}")
    if image.shape[:2] == (h, w):
        return image.copy()
    img = image if image.ndim == 3 else image[:, :, None]
    H, W = img.shape[:2]
    x0, x1, a0, a1 = _taps(W, w, clamp_weight=True)
    y0, y1, b0, b1 = _taps(H, h, clamp_weight=False)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]  # x 2^11
    rows >>= 4  # the vertical pass: 16-bit multiply-high of (row >> 4) and the weight
    out = ((rows[y0] * b0[:, None, None]) >> 16) + ((rows[y1] * b1[:, None, None]) >> 16)
    out = np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    return out if image.ndim == 3 else out[:, :, 0]


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
