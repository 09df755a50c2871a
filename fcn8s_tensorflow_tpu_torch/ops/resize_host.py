"""OpenCV's uint8 resizes on the host, without OpenCV.

The JAX package resizes images with ``cv2.resize(..., INTER_LINEAR)`` and
labels with ``cv2.resize(..., INTER_NEAREST)``; OpenCV is not in the card's
installation, so the port has its own of both, bit for bit:

* ``resize_linear_u8``: half-pixel centres, no antialiasing, 11-bit
  fixed-point weights, borders clamped as OpenCV clamps them (a column past
  the edge takes the edge pixel at full weight; a row past it reads the edge
  row through both taps), and the vertical pass rounded as OpenCV's vector
  path rounds it. At the image's own size it is a copy.
  ``tests/test_torch_overlay.py`` and ``tests/test_torch_data.py`` hold it
  against ``cv2.resize`` on up- and downscales of 1- and 3-channel images;
* ``resize_nearest``: OpenCV's nearest rule, ``min(floor(d * (1 / (dst /
  src))), src - 1)`` in double, for any dtype and channel count (label ids,
  uint8 or uint16, and colour ground truth).

``viz/overlay.py``, ``data/`` and ``ops/augment_device.py`` share them.
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
    w0 = np.rint((np.float32(1.0) - f) * COEF_SCALE).astype(np.int32)
    w1 = np.rint(f * COEF_SCALE).astype(np.int32)
    return s0, s1, w0, w1


def _check_size(size) -> tuple[int, int]:
    h, w = int(size[0]), int(size[1])
    if h < 1 or w < 1:
        raise ValueError(f"size must be positive, got {size}")
    return h, w


def resize_linear_u8(image, size) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)`` for a
    uint8 (H, W) or (H, W, C) image and ``size = (h, w)``."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 (H, W[, C]) image, got {image.dtype} {image.shape}")
    h, w = _check_size(size)
    if image.shape[:2] == (h, w):
        return image.copy()
    img = image if image.ndim == 3 else image[:, :, None]
    H, W = img.shape[:2]
    x0, x1, a0, a1 = _taps(W, w, clamp_weight=True)
    y0, y1, b0, b1 = _taps(H, h, clamp_weight=False)
    # every intermediate fits int32: a row sum <= 255 * 2^11, and after >> 4
    # its product with a weight <= 2^11 stays below 2^27
    src = img.astype(np.int32)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]  # x 2^11
    rows >>= 4  # the vertical pass: 16-bit multiply-high of (row >> 4) and the weight
    out = ((rows[y0] * b0[:, None, None]) >> 16) + ((rows[y1] * b1[:, None, None]) >> 16)
    out = np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    return out if image.ndim == 3 else out[:, :, 0]


def nearest_indices(dst: int, src: int) -> np.ndarray:
    """cv2 INTER_NEAREST source indices for a resize of ``src`` to ``dst``,
    in its double arithmetic: ``min(floor(d * (1 / (dst / src))), src - 1)``."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx), src - 1).astype(np.int64)


def resize_nearest(image, size) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_NEAREST)`` for an
    (H, W) or (H, W, C) array of any dtype and ``size = (h, w)``."""
    image = np.asarray(image)
    if image.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) array, got shape {image.shape}")
    h, w = _check_size(size)
    rows = nearest_indices(h, image.shape[0])
    cols = nearest_indices(w, image.shape[1])
    return image[rows[:, None], cols[None, :]]
