"""Online data-augmentation transforms on the host, without OpenCV.

Port of ``fcn8s_tensorflow_tpu/data/augment.py``: the same transforms, the
same random draws in the same order, and the same bytes out. Every random
transform takes a ``numpy.random.Generator``. Where the JAX package calls
OpenCV, the port computes OpenCV's result with numpy:

* ``resize_pair``: ``cv2.resize`` INTER_LINEAR for images and INTER_NEAREST
  for ground truth, as ``ops/resize_host.py`` reproduces them;
* ``brightness_hsv``: OpenCV's uint8 RGB -> HSV (its 12-bit fixed-point
  divisions) and HSV -> RGB (fp32: S and V times 1/255, the sector tables
  with ``1 - s*h`` and ``1 - s*(1 - h)`` each one fused multiply-add, then
  times 255). OpenCV 5.0.0's x86-64 build converts each row's pixels in
  blocks of 32 with vector code that truncates, and the row's last
  ``W % 32`` with scalar code that rounds to nearest; so does the port.
  That equals its ``cvtColor`` on every one of the 2^24 RGB and 180 x 2^16
  HSV inputs;
* ``horizontal_flip``: reversed columns;
* ``translate``: integer shifts only (the draws are integers), so OpenCV's
  ``warpAffine`` is a shifted copy; the uncovered border is 0 on the image
  and, on the ground truth, OpenCV's ``borderValue=void_class_id``: the
  scalar (void, 0, 0, 0), so a colour ground truth gets void in its first
  channel and 0 in the others;
* ``grayscale``: OpenCV 5.0.0's Q15 weights ``(R*9798 + G*19235 + B*3735 +
  2^14) >> 15`` (OpenCV 4 used Q14 ``4899, 9617, 1868``, which the device
  twin in ``ops/augment_device.py`` keeps).

Transform order (``generator.apply_augmentations``): random_crop -> crop ->
resize -> brightness -> photometric extras -> flip -> translate -> scale ->
gray. Images resize bilinearly, ground truth always nearest; blank space
made by a crop, translate or scale is black on images and
``void_class_id`` on ground truth.
"""

from __future__ import annotations

import numpy as np

from ..ops.resize_host import resize_linear_u8, resize_nearest

HSV_SHIFT = 12  # OpenCV's fixed-point shift of the uint8 RGB -> HSV divisions
_IDS = np.arange(1, 256)
# OpenCV's division tables: sdiv[v] = round(255 * 2^12 / v), hdiv[d] = round(180 * 2^12 / (6 d))
_SDIV = np.concatenate([[0], np.rint((255 << HSV_SHIFT) / _IDS)]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << HSV_SHIFT) / (6 * _IDS))]).astype(np.int64)
# HSV -> RGB: per sector, which of (v, p, q, t) is (b, g, r)
_SECTOR_BGR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
HSV2RGB_VECTOR_BLOCK = 32  # pixels per vector step of OpenCV's HSV -> RGB (AVX2: 4 x 8 lanes)


def random_crop_with_void(rng, image, gt_image, crop_hw, void_class_id):
    """Random (h, w) crop; if the crop is larger than the image in either
    dim, the image is placed at a random offset on a black/void canvas
    (reference `:268-322`)."""
    img_h, img_w = image.shape[:2]
    crop_h, crop_w = crop_hw
    y_range = img_h - crop_h
    x_range = img_w - crop_w
    y0 = rng.integers(0, abs(y_range) + 1)
    x0 = rng.integers(0, abs(x_range) + 1)

    def place(arr, fill, out_dtype):
        shape = (crop_h, crop_w) + arr.shape[2:]
        if y_range >= 0 and x_range >= 0:
            return np.copy(arr[y0 : y0 + crop_h, x0 : x0 + crop_w])
        canvas = np.full(shape, fill, dtype=out_dtype)
        if y_range >= 0:  # crop vertical, place horizontal
            patch = arr[y0 : y0 + crop_h]
            canvas[:, x0 : x0 + img_w] = patch
        elif x_range >= 0:  # crop horizontal, place vertical
            patch = arr[:, x0 : x0 + crop_w]
            canvas[y0 : y0 + img_h, :] = patch
        else:  # place both
            canvas[y0 : y0 + img_h, x0 : x0 + img_w] = arr
        return canvas

    image = place(image, 0, np.uint8)
    if gt_image is not None:
        gt_image = place(gt_image, void_class_id, gt_image.dtype)
    return image, gt_image


def fixed_crop(image, gt_image, crop):
    """Crop (top, bottom, left, right) pixels off each side (reference `:324-326`)."""
    top, bottom, left, right = crop
    h, w = image.shape[:2]
    image = np.copy(image[top : h - bottom, left : w - right])
    if gt_image is not None:
        gt_image = np.copy(gt_image[top : h - bottom, left : w - right])
    return image, gt_image


def resize_pair(image, gt_image, size_hw):
    """Bilinear for images, nearest for GT (reference `:328-331`) — nearest
    on GT is load-bearing for mIoU parity."""
    image = resize_linear_u8(image, size_hw)
    if gt_image is not None:
        gt_image = resize_nearest(gt_image, size_hw)
    return image, gt_image


def rgb_to_hsv_u8(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_RGB2HSV)`` for uint8 RGB: H in
    [0, 180), S and V in [0, 255], by OpenCV's fixed-point divisions."""
    x = image.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> HSV_SHIFT
    num = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (num * _HDIV[diff] + half) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` for an (H, W, 3) uint8 HSV
    image (H in [0, 180)), in OpenCV's fp32 arithmetic. Its fused
    ``1 - s*h`` rounds once, which fp64 gives here exactly; the last step
    truncates in the vector blocks of each row and rounds in its tail."""
    f32, one = np.float32, np.float32(1.0)
    h = hsv[..., 0].astype(f32) * (f32(6.0) / f32(180.0))
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    s64 = s.astype(np.float64)
    tab = np.stack([v,
                    v * (one - s),
                    v * (1.0 - s64 * h).astype(f32),
                    v * (1.0 - s64 * (one - h)).astype(f32)], axis=-1)
    rgb = np.take_along_axis(tab, _SECTOR_BGR[sector], axis=-1)[..., ::-1] * f32(255.0)
    vector = hsv.shape[1] - hsv.shape[1] % HSV2RGB_VECTOR_BLOCK
    rgb[:, :vector] = np.trunc(rgb[:, :vector])
    rgb[:, vector:] = np.rint(rgb[:, vector:])
    return np.clip(rgb, 0, 255).astype(np.uint8)


def brightness_hsv(rng, image, lo, hi):
    """Scale the HSV V channel by U(lo, hi), overflow-clamped to 255
    (reference `_brightness`, `batch_generator.py:471-488`)."""
    hsv = rgb_to_hsv_u8(image)
    factor = rng.uniform(lo, hi)
    v = hsv[:, :, 2].astype(np.float64) * factor
    hsv[:, :, 2] = np.where(v > 255, 255, v).astype(hsv.dtype)
    return hsv_to_rgb_u8(hsv)


def horizontal_flip(image, gt_image):
    """cv2.flip(.., 1) (reference `:338-342`)."""
    image = np.ascontiguousarray(image[:, ::-1])
    if gt_image is not None:
        gt_image = np.ascontiguousarray(gt_image[:, ::-1])
    return image, gt_image


def _shift(arr, x_shift: int, y_shift: int, fill: int):
    """``arr`` moved by (x_shift, y_shift) whole pixels, as OpenCV's
    ``warpAffine`` with a constant border of the scalar (fill, 0, 0, 0):
    uncovered pixels take ``fill`` (saturated to the dtype) in the first
    channel and 0 in the others."""
    h, w = arr.shape[:2]
    info = np.iinfo(arr.dtype)
    out = np.zeros(arr.shape, dtype=arr.dtype)
    (out if arr.ndim == 2 else out[..., 0])[...] = min(max(fill, info.min), info.max)
    ys, yd = (slice(0, h - y_shift), slice(y_shift, h)) if y_shift >= 0 else \
        (slice(-y_shift, h), slice(0, h + y_shift))
    xs, xd = (slice(0, w - x_shift), slice(x_shift, w)) if x_shift >= 0 else \
        (slice(-x_shift, w), slice(0, w + x_shift))
    if abs(y_shift) < h and abs(x_shift) < w:
        out[yd, xd] = arr[ys, xs]
    return out


def translate(rng, image, gt_image, x_range, y_range, void_class_id):
    """Shift by +/-U{x_range} horizontally and +/-U{y_range} vertically with
    random sign, border filled black / void (reference `:344-356`)."""
    x = int(rng.integers(x_range[0], x_range[1] + 1))
    y = int(rng.integers(y_range[0], y_range[1] + 1))
    x_shift = x if rng.random() < 0.5 else -x
    y_shift = y if rng.random() < 0.5 else -y
    image = _shift(image, x_shift, y_shift, 0)
    if gt_image is not None:
        gt_image = _shift(gt_image, x_shift, y_shift,
                          int(void_class_id) if void_class_id is not None else 0)
    return image, gt_image


def scale_zoom(rng, image, gt_image, lo, hi, void_class_id):
    """Zoom by U(lo, hi): <=1 shrinks onto a centered void canvas, >1 crops
    the center back to the original size (reference `:358-384`)."""
    img_h, img_w = image.shape[:2]
    factor = rng.uniform(lo, hi)
    sh, sw = int(img_h * factor), int(img_w * factor)
    y_off = abs(int((img_h - sh) / 2))
    x_off = abs(int((img_w - sw) / 2))

    patch = resize_linear_u8(image, (sh, sw))
    if factor <= 1:
        canvas = np.zeros((img_h, img_w) + image.shape[2:], dtype=np.uint8)
        canvas[y_off : y_off + sh, x_off : x_off + sw] = patch
        image = canvas
    else:
        image = np.copy(patch[y_off : img_h + y_off, x_off : img_w + x_off])

    if gt_image is not None:
        gt_patch = resize_nearest(gt_image, (sh, sw))
        if factor <= 1:
            canvas = np.full((img_h, img_w), void_class_id, dtype=gt_image.dtype)
            canvas[y_off : y_off + sh, x_off : x_off + sw] = gt_patch
            gt_image = canvas
        else:
            gt_image = np.copy(gt_patch[y_off : img_h + y_off, x_off : img_w + x_off])
    return image, gt_image


def grayscale(image):
    """RGB -> single-channel grayscale, keeping a channel dim (reference
    `:386-387`), with OpenCV 5.0.0's Q15 weights."""
    rgb = image.astype(np.int32)
    y = (rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735 + (1 << 14)) >> 15
    return y.astype(np.uint8)[..., None]


# ---------------------------------------------------------------------------
# Beyond-reference photometric transforms — host twins of the device set
# (``ops/augment_device.py``'s contrast, saturation, hue and gamma applies). Formulas are
# identical (float32 Rec.601 gray, round once), so the two pipelines agree to
# uint8 rounding.
# ---------------------------------------------------------------------------
def _gray601(image_f32):
    return (image_f32[..., 0] * 0.299 + image_f32[..., 1] * 0.587
            + image_f32[..., 2] * 0.114)


def contrast(rng, image, lo, hi):
    """Blend toward the image's grayscale mean by f ~ U(lo, hi)."""
    f = np.float32(rng.uniform(lo, hi))
    x = image.astype(np.float32)
    mean = _gray601(x).mean(dtype=np.float32)
    return np.clip(np.round(mean + f * (x - mean)), 0, 255).astype(np.uint8)


def saturation(rng, image, lo, hi):
    """Blend toward the per-pixel grayscale by f ~ U(lo, hi)."""
    f = np.float32(rng.uniform(lo, hi))
    x = image.astype(np.float32)
    g = _gray601(x)[..., None]
    return np.clip(np.round(g + f * (x - g)), 0, 255).astype(np.uint8)


def gamma(rng, image, lo, hi):
    """Power-law ``255*(x/255)**g`` with g ~ U(lo, hi)."""
    g = np.float32(rng.uniform(lo, hi))
    x = image.astype(np.float32) / np.float32(255.0)
    return np.clip(np.round(255.0 * x**g), 0, 255).astype(np.uint8)


def hue_rotate(rng, image, max_delta):
    """Rotate hue by delta ~ U(-max_delta, max_delta) turns, S and V
    preserved (float-exact HSV round trip, same math as the device twin)."""
    delta = np.float32(rng.uniform(-max_delta, max_delta))
    x = image.astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = np.max(x, axis=-1)
    mn = np.min(x, axis=-1)
    c = mx - mn
    safe_c = np.maximum(c, np.float32(1e-12))
    h = np.where(
        c == 0, 0.0,
        np.where(mx == r, np.mod((g - b) / safe_c, 6.0),
                 np.where(mx == g, (b - r) / safe_c + 2.0,
                          (r - g) / safe_c + 4.0)))
    h = np.mod(h + delta * 6.0, 6.0)
    cx = c * (1.0 - np.abs(np.mod(h, 2.0) - 1.0))
    sector = np.floor(h).astype(np.int32)
    zeros = np.zeros_like(c)
    r1 = np.select([sector == 0, sector == 1, sector == 2, sector == 3,
                    sector == 4], [c, cx, zeros, zeros, cx], c)
    g1 = np.select([sector == 0, sector == 1, sector == 2, sector == 3,
                    sector == 4], [cx, c, c, cx, zeros], zeros)
    b1 = np.select([sector == 0, sector == 1, sector == 2, sector == 3,
                    sector == 4], [zeros, zeros, cx, c, c], cx)
    out = np.stack([r1, g1, b1], axis=-1) + mn[..., None]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
