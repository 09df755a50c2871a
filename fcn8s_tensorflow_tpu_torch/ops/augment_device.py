"""Device-resident data augmentation on batches. Port of
``fcn8s_tensorflow_tpu/ops/augment_device.py``.

The host ships raw uint8 images and uint8 id maps; these transforms run on
the card inside the train step (``parallel.steps.train_step``'s
``augment_fn``). Shapes are static: flips are selects, translations and
zooms are gathers with black (images) or void (labels) fill, photometric
transforms are arithmetic.

Each random transform is split into a **draw** (``draw_*``: the per-sample
parameters, from a ``torch.Generator`` on the batch's device) and an
**apply** (``apply_*``: a plain function of the images, labels and drawn
tensors). The applies are the JAX package's arithmetic, op for op and in
fp32: the same cv2 conventions (nearest ``floor(p * size / patch)`` for
labels, half-pixel-centre bilinear with edge clamp for images), the same
rounding (half to even) and the same float-exact HSV brightness. Resampling
is explicit index and weight arithmetic, not ``F.grid_sample`` or
``F.interpolate``, whose corner and rounding conventions differ. Fed the
JAX package's draws, an apply gives its outputs (tests/test_torch_augment.py).
Nothing here copies from the host or reads back: fills are Python scalars,
so the host never waits for the card inside the train step.

``make_augment_fn`` composes the pipeline in the reference's transform
order. Its ``key`` is a ``numpy.random.SeedSequence`` (or an int); each
transform draws from a generator of its own, derived from the key and the
transform's index (JAX's ``split(key, n)`` slots), so enabling one
transform never moves another's draws.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .resize_host import nearest_indices

# make_augment_fn's per-transform key slots (the JAX package's split indices)
CROP, BRIGHTNESS, FLIP, TRANSLATE, SCALE, CONTRAST, SATURATION, HUE, GAMMA, LABEL_NOISE = range(10)


def transform_seed(key, index: int) -> int:
    """The seed of transform slot ``index`` under ``key`` (a ``SeedSequence``
    or an int): from the key's entropy with ``index`` appended to its spawn
    key, so it is a function of (key, index) alone."""
    if not isinstance(key, np.random.SeedSequence):
        key = np.random.SeedSequence(int(key))
    child = np.random.SeedSequence(key.entropy, spawn_key=tuple(key.spawn_key) + (index,))
    return int(child.generate_state(1, np.uint64)[0] >> np.uint64(1))


def transform_generator(key, index: int, device) -> torch.Generator:
    """The generator of transform slot ``index`` under ``key``: a fresh one
    seeded with ``transform_seed``, or, when ``key`` is a callable, the
    generator it returns for ``index`` (a step captured in a CUDA graph
    keeps one per slot and re-seeds it with ``transform_seed`` before each
    replay, ``parallel/graphs.py``)."""
    if callable(key):
        return key(index)
    return torch.Generator(device=device).manual_seed(transform_seed(key, index))


def _uniform(gen: torch.Generator, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand((n,), generator=gen, device=gen.device)
    return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u


def _apply_mask(gen: torch.Generator, n: int, prob: float) -> torch.Tensor:
    """(n,) bool: where the transform fires, with probability ``prob``."""
    return _uniform(gen, n) >= (1.0 - prob)


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------


def _bilinear_axis_coords(out_positions, src_size, patch_size):
    """cv2 INTER_LINEAR half-pixel-center source coordinates for sampling a
    ``src_size``-long axis at patch positions (float), before edge clamp."""
    return (out_positions + 0.5) * (src_size / patch_size) - 0.5


def _taps(f: torch.Tensor, size: int):
    """Edge-clamped bilinear taps of fractional coordinates ``f``: (i0, i1,
    weight of i1)."""
    fc = torch.clamp(f, 0.0, size - 1.0)
    i0 = torch.floor(fc).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    return i0, i1, fc - i0


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (N, H, W[, C]) gathered along H at ``idx`` (N, H')."""
    shape = idx.shape + (1,) * (x.dim() - 2)
    return torch.take_along_dim(x, idx.reshape(shape), dim=1)


def _cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (N, H, W[, C]) gathered along W at ``idx`` (N, W')."""
    shape = (idx.shape[0], 1, idx.shape[1]) + (1,) * (x.dim() - 3)
    return torch.take_along_dim(x, idx.reshape(shape), dim=2)


def _bilinear_sample(images: torch.Tensor, fy, fx, valid_y, valid_x) -> torch.Tensor:
    """Sample (N, H, W, C) at per-sample per-axis fractional coordinates
    ``fy`` (N, H'), ``fx`` (N, W'), separably (rows, then columns, like
    cv2), edge-clamped and rounded; output rows/cols not valid become 0."""
    h, w = images.shape[1:3]
    arr = images.to(torch.float32)
    y0, y1, wy = _taps(fy, h)
    wy = wy[:, :, None, None]
    rows = _rows(arr, y0) * (1.0 - wy) + _rows(arr, y1) * wy
    x0, x1, wx = _taps(fx, w)
    wx = wx[:, None, :, None]
    out = torch.round(_cols(rows, x0) * (1.0 - wx) + _cols(rows, x1) * wx)
    mask = (valid_y[:, :, None] & valid_x[:, None, :])[..., None]
    return torch.where(mask, out, 0.0)


def _nearest_sample(labels: torch.Tensor, iy, ix, valid_y, valid_x, fill) -> torch.Tensor:
    """Sample (N, H, W) at per-sample integer coordinates ``iy`` (N, H'),
    ``ix`` (N, W'); invalid -> ``fill``."""
    h, w = labels.shape[1:3]
    out = _cols(_rows(labels, torch.clamp(iy, 0, h - 1)), torch.clamp(ix, 0, w - 1))
    mask = valid_y[:, :, None] & valid_x[:, None, :]
    return torch.where(mask, out, fill)


def _scale_axis(size: int, f: torch.Tensor):
    """Per-axis inverse-map coordinates of the zoom by per-sample ``f``
    (N,): (bilinear coords (N, size), nearest indices (N, size), valid
    (N, size)). Nearest is the exact rational ``floor(p * size / patch)``
    (``patch = floor(size * f)``, the host's ``int(size * factor)``)."""
    patch = torch.floor(size * f).to(torch.int64)[:, None]
    off = torch.abs(size - patch) // 2
    o = torch.arange(size, dtype=torch.int64, device=f.device)[None, :]
    p = o - torch.where(patch <= size, off, -off)  # patch coordinate of this pixel
    valid = (p >= 0) & (p <= patch - 1)
    isrc = (p * size) // torch.clamp(patch, min=1)
    return (_bilinear_axis_coords(p.to(torch.float32), size, patch.to(torch.float32)),
            isrc, valid)


# ---------------------------------------------------------------------------
# flip, brightness, crop
# ---------------------------------------------------------------------------


def draw_flip(gen: torch.Generator, n: int, prob: float) -> torch.Tensor:
    """(n,) bool: which samples flip."""
    return _apply_mask(gen, n, prob)


def apply_flip(images, label_ids, flip):
    """Horizontal flip of the samples where ``flip`` (n,) is set."""
    out_img = torch.where(flip[:, None, None, None], torch.flip(images, dims=(2,)), images)
    out_lbl = None
    if label_ids is not None:
        out_lbl = torch.where(flip[:, None, None], torch.flip(label_ids, dims=(2,)), label_ids)
    return out_img, out_lbl


def random_horizontal_flip(gen, images, label_ids, prob: float):
    """Per-sample horizontal flip with probability ``prob``."""
    return apply_flip(images, label_ids, draw_flip(gen, images.shape[0], prob))


def draw_photometric(gen: torch.Generator, n: int, lo: float, hi: float, prob: float,
                     identity: float) -> torch.Tensor:
    """(n,) fp32 factor ~ U(lo, hi) where the transform fires (probability
    ``prob``), ``identity`` elsewhere: the draw of brightness, contrast,
    saturation, gamma and hue. The apply mask is drawn first."""
    fire = _apply_mask(gen, n, prob)
    return torch.where(fire, _uniform(gen, n, lo, hi), identity)


def apply_brightness(images, factor):
    """Float-exact HSV-V brightness by per-sample ``factor``: ``V' =
    floor(min(V * f, 255))`` with ``V = max(R, G, B)``, then ``out =
    round(RGB * V' / V)``, which keeps hue and saturation for every pixel,
    clamped or not."""
    rgb = images.to(torch.float32)
    v = torch.amax(rgb, dim=-1, keepdim=True)
    v_new = torch.floor(torch.clamp(v * factor[:, None, None, None], max=255.0))
    scale = torch.where(v > 0, v_new / torch.clamp(v, min=1.0), 0.0)
    return torch.clamp(torch.round(rgb * scale), 0.0, 255.0).to(images.dtype)


def random_brightness(gen, images, lo: float, hi: float, prob: float):
    """Per-sample exact HSV-V brightness by U(lo, hi) with probability ``prob``."""
    return apply_brightness(images, draw_photometric(gen, images.shape[0], lo, hi, prob, 1.0))


def draw_crop(gen: torch.Generator, n: int, h: int, w: int, crop_h: int, crop_w: int):
    """(y0, x0), each (n,) int64: the crop's top-left corners."""
    if crop_h > h or crop_w > w:
        raise ValueError("device random_crop requires crop <= image; use the host "
                         "pipeline's pad-onto-void path for enlarging crops")
    y0 = torch.randint(0, h - crop_h + 1, (n,), generator=gen, device=gen.device)
    x0 = torch.randint(0, w - crop_w + 1, (n,), generator=gen, device=gen.device)
    return y0, x0


def apply_crop(images, label_ids, y0, x0, crop_h: int, crop_w: int):
    """Per-sample crop of (crop_h, crop_w) at corners (y0, x0)."""
    dev = images.device
    iy = y0.to(dev)[:, None] + torch.arange(crop_h, device=dev)[None, :]
    ix = x0.to(dev)[:, None] + torch.arange(crop_w, device=dev)[None, :]
    out_img = _cols(_rows(images, iy), ix)
    out_lbl = _cols(_rows(label_ids, iy), ix) if label_ids is not None else None
    return out_img, out_lbl


def random_crop(gen, images, label_ids, crop_h: int, crop_w: int):
    """Per-sample random crop to (crop_h, crop_w) <= (H, W)."""
    n, h, w = images.shape[:3]
    y0, x0 = draw_crop(gen, n, h, w, crop_h, crop_w)
    return apply_crop(images, label_ids, y0, x0, crop_h, crop_w)


# ---------------------------------------------------------------------------
# translate and scale
# ---------------------------------------------------------------------------


def draw_translate(gen: torch.Generator, n: int, x_spec, y_spec, prob: float):
    """(dx, dy), each (n,) int64, zero where the transform does not fire.
    A spec is an int ``m`` (shift uniform in [-m, m]) or a ``(lo, hi)``
    magnitude range with a random sign (|shift| in [lo, hi])."""
    fire = _apply_mask(gen, n, prob)

    def draw(spec):
        if isinstance(spec, (tuple, list)):
            lo, hi = int(spec[0]), int(spec[1])
            mag = torch.randint(lo, hi + 1, (n,), generator=gen, device=gen.device)
            return torch.where(_uniform(gen, n) < 0.5, mag, -mag)
        m = int(spec)
        return torch.randint(-m, m + 1, (n,), generator=gen, device=gen.device)

    dx = draw(x_spec)
    dy = draw(y_spec)
    return torch.where(fire, dx, 0), torch.where(fire, dy, 0)


def apply_translate(images, label_ids, dx, dy, void_class_id: int = 0):
    """Per-sample integer shift by (dx, dy): ``out[y, x] = in[y - dy, x -
    dx]``, black (images) or ``void_class_id`` (labels) where that falls
    outside."""
    n, h, w = images.shape[:3]
    dev = images.device
    ys = torch.arange(h, device=dev)[None, :] - dy.to(dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :] - dx.to(dev)[:, None]
    vy, vx = (ys >= 0) & (ys <= h - 1), (xs >= 0) & (xs <= w - 1)
    ys, xs = torch.clamp(ys, 0, h - 1), torch.clamp(xs, 0, w - 1)
    mask = vy[:, :, None] & vx[:, None, :]
    out_img = torch.where(mask[..., None], _cols(_rows(images, ys), xs), 0)
    out_lbl = None
    if label_ids is not None:
        out_lbl = torch.where(mask, _cols(_rows(label_ids, ys), xs), void_class_id)
    return out_img, out_lbl


def random_translate(gen, images, label_ids, x_spec, y_spec, prob: float,
                     void_class_id: int = 0):
    """Per-sample integer translation with black/void borders."""
    dx, dy = draw_translate(gen, images.shape[0], x_spec, y_spec, prob)
    return apply_translate(images, label_ids, dx, dy, void_class_id)


def draw_scale(gen: torch.Generator, n: int, lo: float, hi: float, prob: float) -> torch.Tensor:
    """(n,) fp32 zoom factor ~ U(lo, hi) where the transform fires, 1 elsewhere."""
    return draw_photometric(gen, n, lo, hi, prob, 1.0)


def apply_scale(images, label_ids, factor, void_class_id: int = 0):
    """Per-sample zoom by ``factor`` (n,): factor <= 1 shrinks the frame
    onto a centred black/void canvas, > 1 centre-crops the enlarged frame;
    one inverse-map gather, bilinear for images, nearest for labels."""
    h, w = images.shape[1:3]
    f = factor.to(images.device, torch.float32)
    fy, iy, vy = _scale_axis(h, f)
    fx, ix, vx = _scale_axis(w, f)
    out_img = _bilinear_sample(images, fy, fx, vy, vx).to(images.dtype)
    out_lbl = None
    if label_ids is not None:
        out_lbl = _nearest_sample(label_ids, iy, ix, vy, vx, void_class_id)
    return out_img, out_lbl


def random_scale(gen, images, label_ids, lo: float, hi: float, prob: float,
                 void_class_id: int = 0):
    """Per-sample zoom by U(lo, hi) with probability ``prob``."""
    return apply_scale(images, label_ids, draw_scale(gen, images.shape[0], lo, hi, prob),
                       void_class_id)


def apply_translate_scale(images, label_ids, dx, dy, factor, void_class_id: int = 0):
    """Translate by (dx, dy), then zoom by ``factor``, as one separable
    resample: byte-identical to ``apply_scale(*apply_translate(...))``. The
    integer shift folds into the zoom's tap indices (``shifted[y] =
    img[y - dy]``), and a tap outside the image contributes 0, which is the
    translated border's black bleeding into the bilinear."""
    n, h, w = images.shape[:3]
    dev = images.device
    sy, sx = dy.to(dev)[:, None], dx.to(dev)[:, None]
    f = factor.to(dev, torch.float32)
    fy, iy, vy = _scale_axis(h, f)
    fx, ix, vx = _scale_axis(w, f)
    arr = images.to(torch.float32)

    def ytap(yi):
        ys = yi - sy
        v = ((ys >= 0) & (ys <= h - 1)).to(torch.float32)[:, :, None, None]
        return _rows(arr, torch.clamp(ys, 0, h - 1)) * v

    def xtap(rows, xi):
        xs = xi - sx
        v = ((xs >= 0) & (xs <= w - 1)).to(torch.float32)[:, None, :, None]
        return _cols(rows, torch.clamp(xs, 0, w - 1)) * v

    y0, y1, wy = _taps(fy, h)
    wy = wy[:, :, None, None]
    rows = ytap(y0) * (1.0 - wy) + ytap(y1) * wy
    x0, x1, wx = _taps(fx, w)
    wx = wx[:, None, :, None]
    img_f = torch.round(xtap(rows, x0) * (1.0 - wx) + xtap(rows, x1) * wx)
    mask = (vy[:, :, None] & vx[:, None, :])[..., None]
    out_img = torch.where(mask, img_f, 0.0).to(images.dtype)

    out_lbl = None
    if label_ids is not None:
        ys = torch.clamp(iy, 0, h - 1) - sy
        xs = torch.clamp(ix, 0, w - 1) - sx
        ty, tx = (ys >= 0) & (ys <= h - 1), (xs >= 0) & (xs <= w - 1)
        out = _cols(_rows(label_ids, torch.clamp(ys, 0, h - 1)), torch.clamp(xs, 0, w - 1))
        lmask = (vy & ty)[:, :, None] & (vx & tx)[:, None, :]
        out_lbl = torch.where(lmask, out, void_class_id)
    return out_img, out_lbl


def random_translate_scale(gen_translate, gen_scale, images, label_ids, x_spec, y_spec,
                           t_prob: float, s_lo: float, s_hi: float, s_prob: float,
                           void_class_id: int = 0):
    """Fused translate -> scale, drawing from the two generators exactly as
    ``random_translate`` and ``random_scale`` do."""
    n = images.shape[0]
    dx, dy = draw_translate(gen_translate, n, x_spec, y_spec, t_prob)
    factor = draw_scale(gen_scale, n, s_lo, s_hi, s_prob)
    return apply_translate_scale(images, label_ids, dx, dy, factor, void_class_id)


# ---------------------------------------------------------------------------
# resize, grayscale
# ---------------------------------------------------------------------------


def resize(images, label_ids, size_hw):
    """Batch resize to a static (h, w): bilinear for images (coordinates in
    float64 on the host, like cv2's, then fp32), nearest for labels (cv2's
    exact indices)."""
    h_out, w_out = int(size_hw[0]), int(size_hw[1])
    n, h, w = images.shape[:3]
    dev = images.device
    fy, fx, iy, ix = (t[None, :].expand(n, -1) for t in _resize_coords(h_out, h, w_out, w, dev))
    all_y = torch.ones((n, h_out), dtype=torch.bool, device=dev)
    all_x = torch.ones((n, w_out), dtype=torch.bool, device=dev)
    out_img = _bilinear_sample(images, fy, fx, all_y, all_x).to(images.dtype)
    out_lbl = None
    if label_ids is not None:
        out_lbl = _nearest_sample(label_ids, iy, ix, all_y, all_x, 0)
    return out_img, out_lbl


@functools.lru_cache(maxsize=64)
def _resize_coords(h_out: int, h: int, w_out: int, w: int, device: torch.device):
    """``resize``'s bilinear coordinates (fp32) and nearest indices along
    each axis on ``device``, made once per shape and device and shared
    (read only): a copy from the host on every call would sync with it, and
    cannot be captured in a CUDA graph."""
    fy = ((np.arange(h_out) + 0.5) * (h / h_out) - 0.5).astype(np.float32)
    fx = ((np.arange(w_out) + 0.5) * (w / w_out) - 0.5).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (fy, fx, nearest_indices(h_out, h), nearest_indices(w_out, w)))


def grayscale(images):
    """RGB -> one channel, keeping the channel dim; bit-exact with
    ``cv2.COLOR_RGB2GRAY``'s Q14 weights ``(R*4899 + G*9617 + B*1868 +
    8192) >> 14``."""
    rgb = images.to(torch.int32)
    y = (rgb[..., 0] * 4899 + rgb[..., 1] * 9617 + rgb[..., 2] * 1868 + (1 << 13)) >> 14
    return y.to(images.dtype)[..., None]


# ---------------------------------------------------------------------------
# photometric extras and label noise
# ---------------------------------------------------------------------------


def _gray601(rgb):
    """Per-pixel Rec.601 luminance, float."""
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def _to_uint8(out, dtype):
    return torch.clamp(torch.round(out), 0.0, 255.0).to(dtype)


def apply_contrast(images, factor):
    """``round(mean + f * (x - mean))`` toward the per-image Rec.601 mean."""
    rgb = images.to(torch.float32)
    mean = torch.mean(_gray601(rgb), dim=(1, 2))[:, None, None, None]
    return _to_uint8(mean + factor[:, None, None, None] * (rgb - mean), images.dtype)


def apply_saturation(images, factor):
    """``round(gray + f * (x - gray))`` toward the per-pixel Rec.601 gray."""
    rgb = images.to(torch.float32)
    gray = _gray601(rgb)[..., None]
    return _to_uint8(gray + factor[:, None, None, None] * (rgb - gray), images.dtype)


def apply_gamma(images, gamma):
    """``round(255 * (x / 255) ** g)``."""
    x = images.to(torch.float32) / 255.0
    return _to_uint8(255.0 * torch.pow(x, gamma[:, None, None, None]), images.dtype)


def _mod(x, m: float):
    """Floor modulo as XLA computes it: C ``fmod``, then ``+ m`` where the
    remainder is non-zero and its sign differs from ``m``'s."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def apply_hue(images, delta):
    """Hue rotation by per-sample ``delta`` turns, V and S kept: the
    vectorised ``colorsys`` round trip."""
    rgb = images.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    safe_c = torch.clamp(c, min=1e-12)
    # hue in sectors [0, 6): r-major, then g-major, then b-major (colorsys
    # tie priority)
    h = torch.where(c == 0.0, 0.0,
                    torch.where(mx == r, _mod((g - b) / safe_c, 6.0),
                                torch.where(mx == g, (b - r) / safe_c + 2.0,
                                            (r - g) / safe_c + 4.0)))
    h = _mod(h + delta[:, None, None] * 6.0, 6.0)
    x = c * (1.0 - torch.abs(_mod(h, 2.0) - 1.0))
    sector = torch.floor(h).to(torch.int32)
    zeros = torch.zeros_like(c)

    def select(choices, default):  # jnp.select: the first sector that matches
        out = default
        for s in reversed(range(len(choices))):
            out = torch.where(sector == s, choices[s], out)
        return out

    r1 = select([c, x, zeros, zeros, x], c)
    g1 = select([x, c, c, x, zeros], zeros)
    b1 = select([zeros, zeros, x, c, c], x)
    return _to_uint8(torch.stack([r1, g1, b1], dim=-1) + mn[..., None], images.dtype)


def random_contrast(gen, images, lo: float, hi: float, prob: float):
    return apply_contrast(images, draw_photometric(gen, images.shape[0], lo, hi, prob, 1.0))


def random_saturation(gen, images, lo: float, hi: float, prob: float):
    return apply_saturation(images, draw_photometric(gen, images.shape[0], lo, hi, prob, 1.0))


def random_gamma(gen, images, lo: float, hi: float, prob: float):
    return apply_gamma(images, draw_photometric(gen, images.shape[0], lo, hi, prob, 1.0))


def random_hue(gen, images, max_delta: float, prob: float):
    return apply_hue(images, draw_photometric(gen, images.shape[0], -max_delta, max_delta,
                                              prob, 0.0))


def draw_label_noise(gen: torch.Generator, shape, rate: float, block: int, num_classes: int):
    """(fire (n, bh, bw) bool, values (n, bh, bw) int64) for labels of
    ``shape`` (n, h, w): one draw per ``block`` x ``block`` tile."""
    n, h, w = shape
    bh, bw = -(-h // block), -(-w // block)
    u = torch.rand((n, bh, bw), generator=gen, device=gen.device)
    vals = torch.randint(0, num_classes, (n, bh, bw), generator=gen, device=gen.device)
    return u < rate, vals


def apply_label_noise(label_ids, fire, values, block: int):
    """Replace each tile where ``fire`` by its drawn value (labels only)."""
    h, w = label_ids.shape[1:]

    def full(t):
        return t.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :h, :w]

    return torch.where(full(fire.to(label_ids.device)),
                       full(values.to(label_ids.device, label_ids.dtype)), label_ids)


def random_label_noise(gen, label_ids, rate: float, block: int, num_classes: int):
    """Per-block random label replacement (DisturbLabel-style): with
    probability ``rate`` per tile, the tile's ids become one uniform draw
    from [0, num_classes)."""
    fire, values = draw_label_noise(gen, label_ids.shape, rate, block, num_classes)
    return apply_label_noise(label_ids, fire, values, block)


# module-level alias: make_augment_fn's `resize` parameter shadows the function
_resize_batch = resize


def make_augment_fn(
    *,
    flip: float | None = None,
    brightness: tuple | None = None,
    translate: tuple | None = None,
    crop: tuple | None = None,
    resize: tuple | None = None,
    scale: tuple | None = None,
    gray: bool = False,
    contrast: tuple | None = None,
    saturation: tuple | None = None,
    hue: tuple | None = None,
    gamma: tuple | None = None,
    label_noise: tuple | None = None,
    void_class_id: int = 0,
):
    """Compose ``(key, images, label_ids) -> (images, label_ids)`` in the
    reference's transform order (crop -> resize -> brightness -> flip ->
    translate -> scale -> gray) with the JAX package's options:

    * ``crop``: (height, width) random crop (crop <= image);
    * ``resize``: (height, width) static target;
    * ``brightness``: (lo, hi, prob), exact HSV-V scaling;
    * ``flip``: probability;
    * ``translate``: (x_spec, y_spec, prob), each spec an int max or a
      (lo, hi) magnitude range;
    * ``scale``: (lo, hi, prob) zoom with void fill / centre crop (with
      ``translate``, one fused resample);
    * ``gray``: cv2-exact grayscale (one output channel);
    * ``contrast`` / ``saturation`` / ``gamma``: (lo, hi, prob), and
      ``hue``: (max_delta, prob), after brightness, before the geometric
      transforms;
    * ``label_noise``: (rate, block, num_classes), applied last.

    ``key``: a ``numpy.random.SeedSequence``, an int, or a callable from
    slot to generator (see ``transform_generator``). The draws are made on
    the batch's device."""

    def augment(key, images, label_ids):
        dev = images.device

        def gen(slot):
            return transform_generator(key, slot, dev)

        if crop is not None:
            images, label_ids = random_crop(gen(CROP), images, label_ids, crop[0], crop[1])
        if resize is not None:
            images, label_ids = _resize_batch(images, label_ids, resize)
        if brightness is not None:
            images = random_brightness(gen(BRIGHTNESS), images, *brightness)
        if contrast is not None:
            images = random_contrast(gen(CONTRAST), images, *contrast)
        if saturation is not None:
            images = random_saturation(gen(SATURATION), images, *saturation)
        if hue is not None:
            images = random_hue(gen(HUE), images, *hue)
        if gamma is not None:
            images = random_gamma(gen(GAMMA), images, *gamma)
        if flip is not None:
            images, label_ids = random_horizontal_flip(gen(FLIP), images, label_ids, flip)
        if translate is not None and scale is not None:
            images, label_ids = random_translate_scale(
                gen(TRANSLATE), gen(SCALE), images, label_ids, translate[0], translate[1],
                translate[2], scale[0], scale[1], scale[2], void_class_id)
        elif translate is not None:
            images, label_ids = random_translate(gen(TRANSLATE), images, label_ids, translate[0],
                                                 translate[1], translate[2], void_class_id)
        elif scale is not None:
            images, label_ids = random_scale(gen(SCALE), images, label_ids, scale[0], scale[1],
                                             scale[2], void_class_id)
        if gray:
            images = grayscale(images)
        if label_noise is not None and label_ids is not None:
            label_ids = random_label_noise(gen(LABEL_NOISE), label_ids, *label_noise)
        return images, label_ids

    return augment
