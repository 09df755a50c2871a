"""PyTorch port, device augmentation (``ops/augment_device.py``) against the
JAX package and the host pipeline, on the CPU.

Three kinds of case:

* every case of tests/test_device_augment.py, on the port: where that file
  holds a JAX transform against the cv2 host pipeline (``data/augment.py``)
  or numpy, the port is held against the same reference with the same
  tolerance;
* one case per transform that draws with the JAX package on a fixed key
  (``_draw_translate``, ``_draw_scale``, ``_photometric_draw``, the crop's
  randint pair, the flip's uniform, label noise's pair), feeds those draws
  to the port's apply function and compares with JAX's output: labels
  exact; uint8 images exact for flip, crop, translate and grayscale; within
  1 LSB where an fp32 blend is rounded (bilinear scale and resize, the
  photometric transforms), since XLA and PyTorch may order or fuse the
  float operations differently;
* the port's own draws: a pure function of (key, transform slot), and in
  ``train(device_augment=...)`` of (seed, step), never a dropout key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.data import augment as host_aug  # noqa: E402
from fcn8s_tensorflow_tpu.ops import augment_device as jaug  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import augment_device as aug  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402
from tests.conftest import FixedRng as _FixedRng  # noqa: E402


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.numpy()


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


# ---------------------------------------------------------------------------
# tests/test_device_augment.py, on the port
# ---------------------------------------------------------------------------


def test_flip_prob_one_matches_numpy(rng):
    images = rng.integers(0, 255, (3, 8, 10, 3), dtype=np.uint8)
    labels = rng.integers(0, 5, (3, 8, 10), dtype=np.uint8)
    out_img, out_lbl = aug.random_horizontal_flip(_gen(), _t(images), _t(labels), 1.0)
    np.testing.assert_array_equal(_np(out_img), images[:, :, ::-1])
    np.testing.assert_array_equal(_np(out_lbl), labels[:, :, ::-1])


def test_flip_prob_zero_identity(rng):
    images = rng.integers(0, 255, (2, 4, 4, 3), dtype=np.uint8)
    out_img, out_lbl = aug.random_horizontal_flip(_gen(), _t(images), None, 0.0)
    np.testing.assert_array_equal(_np(out_img), images)
    assert out_lbl is None


def test_brightness_clamps_and_scales():
    images = torch.full((2, 4, 4, 3), 200, dtype=torch.uint8)
    assert int(aug.random_brightness(_gen(), images, 2.0, 2.0, 1.0).max()) == 255
    images2 = torch.full((2, 4, 4, 3), 50, dtype=torch.uint8)
    np.testing.assert_array_equal(_np(aug.random_brightness(_gen(), images2, 2.0, 2.0, 1.0)), 100)


def test_translate_fills_void():
    images = torch.full((1, 6, 6, 3), 90, dtype=torch.uint8)
    labels = torch.full((1, 6, 6), 2, dtype=torch.uint8)
    for seed in range(4):
        out_img, out_lbl = aug.random_translate(_gen(seed), images, labels, 2, 2, 1.0,
                                                void_class_id=9)
        lbl, img = _np(out_lbl)[0], _np(out_img)[0]
        assert set(np.unique(lbl)) <= {2, 9}
        assert set(np.unique(img)) <= {0, 90}
        np.testing.assert_array_equal(lbl == 9, img[:, :, 0] == 0)


def test_random_crop_shapes(rng):
    images = _t(rng.integers(0, 255, (2, 16, 16, 3), dtype=np.uint8))
    labels = _t(rng.integers(0, 5, (2, 16, 16), dtype=np.uint8))
    out_img, out_lbl = aug.random_crop(_gen(), images, labels, 8, 12)
    assert out_img.shape == (2, 8, 12, 3) and out_lbl.shape == (2, 8, 12)
    with pytest.raises(ValueError):
        aug.random_crop(_gen(), images, labels, 32, 32)


def test_pipeline_is_deterministic_per_key(rng):
    fn = aug.make_augment_fn(flip=0.5, brightness=(0.8, 1.2, 0.5), translate=(2, 2, 0.5),
                             crop=(8, 8), void_class_id=0)
    images = _t(rng.integers(0, 255, (4, 16, 16, 3), dtype=np.uint8))
    labels = _t(rng.integers(0, 5, (4, 16, 16), dtype=np.uint8))
    out_img, out_lbl = fn(0, images, labels)
    assert out_img.shape == (4, 8, 8, 3) and out_lbl.shape == (4, 8, 8)
    again, _ = fn(np.random.SeedSequence(0), images, labels)  # an int key is its SeedSequence
    assert torch.equal(out_img, again)
    other, _ = fn(1, images, labels)
    assert not torch.equal(out_img, other)


def test_train_with_device_augment(rng):
    """Facade train with device_augment runs."""
    model = FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32,
                  compute_dtype=torch.float32, device="cpu")
    images = rng.integers(0, 255, (2, 32, 32, 3), dtype=np.uint8)
    labels = np.zeros((2, 32, 32), np.uint8)
    labels[:, :, 16:] = 1

    def gen():
        while True:
            yield images, labels

    model.train(gen(), epochs=1, steps_per_epoch=3, learning_rate_schedule=lambda s: 1e-3,
                keep_prob=1.0, record_summaries=False,
                device_augment={"flip": 0.5, "brightness": (0.9, 1.1, 0.5)})
    assert np.isfinite(model.training_loss) and model.state.step == 3


def test_augment_config_switch_reuses_the_built_fn(rng):
    """The counterpart of the JAX test's executable cache: the augment fn is
    built once per distinct config and dropped when augmentation is off."""
    model = FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32,
                  compute_dtype=torch.float32, device="cpu")
    images = rng.integers(0, 255, (2, 32, 32, 3), dtype=np.uint8)
    labels = np.zeros((2, 32, 32), np.uint8)

    def gen():
        while True:
            yield images, labels

    kw = dict(epochs=1, steps_per_epoch=1, learning_rate_schedule=lambda s: 1e-3,
              keep_prob=1.0, record_summaries=False, prefetch=0)
    model.train(gen(), device_augment={"flip": 0.5}, **kw)
    built = model._augment_fn
    model.train(gen(), device_augment={"flip": 0.5}, **kw)
    assert model._augment_fn is built
    model.train(gen(), device_augment=None, **kw)
    assert model._augment_fn is None
    model.train(gen(), device_augment={"flip": 1.0}, **kw)
    assert model._augment_fn is not None and model._augment_fn is not built


def _cv2_divergence_mask(size, factor):
    """Output positions where cv2's INTER_NEAREST double arithmetic picks
    another source pixel than the exact rational floor (exact-integer ties)."""
    patch = int(size * factor)
    off = abs(size - patch) // 2
    o = np.arange(size)
    p = o - off if patch <= size else o + off
    valid = (p >= 0) & (p <= patch - 1)
    exact = (p * size) // max(patch, 1)
    cv = np.minimum(np.floor(p * (1.0 / (patch / size))), size - 1).astype(int)
    return valid & (cv != exact)


@pytest.mark.parametrize("factor", [0.5, 0.7, 1.0, 1.3, 2.0])
def test_scale_zoom_matches_host(rng, factor):
    """Port zoom == cv2 host zoom: labels nearest-exact away from cv2's
    exact-integer ties, images bilinear within 1 (cv2 fixed point vs fp32)."""
    image = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    gt = rng.integers(0, 20, (40, 56), dtype=np.uint8)
    host_img, host_gt = host_aug.scale_zoom(
        _FixedRng(uniform_value=factor), image.copy(), gt.copy(), factor, factor, 7)
    dev_img, dev_gt = aug.random_scale(_gen(), _t(image[None]), _t(gt[None]), factor, factor,
                                       1.0, void_class_id=7)
    mismatch = _np(dev_gt)[0] != host_gt
    tie = _cv2_divergence_mask(40, factor)[:, None] | _cv2_divergence_mask(56, factor)[None, :]
    assert not mismatch[~tie].any(), f"off-tie GT mismatch @factor={factor}"
    assert tie.mean() < 0.2
    diff = np.abs(_np(dev_img)[0].astype(int) - host_img.astype(int))
    assert diff[~tie].max() <= 1, f"bilinear image mismatch {diff[~tie].max()} @factor={factor}"


def test_scale_prob_zero_is_identity(rng):
    image = _t(rng.integers(0, 256, (2, 24, 32, 3), dtype=np.uint8))
    gt = _t(rng.integers(0, 5, (2, 24, 32), dtype=np.uint8))
    out_img, out_gt = aug.random_scale(_gen(), image, gt, 0.5, 2.0, 0.0)
    assert torch.equal(out_img, image) and torch.equal(out_gt, gt)


@pytest.mark.parametrize("size", [(20, 28), (57, 83), (80, 112)])
def test_resize_matches_host(rng, size):
    image = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    gt = rng.integers(0, 20, (40, 56), dtype=np.uint8)
    host_img, host_gt = host_aug.resize_pair(image.copy(), gt.copy(), size)
    dev_img, dev_gt = aug.resize(_t(image[None]), _t(gt[None]), size)
    np.testing.assert_array_equal(_np(dev_gt)[0], host_gt)
    assert _lsb(_np(dev_img)[0], host_img) <= 1, f"bilinear resize @size={size}"


def test_grayscale_matches_host_exactly(rng):
    image = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    dev = aug.grayscale(_t(image[None]))
    assert dev.shape == (1, 32, 48, 1)
    np.testing.assert_array_equal(_np(dev)[0], host_aug.grayscale(image))


def test_brightness_exact_hsv_semantics(rng):
    image = rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    factor = 1.8
    out = _np(aug.random_brightness(_gen(), _t(image), factor, factor, 1.0))[0].astype(np.float64)
    src = image[0].astype(np.float64)
    v_src, v_out = src.max(-1), out.max(-1)
    np.testing.assert_array_equal(v_out, np.floor(np.minimum(v_src * factor, 255.0)))
    mask = v_src > 0
    expect = src * np.where(mask, v_out / np.maximum(v_src, 1), 0)[..., None]
    assert np.abs(out - expect).max() <= 0.5 + 1e-9


def test_brightness_divergence_from_host_bounded(rng):
    image = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    worst_max, worst_mean = 0, 0.0
    for factor in (0.5, 0.8, 1.2, 1.7, 2.5):
        host = host_aug.brightness_hsv(_FixedRng(uniform_value=factor), image.copy(), factor,
                                       factor)
        dev = _np(aug.random_brightness(_gen(), _t(image[None]), factor, factor, 1.0))[0]
        diff = np.abs(host.astype(int) - dev.astype(int))
        worst_max, worst_mean = max(worst_max, diff.max()), max(worst_mean, diff.mean())
    assert worst_max <= 8, worst_max
    assert worst_mean <= 1.0, worst_mean


def _shift_ramp(src, s):
    out = np.zeros_like(src)
    if s >= 0:
        out[s:] = src[: len(src) - s] if s else src
    else:
        out[:s] = src[-s:]
    return out


def test_translate_host_style_ranges(rng):
    """(lo, hi) magnitude-range translate: |shift| in [lo, hi]."""
    image = _t(np.tile(np.arange(64, dtype=np.uint8)[None, :, None], (1, 16, 1, 3)))
    lbl = _t(rng.integers(1, 5, (1, 16, 64), dtype=np.uint8))
    for seed in range(6):
        out_img, _ = aug.random_translate(_gen(seed), image, lbl, (3, 5), (0, 0), 1.0)
        row = _np(out_img)[0, 0, :, 0].astype(int)
        matches = [s for s in range(-5, 6) if np.array_equal(row, _shift_ramp(np.arange(64), s))]
        assert matches and 3 <= abs(matches[0]) <= 5, (seed, row[:8])


def test_full_pipeline_with_all_transforms(rng):
    fn = aug.make_augment_fn(crop=(32, 32), resize=(24, 40), brightness=(0.8, 1.2, 0.5),
                             flip=0.5, translate=((1, 3), (1, 2), 0.5), scale=(0.8, 1.2, 0.5),
                             void_class_id=0)
    images = _t(rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8))
    labels = _t(rng.integers(0, 5, (4, 40, 40), dtype=np.uint8))
    out_img, out_lbl = fn(0, images, labels)
    assert out_img.shape == (4, 24, 40, 3) and out_lbl.shape == (4, 24, 40)
    assert out_img.dtype == torch.uint8
    g_img, _ = aug.make_augment_fn(gray=True)(0, images, labels)
    assert g_img.shape == (4, 40, 40, 1)


def _factor_of(gen_seed, n, lo, hi):
    """The port's photometric factor draw for prob=1 (the draw, replayed)."""
    return _np(aug.draw_photometric(_gen(gen_seed), n, lo, hi, 1.0, 1.0)).astype(np.float32)


def test_contrast_matches_numpy_reference(rng):
    images = rng.integers(0, 255, (2, 6, 8, 3), dtype=np.uint8)
    out = _np(aug.random_contrast(_gen(3), _t(images), 0.5, 1.5, 1.0))
    f = _factor_of(3, 2, 0.5, 1.5)
    x = images.astype(np.float32)
    mean = (x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114).mean(axis=(1, 2))
    exp = np.clip(np.round(mean[:, None, None, None]
                           + f[:, None, None, None] * (x - mean[:, None, None, None])), 0, 255)
    assert _lsb(out, exp) <= 1  # the mean's summation order: numpy's vs PyTorch's


def test_saturation_matches_numpy_reference(rng):
    images = rng.integers(0, 255, (2, 6, 8, 3), dtype=np.uint8)
    out = _np(aug.random_saturation(_gen(4), _t(images), 0.0, 2.0, 1.0))
    f = _factor_of(4, 2, 0.0, 2.0)
    x = images.astype(np.float32)
    gray = (x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114)[..., None]
    exp = np.clip(np.round(gray + f[:, None, None, None] * (x - gray)), 0, 255)
    np.testing.assert_array_equal(out, exp.astype(np.uint8))
    out0 = _np(aug.random_saturation(_gen(5), _t(images), 0.0, 0.0, 1.0))
    assert (out0[..., 0] == out0[..., 1]).all() and (out0[..., 1] == out0[..., 2]).all()


def test_gamma_matches_numpy_reference(rng):
    images = rng.integers(0, 255, (2, 6, 8, 3), dtype=np.uint8)
    out = _np(aug.random_gamma(_gen(6), _t(images), 0.5, 2.0, 1.0))
    g = _factor_of(6, 2, 0.5, 2.0)
    x = images.astype(np.float32) / 255.0
    exp = np.clip(np.round(255.0 * x ** g[:, None, None, None]), 0, 255)
    assert _lsb(out, exp) <= 1


def test_hue_matches_colorsys_loop(rng):
    import colorsys

    images = rng.integers(0, 255, (1, 5, 7, 3), dtype=np.uint8)
    delta = float(_np(aug.draw_photometric(_gen(7), 1, -0.25, 0.25, 1.0, 0.0))[0])
    out = _np(aug.random_hue(_gen(7), _t(images), 0.25, 1.0))
    x = images[0].astype(np.float64) / 255.0
    exp = np.zeros_like(x)
    for i in range(x.shape[0]):
        for j in range(x.shape[1]):
            h, s, v = colorsys.rgb_to_hsv(*x[i, j])
            exp[i, j] = colorsys.hsv_to_rgb((h + delta) % 1.0, s, v)
    exp = np.clip(np.round(exp * 255.0), 0, 255)
    assert _lsb(out[0], exp) <= 1


def test_hue_preserves_value_and_gray_pixels(rng):
    images = rng.integers(0, 255, (2, 6, 8, 3), dtype=np.uint8)
    out = _np(aug.random_hue(_gen(8), _t(images), 0.5, 1.0))
    np.testing.assert_array_equal(out.max(-1), images.max(-1))
    gray = torch.full((1, 4, 4, 3), 77, dtype=torch.uint8)
    assert torch.equal(aug.random_hue(_gen(9), gray, 0.5, 1.0), gray)


def test_photometric_prob_zero_identity(rng):
    images = _t(rng.integers(0, 255, (2, 6, 8, 3), dtype=np.uint8))
    for fn, args in [(aug.random_contrast, (0.5, 1.5)), (aug.random_saturation, (0.0, 2.0)),
                     (aug.random_gamma, (0.5, 2.0))]:
        assert torch.equal(fn(_gen(10), images, *args, 0.0), images)
    assert torch.equal(aug.random_hue(_gen(10), images, 0.3, 0.0), images)


def test_pipeline_with_photometric_extras(rng):
    images = _t(rng.integers(0, 255, (2, 32, 32, 3), dtype=np.uint8))
    labels = _t(rng.integers(0, 3, (2, 32, 32), dtype=np.uint8))
    fn = aug.make_augment_fn(flip=0.5, brightness=(0.8, 1.2, 0.5), contrast=(0.7, 1.3, 0.5),
                             saturation=(0.5, 1.5, 0.5), hue=(0.1, 0.5), gamma=(0.7, 1.4, 0.5))
    out_i, out_l = fn(0, images, labels)
    assert out_i.shape == images.shape and out_i.dtype == images.dtype
    assert out_l.shape == labels.shape


def test_key_streams_independent_of_other_options(rng):
    """Enabling a photometric extra moves no other transform's draws: each
    slot has its own generator (JAX keeps its legacy 5-key stream for the
    same reason)."""
    images = _t(rng.integers(0, 255, (2, 16, 16, 3), dtype=np.uint8))
    labels = _t(rng.integers(0, 3, (2, 16, 16), dtype=np.uint8))
    key = np.random.SeedSequence(11)
    out_i, _ = aug.make_augment_fn(flip=0.5, brightness=(0.8, 1.2, 0.5))(key, images, labels)
    exp = aug.random_brightness(aug.transform_generator(key, aug.BRIGHTNESS, "cpu"), images,
                                0.8, 1.2, 0.5)
    exp, _ = aug.random_horizontal_flip(aug.transform_generator(key, aug.FLIP, "cpu"), exp,
                                        labels, 0.5)
    assert torch.equal(out_i, exp)
    with_gamma, _ = aug.make_augment_fn(flip=0.5, brightness=(0.8, 1.2, 0.5),
                                        gamma=(1.0, 1.0, 1.0))(key, images, labels)
    assert torch.equal(with_gamma, out_i)  # gamma 1 is the identity; the others' draws stay


@pytest.mark.parametrize("s_lo,s_hi", [(0.7, 1.5), (0.6, 0.95), (1.05, 1.6)])
def test_fused_translate_scale_bitwise_equals_sequential(rng, s_lo, s_hi):
    n, h, w = 4, 40, 56
    images = _t(rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8))
    labels = _t(rng.integers(0, 6, (n, h, w), dtype=np.uint8))
    im_seq, lb_seq = aug.random_translate(_gen(1), images, labels, (0, 9), (0, 5), 0.8,
                                          void_class_id=2)
    im_seq, lb_seq = aug.random_scale(_gen(2), im_seq, lb_seq, s_lo, s_hi, 0.9, void_class_id=2)
    im_f, lb_f = aug.random_translate_scale(_gen(1), _gen(2), images, labels, (0, 9), (0, 5),
                                            0.8, s_lo, s_hi, 0.9, void_class_id=2)
    assert torch.equal(im_f, im_seq) and torch.equal(lb_f, lb_seq)


def test_fused_translate_scale_image_only_path(rng):
    images = _t(rng.integers(0, 255, (4, 40, 56, 3), dtype=np.uint8))
    im_seq, _ = aug.random_translate(_gen(1), images, None, 4, 3, 0.7)
    im_seq, _ = aug.random_scale(_gen(2), im_seq, None, 0.8, 1.2, 0.7)
    im_f, lb_none = aug.random_translate_scale(_gen(1), _gen(2), images, None, 4, 3, 0.7,
                                               0.8, 1.2, 0.7)
    assert lb_none is None and torch.equal(im_f, im_seq)


def test_label_noise_rate_and_blockwise(rng):
    labels = rng.integers(1, 6, (8, 64, 64), dtype=np.uint8)
    out = _np(aug.random_label_noise(_gen(0), _t(labels), rate=0.05, block=4, num_classes=6))
    rate = (out != labels).mean()
    assert abs(rate - 0.05 * 5 / 6) < 0.012, rate
    assert out.dtype == labels.dtype
    for s, y, x in zip(*np.where(out != labels)):
        by, bx = (y // 4) * 4, (x // 4) * 4
        assert (out[s, by:by + 4, bx:bx + 4] == out[s, y, x]).all()


def test_label_noise_deterministic_and_rate_zero_identity(rng):
    labels = _t(rng.integers(0, 6, (4, 32, 32), dtype=np.uint8))
    a = aug.random_label_noise(_gen(3), labels, 0.1, 4, 6)
    assert torch.equal(a, aug.random_label_noise(_gen(3), labels, 0.1, 4, 6))
    assert torch.equal(aug.random_label_noise(_gen(3), labels, 0.0, 4, 6), labels)


def test_label_noise_covers_augment_void_borders(rng):
    images = _t(rng.integers(0, 255, (16, 32, 48, 3), dtype=np.uint8))
    labels = torch.full((16, 32, 48), 3, dtype=torch.uint8)
    fn = aug.make_augment_fn(translate=((4, 8), (4, 8), 1.0), scale=(0.7, 0.9, 1.0),
                             label_noise=(0.3, 2, 6), void_class_id=0)
    _, out_l = fn(5, images, labels)
    assert (_np(out_l)[:, 0, :] != 0).any(), "label noise never landed on void borders"


def test_label_noise_slot_leaves_other_draws(rng):
    """Enabling label_noise at rate 0 changes nothing else."""
    images = _t(rng.integers(0, 255, (2, 16, 16, 3), dtype=np.uint8))
    labels = _t(rng.integers(0, 3, (2, 16, 16), dtype=np.uint8))
    base = aug.make_augment_fn(flip=0.5, brightness=(0.8, 1.2, 0.5))
    noisy = aug.make_augment_fn(flip=0.5, brightness=(0.8, 1.2, 0.5), label_noise=(0.0, 4, 3))
    (bi, bl), (ni, nl) = base(11, images, labels), noisy(11, images, labels)
    assert torch.equal(bi, ni) and torch.equal(bl, nl)


# ---------------------------------------------------------------------------
# the port's apply functions fed the JAX package's draws
# ---------------------------------------------------------------------------

N, H, W = 4, 40, 56


@pytest.fixture
def batch(rng):
    return (rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8),
            rng.integers(0, 6, (N, H, W), dtype=np.uint8))


def test_flip_apply_on_jax_draws(batch):
    images, labels = batch
    key = jax.random.PRNGKey(1)
    flip = np.asarray(jax.random.uniform(key, (N,)) >= (1.0 - 0.5))
    ji, jl = jaug.random_horizontal_flip(key, jnp.asarray(images), jnp.asarray(labels), 0.5)
    ti, tl = aug.apply_flip(_t(images), _t(labels), _t(flip))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))


@pytest.mark.parametrize("name,args,identity", [
    ("brightness", (0.5, 1.7, 0.7), 1.0), ("contrast", (0.5, 1.5, 0.7), 1.0),
    ("saturation", (0.0, 2.0, 0.7), 1.0), ("gamma", (0.5, 2.0, 0.7), 1.0),
    ("hue", (0.3, 0.7), 0.0)])
def test_photometric_apply_on_jax_draws(batch, name, args, identity):
    images, _ = batch
    key = jax.random.PRNGKey(2)
    if name == "hue":
        factor = jaug._photometric_draw(key, N, -args[0], args[0], args[1], identity)
    else:
        factor = jaug._photometric_draw(key, N, *args, identity)
    want = getattr(jaug, f"random_{name}")(key, jnp.asarray(images), *args)
    got = getattr(aug, f"apply_{name}")(_t(images), _t(np.asarray(factor)))
    assert got.dtype == torch.uint8
    assert _lsb(_np(got), want) <= 1


@pytest.mark.parametrize("spec", [((0, 9), (2, 5), 0.8), (7, 4, 1.0)])
def test_translate_apply_on_jax_draws(batch, spec):
    images, labels = batch
    key = jax.random.PRNGKey(3)
    dx, dy, _, _ = jaug._draw_translate(key, N, *spec)
    ji, jl = jaug.random_translate(key, jnp.asarray(images), jnp.asarray(labels), *spec,
                                   void_class_id=2)
    ti, tl = aug.apply_translate(_t(images), _t(labels), _t(dx).long(), _t(dy).long(), 2)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))


@pytest.mark.parametrize("lo,hi", [(0.6, 1.5), (0.5, 0.9), (1.1, 2.0)])
def test_scale_apply_on_jax_draws(batch, lo, hi):
    images, labels = batch
    key = jax.random.PRNGKey(4)
    factor = jaug._draw_scale(key, N, lo, hi, 0.9)
    ji, jl = jaug.random_scale(key, jnp.asarray(images), jnp.asarray(labels), lo, hi, 0.9,
                               void_class_id=3)
    ti, tl = aug.apply_scale(_t(images), _t(labels), _t(np.asarray(factor)), 3)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    assert _lsb(_np(ti), ji) <= 1


def test_translate_scale_apply_on_jax_draws(batch):
    images, labels = batch
    kt, ks = jax.random.split(jax.random.PRNGKey(5))
    dx, dy, _, _ = jaug._draw_translate(kt, N, (0, 9), (0, 5), 0.8)
    factor = jaug._draw_scale(ks, N, 0.7, 1.5, 0.9)
    ji, jl = jaug.random_translate_scale(kt, ks, jnp.asarray(images), jnp.asarray(labels),
                                         (0, 9), (0, 5), 0.8, 0.7, 1.5, 0.9, void_class_id=2)
    args = (_t(dx).long(), _t(dy).long(), _t(np.asarray(factor)))
    ti, tl = aug.apply_translate_scale(_t(images), _t(labels), *args, 2)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    assert _lsb(_np(ti), ji) <= 1
    # and the port's fused apply is its sequential pair, byte for byte
    si, sl = aug.apply_translate(_t(images), _t(labels), args[0], args[1], 2)
    si, sl = aug.apply_scale(si, sl, args[2], 2)
    assert torch.equal(ti, si) and torch.equal(tl, sl)


def test_crop_apply_on_jax_draws(batch):
    images, labels = batch
    key = jax.random.PRNGKey(6)
    k1, k2 = jax.random.split(key)
    y0 = np.asarray(jax.random.randint(k1, (N,), 0, H - 24 + 1))
    x0 = np.asarray(jax.random.randint(k2, (N,), 0, W - 32 + 1))
    ji, jl = jaug.random_crop(key, jnp.asarray(images), jnp.asarray(labels), 24, 32)
    ti, tl = aug.apply_crop(_t(images), _t(labels), _t(y0).long(), _t(x0).long(), 24, 32)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))


@pytest.mark.parametrize("size", [(20, 28), (57, 83)])
def test_resize_and_grayscale_match_jax(batch, size):
    images, labels = batch
    ji, jl = jaug.resize(jnp.asarray(images), jnp.asarray(labels), size)
    ti, tl = aug.resize(_t(images), _t(labels), size)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    assert _lsb(_np(ti), ji) <= 1
    np.testing.assert_array_equal(_np(aug.grayscale(_t(images))),
                                  np.asarray(jaug.grayscale(jnp.asarray(images))))


def test_label_noise_apply_on_jax_draws(batch):
    _, labels = batch
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    bh, bw = -(-H // 3), -(-W // 3)
    fire = np.asarray(jax.random.uniform(k1, (N, bh, bw)) < 0.2)
    vals = np.asarray(jax.random.randint(k2, (N, bh, bw), 0, 6))
    want = jaug.random_label_noise(key, jnp.asarray(labels), 0.2, 3, 6)
    got = aug.apply_label_noise(_t(labels), _t(fire), _t(vals).long(), 3)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# the draws of train(device_augment=...)
# ---------------------------------------------------------------------------


def test_augment_key_is_a_function_of_seed_and_step_and_never_dropouts():
    def seed_of(ss):
        return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))

    dropout = {seed_of(np.random.SeedSequence(k)) for s in range(3) for t in range(20)
               for k in ([s, t], *([s, t, m] for m in range(4)))}
    augment = set()
    for s in range(3):
        for t in range(20):
            key = tsteps.augment_key(s, t)
            assert key.spawn_key == (tsteps.AUGMENT_STREAM,) and tuple(key.entropy) == (s, t)
            for slot in range(10):
                child = np.random.SeedSequence(key.entropy, spawn_key=key.spawn_key + (slot,))
                augment.add(seed_of(child))
            a = aug.transform_generator(key, aug.FLIP, "cpu")
            b = aug.transform_generator(tsteps.augment_key(s, t), aug.FLIP, "cpu")
            assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))
    assert not dropout & augment and len(augment) == 3 * 20 * 10


def test_train_augments_with_draws_of_seed_and_step(rng, tmp_path):
    """``train(device_augment=...)`` hands the step the key (seed, step):
    a run resumed at step 2 augments steps 2 and 3 as the uninterrupted
    run did, and the batch the step trained on is the augment fn's output
    for that key. On the facade's eager steps the fn sees the keys; on its
    compiled steps (the default) it sees the draw sites of generators
    seeded from them, after ``WARMUP`` warm-up calls per capture (the
    first draws what the first step draws), and gives the eager steps'
    batches."""
    from fcn8s_tensorflow_tpu_torch.parallel.graphs import WARMUP

    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (2, 32, 32), dtype=np.uint8)
    cfg = {"flip": 0.5, "translate": (4, 4, 0.8), "brightness": (0.7, 1.3, 0.8)}
    seen = {}

    def recorder(model, eager):
        fn = aug.make_augment_fn(**cfg)

        def record(key, im, lb):
            out = fn(key, im, lb)
            seen.setdefault(id(model), []).append((key, out))
            return out

        model._augment_fn, model._device_augment_cfg = record, cfg  # reused: same config
        if eager:
            model._eager_steps = True

    def run(model, steps):
        model.train(iter([(images, labels)] * steps), 1, steps, lambda s: 1e-3, keep_prob=0.5,
                    record_summaries=False, device_augment=cfg, prefetch=0)

    def runs(eager):
        whole = FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32,
                      compute_dtype=torch.float32, device="cpu", seed=7)
        recorder(whole, eager)
        run(whole, 4)
        first = FCN8s(num_classes=3, width_mult=1 / 32, fc_channels=32,
                      compute_dtype=torch.float32, device="cpu", seed=7)
        recorder(first, eager)
        run(first, 2)
        first.save(str(tmp_path / str(eager)))
        resumed = FCN8s.resume(str(tmp_path / str(eager)), device="cpu", seed=7)
        recorder(resumed, eager)
        run(resumed, 2)
        return [seen[id(m)] for m in (whole, first, resumed)]

    whole, first, resumed = runs(eager=True)
    a, b = whole, first + resumed
    assert [(list(k.entropy), k.spawn_key) for k, _ in a] == [([7, t], (1,)) for t in range(4)]
    assert [(list(k.entropy), k.spawn_key) for k, _ in b] == [([7, t], (1,)) for t in range(4)]
    for (_, (ia, la)), (_, (ib, lb)) in zip(a, b):
        assert torch.equal(ia, ib) and torch.equal(la, lb)
    compiled = runs(eager=False)
    assert [len(c) for c in compiled] == [WARMUP + 4, WARMUP + 2, WARMUP + 2]
    for calls, want in zip(compiled, (a, b[:2], b[2:])):
        for (_, (ig, lg)), (_, (iw, lw)) in zip(calls[:1] + calls[WARMUP:], want[:1] + want):
            assert torch.equal(ig, iw) and torch.equal(lg, lw)
    assert any(not torch.equal(o[0], torch.from_numpy(images)) for _, o in a)
