"""PyTorch port, ``viz/overlay.py`` against the JAX package's and OpenCV.

The overlay and the split view equal the JAX package's exactly (the same
float32 compositing). The port's uint8 bilinear resize replaces
``cv2.resize(..., INTER_LINEAR)``, which the card's installation lacks; it
is held bit-exact against OpenCV (installed here) on up- and downscales,
odd sizes, 1, 3 and 4 channels: the stated gap is 0 LSB on every pixel.
"""

import cv2
import numpy as np
import pytest

from fcn8s_tensorflow_tpu.labels import TRAINIDS_TO_RGBA_DICT
from fcn8s_tensorflow_tpu.viz import overlay as j_overlay
from fcn8s_tensorflow_tpu_torch.viz import overlay

CMAP = {0: (0, 0, 0, 0), 1: (255, 0, 0, 127), 2: (0, 255, 0, 255), -1: (9, 9, 9, 9)}


@pytest.mark.parametrize("src,dst", [
    ((64, 128), (100, 150)), ((48, 64), (96, 128)), ((30, 40), (31, 41)), ((50, 60), (77, 101)),
    ((100, 70), (37, 53)), ((512, 1024), (256, 512)), ((33, 47), (200, 19)), ((7, 9), (3, 2)),
    ((256, 512), (300, 700)), ((2, 2), (1, 1)), ((1, 5), (4, 9)), ((120, 160), (120, 161)),
])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_is_bit_exact_against_opencv(rng, src, dst, channels):
    shape = src if channels == 1 else (*src, channels)
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    got = overlay.resize_linear_u8(image, dst)
    want = cv2.resize(image, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_resize_at_the_images_own_size_is_a_copy(rng):
    image = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    got = overlay.resize_linear_u8(image, (40, 60))
    np.testing.assert_array_equal(got, image)
    assert not np.shares_memory(got, image)


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 3), np.float32), np.zeros((4,), np.uint8)])
def test_resize_rejects_other_inputs(bad):
    with pytest.raises(ValueError):
        overlay.resize_linear_u8(bad, (2, 2))


@pytest.mark.parametrize("pred_kind", ["ids", "scores", "batch_scores", "batch_ids"])
@pytest.mark.parametrize("cmap", ["small", "cityscapes"])
def test_overlay_equals_the_jax_packages(rng, pred_kind, cmap):
    color_map = CMAP if cmap == "small" else TRAINIDS_TO_RGBA_DICT
    c = 3 if cmap == "small" else 20
    image = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    if pred_kind == "ids":
        pred = rng.integers(0, c + 2, (24, 40)).astype(np.int32)  # ids past the map clip
    elif pred_kind == "batch_ids":
        pred = rng.integers(0, c, (1, 24, 40)).astype(np.int32)
    else:
        pred = rng.normal(size=(24, 40, c)).astype(np.float32)
        if pred_kind == "batch_scores":
            pred = pred[None]
    got = overlay.print_segmentation_onto_image(image, pred, color_map)
    np.testing.assert_array_equal(got, j_overlay.print_segmentation_onto_image(image, pred,
                                                                               color_map))


@pytest.mark.parametrize("args", [((8, 8), (8, 8)), ((8, 8, 3), (4, 4))])
def test_overlay_shape_errors(args):
    image_shape, pred_shape = args
    with pytest.raises(ValueError):
        overlay.print_segmentation_onto_image(np.zeros(image_shape, np.uint8),
                                              np.zeros(pred_shape, np.int32), CMAP)


@pytest.mark.parametrize("layout", ["vertical", "horizontal", "resized", "clipped", "gray"])
def test_split_view_equals_the_jax_packages(rng, layout):
    """Side by side at the images' own size (the copy ``predict_and_save``
    makes), resized into other slots, clipped at the canvas edge, and a
    grayscale input."""
    a = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    target, images, positions, sizes = {
        "vertical": ((40, 30), [a, b], [(0, 0), (20, 0)], [(20, 30)] * 2),
        "horizontal": ((20, 60), [a, b], [(0, 0), (0, 30)], [(20, 30)] * 2),
        "resized": ((50, 70), [a, b], [(0, 0), (13, 29)], [(13, 29), (37, 41)]),
        "clipped": ((25, 35), [a, b], [(0, 0), (10, 20)], [(20, 30), (20, 30)]),
        "gray": ((20, 30), [a[..., 0]], [(0, 0)], [(16, 24)]),
    }[layout]
    got = overlay.create_split_view(target, images, positions, sizes)
    np.testing.assert_array_equal(
        got, j_overlay.create_split_view(target, images, positions, sizes))


def test_split_view_captions_are_not_ported(rng):
    """Captions were ported after this test was written: its name stays, and
    it now holds the drawn caption against the JAX package's
    (tests/test_torch_viz.py covers the layouts)."""
    a = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(  # empty captions draw nothing, as in JAX
        overlay.create_split_view((8, 8), [a], [(0, 0)], [(8, 8)], captions=[""]), a)
    b = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        overlay.create_split_view((32, 48), [b], [(0, 0)], [(32, 48)], captions=["road"]),
        j_overlay.create_split_view((32, 48), [b], [(0, 0)], [(32, 48)], captions=["road"]))
