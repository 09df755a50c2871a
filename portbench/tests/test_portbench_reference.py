"""The plain reference and the comparisons: hand-worked small cases, and
the reference against the port's fp32 forward at a narrow width."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import harness, weights
from portbench.reference import compare, fcn

CONFIGS = ("fcn8s-vgg16-cityscapes", "fcn32s-vgg16-cityscapes")
WIDTH = {"mult": 1 / 16, "fc": 32}


def _config(name):
    return harness._json(harness.PACKAGE / "configs" / f"{name}.json")


def test_deconv_is_tf_same_conv2d_transpose_by_hand():
    """One input pixel at (1, 1) of a 3x3 map, stride 2, a 4x4 kernel K: the
    dilated input holds it at (2, 2), padded by 2 at (4, 4) of a 9x9 map,
    and the correlation's output (i, j) reads K[4 - i, 4 - j]: the kernel
    mirrored over rows and columns 1..4 of a 6x6 output."""
    x = torch.zeros(1, 1, 3, 3)
    x[0, 0, 1, 1] = 1.0
    kernel = torch.arange(16.0).reshape(4, 4, 1, 1)
    out = fcn._deconv(x, kernel, None, 2, "fp32")[0, 0]
    expect = torch.zeros(6, 6)
    expect[1:5, 1:5] = torch.arange(16.0).reshape(4, 4).flip(0, 1)
    assert torch.equal(out, expect)


@pytest.mark.parametrize("stride", [2, 8, 32])
def test_deconv_matches_the_ports_input_dilated_form(stride):
    from fcn8s_tensorflow_tpu_torch.ops.nn import conv2d_transpose

    gen = torch.Generator().manual_seed(stride)
    x = torch.randn(2, 3, 3, 4, generator=gen)
    kernel = torch.randn(2 * stride, 2 * stride, 3, 5, generator=gen)
    ours = fcn._deconv(x, kernel, None, stride, "fp32")
    assert ours.shape == (2, 5, 3 * stride, 4 * stride)
    torch.testing.assert_close(ours, conv2d_transpose(x, kernel, strides=(stride, stride)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_ports_fp32_forward(name):
    """At a narrow width with the port's compute dtype set to fp32, the
    reference's logits are the port's to fp32 rounding."""
    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.models.fcn8s import apply_fcn8s

    cfg = _config(name)
    tree = weights.make_tree(cfg, 11, "cpu", WIDTH)
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 96, 3),
                                                                dtype=np.uint8))
    port = apply_fcn8s(bridge.cast_params(bridge.to_port(tree), torch.float32), images,
                       compute_dtype=torch.float32)
    ours = fcn.forward(tree, images, cfg).permute(0, 2, 3, 1)
    torch.testing.assert_close(ours, port, rtol=1e-4, atol=1e-4 * float(port.abs().max()))


def test_dropout_draw_is_the_configurations():
    """Seeded as the configuration says, drawn fc6 then fc7 in NHWC order."""
    cfg = _config("fcn8s-vgg16-cityscapes")
    seed, step = 2**31 + 5, 7
    key = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> np.uint64(1)
    gen = torch.Generator().manual_seed(int(key))
    u6, u7 = torch.rand((3, 2, 4, 16), generator=gen), torch.rand((3, 2, 4, 16), generator=gen)
    m6, m7 = fcn.dropout_masks(cfg, seed, step, 3, (64, 128), 16, "cpu")
    assert torch.equal(m6, (u6 < 0.5).permute(0, 3, 1, 2))
    assert torch.equal(m7, (u7 < 0.5).permute(0, 3, 1, 2))


def test_one_adam_step_by_hand():
    """TF1 Adam's first step moves every weight by lr * sqrt(1 - b2) / (1 -
    b1) * (1 - b1) g / (sqrt(1 - b2) |g| + eps): about lr * sign(g)."""
    cfg = _config("fcn8s-vgg16-cityscapes")
    cfg = dict(cfg, keep_prob=1.0)
    tree = weights.make_tree(cfg, 3, "cpu", WIDTH)
    rng = np.random.default_rng(1)
    batch = (rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
             rng.integers(0, 20, (2, 64, 64), dtype=np.uint8))
    out = fcn.train(tree, [batch], cfg, 0, 1)
    leaf = [t for layers in tree.values() for layer in layers.values() for t in layer.values()]
    fresh = {part: {name: {k: t.clone().requires_grad_(True) for k, t in layer.items()}
                    for name, layer in layers.items()} for part, layers in tree.items()}
    logits = fcn.forward(fresh, torch.from_numpy(batch[0]), cfg)
    loss = F.cross_entropy(logits, torch.from_numpy(batch[1]).long())
    assert out["losses"][0] == pytest.approx(float(loss), rel=1e-5)
    params = [t for layers in fresh.values() for layer in layers.values() for t in layer.values()]
    grads = torch.autograd.grad(loss, params)
    assert out["grad1"] == pytest.approx([float(g.norm()) for g in grads], rel=1e-4)
    kernels = {id(layer["kernel"]) for layer in fresh["decoder"].values()}
    decoder = [g for g, p in zip(grads, params) if id(p) in kernels]
    assert len(out["grad1_decoder"]) == len(decoder) == 6
    for ours, theirs in zip(out["grad1_decoder"], decoder):
        np.testing.assert_allclose(ours, theirs.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(theirs.abs().max()))
    lr, b1, b2, eps = 1e-4, 0.9, 0.999, 1e-8
    scale = lr * math.sqrt(1 - b2) / (1 - b1)
    step = [scale * (1 - b1) * g / (math.sqrt(1 - b2) * g.abs() + eps) for g in grads]
    assert out["delta"] == pytest.approx([float(s.norm()) for s in step], rel=1e-4)
    assert len(leaf) == len(out["delta"])


def test_logit_gap_by_hand():
    logits = torch.tensor([[[1.0, 0.0]], [[0.5, 2.0]], [[0.0, 1.5]]])  # (C=3, H=1, W=2)
    assert compare.logit_gaps(logits, [[0, 1]])[0] == 0.0
    assert compare.logit_gaps(logits, [[1, 2]])[:2] == pytest.approx((0.5, 1.0))
    assert compare.logit_gaps(logits, [[2, 0]]) == pytest.approx((2.0, 3.0, 2))
    assert compare.logit_gaps(logits, [[3, 0]])[0] == math.inf
    assert compare.answer_gaps([(logits, [[1, 2]]), (logits, [[0, 1]])]) == pytest.approx(
        {"mean_gap": 1.0 / 4})


def test_norm_and_loss_gaps_by_hand():
    ref = [1.0, 2.0, 0.001, 4.0]
    # gaps over max(leaf, median 1.5): 0.1/1.5, 0.2/2, 0.001/1.5, 0
    assert compare.norm_gap([1.1, 2.2, 0.002, 4.0], ref) == pytest.approx(0.2 / 2.0)
    assert compare.norm_gap([1.0, 2.0, 1.0, 4.0], ref, keep=[1, 1, 0, 1]) == 0.0
    assert compare.norm_gap([0.0, 0.0, 0.0, 0.0], ref) == pytest.approx(1.0)
    assert compare.norm_gap([1.0, 2.0], ref) == math.inf
    assert compare.moving_leaves([1.0, 1e-5, 2.0]) == [True, False, True]
    assert compare.loss_gap([2.0, 3.3], [2.0, 3.0]) == pytest.approx(0.1)


def test_vector_gap_by_hand():
    """Two gradients of equal norms made by other rows lie far apart."""
    ref = [np.array([3.0, 4.0]), np.array([[1.0, 0.0]])]
    assert compare.vector_gap([np.array([3.0, 4.5]), np.array([[1.0, 0.0]])], ref) == (
        pytest.approx(0.1))
    assert compare.vector_gap([np.array([4.0, 3.0]), ref[1]], ref) == pytest.approx(
        math.sqrt(2.0) / 5.0)
    assert compare.vector_gap([ref[0], np.array([[0.0, 1.0]])], ref) == pytest.approx(
        math.sqrt(2.0))
    assert compare.vector_gap([ref[0]], ref) == math.inf
    assert compare.vector_gap([ref[0], np.array([1.0, 0.0])], ref) == math.inf
    assert compare.vector_gap([ref[0], np.array([[np.nan, 0.0]])], ref) == math.inf


def test_every_seed_offers_the_same_gaps_in_another_order():
    from portbench.traffic import schedule

    a, b = schedule.arrivals(2**31 + 1, 45, 20), schedule.arrivals(2**31 + 2, 45, 20)
    assert len(a) == len(b) == 900
    assert np.all(np.diff(a) >= 0) and 0 <= a[0] and a[-1] < 20
    assert np.allclose(np.sort(np.diff(a, prepend=0.0)), np.sort(np.diff(b, prepend=0.0)))
    assert not np.array_equal(a, b)
    assert schedule.percentile([3, 1, 2, 4], 0.5) == 2 and schedule.percentile([5], 0.95) == 5
