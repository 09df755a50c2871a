"""PyTorch port, the CUDA kernels against their plain twins on the card.

Marked ``cuda``: skipped where no CUDA device is present (the CPU test run).
On a machine with a card run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up for the CPU
mesh; this file imports no JAX). The full-size comparison, with times, is
``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from fcn8s_tensorflow_tpu_torch.ops import kernels as K  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import pool as P  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.losses import softmax_cross_entropy_with_ids  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.nn import max_pool_2x2  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.pool import maxpool2x2_nhwc  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 64, 32, 64), (1, 3, 6, 10), (3, 12, 4, 2)])
def test_pool_kernel_equals_twin(dev, dtype, shape):
    """Vectorised (C % 8 == 0) and scalar channel runs, bit-exact."""
    x = torch.randn(shape, device=dev).to(dtype).contiguous(memory_format=torch.channels_last)
    n = maxpool2x2_nhwc.launches
    y = maxpool2x2_nhwc(x)
    assert maxpool2x2_nhwc.launches == n + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, max_pool_2x2(x))


# The CE kernels' cases: C of 3, 20 and 150 classes (a tile of 1024, 256 and
# 16 or 32 rows); 4099 pixels a sample, so P is no multiple of the tile; and
# inputs whose base lies one row (and one label) past an allocation's start,
# so no tensor is 16-byte aligned (logits[1:] is 8 bytes off at C = 20 bf16).
CE_CLASSES = [3, 20, 150]
CE_PPS = 4099


def _ce_inputs(dev, n, c, logit_dtype, label_dtype, offset, scale=4.0):
    """(logits (P, C), labels (P,)) for P = n * CE_PPS, views ``offset``
    elements (of each) into their allocations."""
    p = n * CE_PPS
    logits = (torch.randn(p + offset, c, device=dev) * scale).to(logit_dtype)[offset:]
    labels = torch.randint(0, c, (p + offset,), device=dev).to(label_dtype)[offset:]
    assert logits.is_contiguous() and labels.is_contiguous()
    return logits, labels


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("c", CE_CLASSES)
@pytest.mark.parametrize("logit_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label_dtype", [torch.uint8, torch.int32])
def test_ce_kernel_matches_twin(dev, logit_dtype, label_dtype, c, offset):
    n, pps = 3, CE_PPS
    logits, labels = _ce_inputs(dev, n, c, logit_dtype, label_dtype, offset)
    labels[::101] = 200  # out of range: picks nothing
    mask = torch.tensor([1.0, 0.0, 1.0], device=dev)
    got = K.ce_sum_per_sample(logits, labels, mask, pps)
    want = K.ce_sum_per_sample_plain(logits, labels, mask, pps)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    assert torch.equal(got, K.ce_sum_per_sample(logits, labels, mask, pps))  # deterministic


BIG = 2**32 + 2**20  # elements: past what 32-bit (even unsigned) offsets reach


@pytest.mark.parametrize("c", [128, 4])  # vectorised and scalar channel runs
def test_pool_kernel_64bit_indexing(dev, c):
    """A (1, c, 2, w) bf16 input of more than 2**32 elements takes the
    kernel's 64-bit index path; every output equals the max of its four
    strided neighbours."""
    w = BIG // (2 * c) // 2 * 2
    x = torch.empty((1, c, 2, w), dtype=torch.bfloat16, device=dev,
                    memory_format=torch.channels_last).normal_()
    assert x.numel() > 2**32
    y = maxpool2x2_nhwc(x)
    want = torch.maximum(torch.maximum(x[:, :, 0, 0::2], x[:, :, 0, 1::2]),
                         torch.maximum(x[:, :, 1, 0::2], x[:, :, 1, 1::2]))
    assert torch.equal(y[:, :, 0], want)


def test_ce_kernel_64bit_indexing(dev):
    """(P, 20) bf16 logits of more than 2**32 elements take the kernel's
    64-bit index path; the sum matches the plain twin summed in chunks (in
    fp64 across chunks). The first sample is masked out, so the sum is that
    of the second, whose rows lie past element 2**31."""
    c = 20
    p = BIG // c // 2 * 2
    pps = p // 2
    logits = torch.empty((p, c), dtype=torch.bfloat16, device=dev).normal_(0.0, 3.0)
    labels = torch.randint(0, c, (p,), device=dev, dtype=torch.uint8)
    mask = torch.tensor([0.0, 1.0], device=dev)
    assert logits.numel() > 2**32
    got = K.ce_sum_per_sample(logits, labels, mask, pps)
    want, chunk = 0.0, 2**25
    for a in range(pps, p, chunk):
        b = min(a + chunk, p)
        want += float(softmax_cross_entropy_with_ids(logits[a:b], labels[a:b]).double().sum())
    torch.testing.assert_close(got.double(), torch.tensor(want, dtype=torch.float64, device=dev),
                               rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("c", [20, 150])  # shared-memory bins, then global atomics
def test_confmat_kernel_equals_twin(dev, c):
    n, pps = 2, 5000
    pred = torch.randint(0, c, (n * pps,), device=dev, dtype=torch.int32)
    gt = torch.randint(0, c + 3, (n * pps,), device=dev).to(torch.uint8)
    mask = torch.tensor([0.0, 1.0], device=dev)
    zeros = torch.zeros((c, c), dtype=torch.int32, device=dev)
    got = K.confusion_matrix_accumulate(zeros.clone(), pred, gt, mask, pps)
    want = K.confusion_matrix_accumulate_plain(zeros.clone(), pred, gt, mask, pps)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K4a / K4b: the pool's training pair
# ---------------------------------------------------------------------------


def _ties(shape, dev, dtype):
    """Values on a coarse grid, so most windows hold ties."""
    x = torch.round(torch.randn(shape, device=dev) * 2).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 64, 32, 64), (1, 3, 6, 10), (3, 12, 4, 2)])
def test_pool_pair_kernels_equal_twins_and_max_pool2d_grad(dev, dtype, shape):
    """Vectorised (C % 8 == 0) and scalar (odd C) channel runs on tie-heavy
    inputs: y and the code bit-exact against the twin, dx bit-exact against
    the twin and against F.max_pool2d's autograd gradient."""
    x = _ties(shape, dev, dtype)
    n = P.maxpool2x2_code_nhwc.launches
    y, code = P.maxpool2x2_code_nhwc(x)
    assert P.maxpool2x2_code_nhwc.launches == n + 1
    y_t, code_t = P.maxpool2x2_code_plain(x)
    assert torch.equal(y, y_t) and torch.equal(code, code_t)
    assert torch.equal(y, max_pool_2x2(x))
    dy = torch.randn(y.shape, device=dev).to(dtype).contiguous(memory_format=torch.channels_last)
    dx = P.maxpool2x2_bwd_nhwc(dy, code)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(dx, P.maxpool2x2_bwd_plain(dy, code))
    xr = x.detach().clone().requires_grad_()
    F.max_pool2d(xr, 2, 2).backward(dy)
    assert torch.equal(dx, xr.grad)


def test_pool_function_runs_the_pair_and_counts_layout_conversions(dev):
    x = _ties((2, 16, 8, 8), dev, torch.bfloat16).requires_grad_()
    a, b, f = (P.maxpool2x2_code_nhwc.launches, P.maxpool2x2_bwd_nhwc.launches,
               P.maxpool2x2_nhwc.launches)
    conversions = P.MaxPool2x2.dy_conversions
    y = P.maxpool2x2(x)
    (y.float() * torch.arange(y.numel(), device=dev).view(y.shape)).sum().backward()  # NCHW dy
    assert P.maxpool2x2_code_nhwc.launches == a + 1 and P.maxpool2x2_bwd_nhwc.launches == b + 1
    assert P.MaxPool2x2.dy_conversions == conversions + 1
    with torch.no_grad():
        P.maxpool2x2(x)
    assert P.maxpool2x2_nhwc.launches == f + 1


def test_pool_pair_64bit_indexing(dev):
    """A (1, 128, 2, w) bf16 input of more than 2**32 elements takes the
    pair's 64-bit index path; dx puts dy at each window's first maximum."""
    c = 128
    w = BIG // (2 * c) // 2 * 2
    x = torch.empty((1, c, 2, w), dtype=torch.bfloat16, device=dev,
                    memory_format=torch.channels_last).normal_()
    y, code = P.maxpool2x2_code_nhwc(x)
    taps = torch.stack([x[:, :, 0, 0::2], x[:, :, 0, 1::2], x[:, :, 1, 0::2], x[:, :, 1, 1::2]])
    assert torch.equal(y[:, :, 0], taps.amax(0))
    del taps
    dx = P.maxpool2x2_bwd_nhwc(torch.ones_like(y), code)
    assert int(dx.sum(dtype=torch.float64)) == y.numel()
    assert torch.equal(dx[:, :, 1, 1::2], (code[:, :, 0] == 3).to(dx.dtype))


# ---------------------------------------------------------------------------
# K3 and the CE grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("c", CE_CLASSES)
@pytest.mark.parametrize("logit_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label_dtype", [torch.uint8, torch.int32])
def test_ce_weighted_kernel_matches_twin(dev, logit_dtype, label_dtype, c, offset):
    logits, labels = _ce_inputs(dev, 3, c, logit_dtype, label_dtype, offset)
    labels[::101] = 255  # out of range: picks nothing
    weights = (torch.rand(logits.shape[0] + offset, device=dev) * 2)[offset:]
    weights[::7] = 0.0
    weights[CE_PPS:2 * CE_PPS] = 0.0  # a whole sample of weight 0
    got = K.ce_sum_weighted(logits, labels, weights)
    want = K.ce_sum_weighted_plain(logits, labels, weights)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    assert torch.equal(got, K.ce_sum_weighted(logits, labels, weights))  # deterministic


def _within_one_bf16_ulp(got, want, wg):
    """|got - want| within one bf16 ulp of the larger magnitude, plus 2**-20
    * |w * g|: at the label class softmax - 1 cancels when softmax is near
    1, and both sides then carry their fp32 softmax error (a few 2**-24 *
    |w * g|, which the cancellation does not shrink) into a tiny result."""
    g, w = got.float(), want.float()
    top = torch.maximum(g.abs(), w.abs()).clamp(min=2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return bool(((g - w).abs() <= ulp + 2.0**-20 * wg.abs()).all())


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("c", CE_CLASSES)
@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("logit_dtype", [torch.bfloat16, torch.float32])
def test_ce_grad_kernel_matches_twin(dev, per_pixel, logit_dtype, c, offset):
    """Within one bf16 ulp (fp32: rtol 1e-5) of the twin, with exact zeros
    wherever the weight is 0; the middle sample weighs 0 throughout, so its
    tiles are zero-filled without being read."""
    n, pps = 3, CE_PPS
    logits, labels = _ce_inputs(dev, n, c, logit_dtype, torch.uint8, offset)
    labels[::97] = 255
    if per_pixel:
        weights, arg = (torch.rand(n * pps + offset, device=dev) * 2)[offset:], None
        weights[::5] = 0.0
        weights[pps:2 * pps] = 0.0
    else:
        weights, arg = torch.tensor([1.0, 0.0, 2.0], device=dev), pps
    g = torch.tensor(0.37, device=dev)
    got = K.ce_grad(logits, labels, weights, g, arg)
    want = K.ce_grad_plain(logits, labels, weights, g, arg)
    assert got.dtype == logit_dtype and got.shape == logits.shape
    wg = (weights if per_pixel else weights.repeat_interleave(pps))[:, None] * g
    if logit_dtype == torch.bfloat16:
        assert _within_one_bf16_ulp(got, want, wg)
    else:
        # fp32: the kernel's online exp-sum and expf round differently from
        # torch.softmax, by a few fp32 ulps of the O(1) softmax terms, which
        # the w * g <= 0.74 factor carries into the result
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    zero = (weights == 0) if per_pixel else (weights == 0).repeat_interleave(pps)
    assert bool((got[zero] == 0).all()) and bool((got[~zero] != 0).any())


def test_ce_grad_64bit_indexing(dev):
    """(P, 20) bf16 logits of more than 2**32 elements: the gradient of the
    last rows (past element 2**31) matches the twin on them."""
    c = 20
    p = BIG // c
    logits = torch.empty((p, c), dtype=torch.bfloat16, device=dev).normal_(0.0, 3.0)
    labels = torch.randint(0, c, (p,), device=dev, dtype=torch.uint8)
    weights = torch.ones(p, device=dev)
    g = torch.tensor(1.0, device=dev)
    got = K.ce_grad(logits, labels, weights, g)
    tail = slice(p - 4096, p)
    assert _within_one_bf16_ulp(got[tail], K.ce_grad_plain(logits[tail], labels[tail],
                                                           weights[tail], g), g.expand(1, 1))


# ---------------------------------------------------------------------------
# KB and the async checkpoint snapshot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,width", [(64, 512), (24, 45), (8, 3)])
def test_conv1_core_kernel_matches_twin(dev, rows, width):
    """KB at W = 512 (the calibration's) and at widths that are no multiple
    of its 32-pixel strip or of 16, within one bf16 step of the twin; the
    last tile's halo wraps to rows 0 and 1."""
    from fcn8s_tensorflow_tpu_torch.ops import conv1_core as KB

    g = torch.Generator(device=dev).manual_seed(rows + width)
    x = torch.randn((rows, width, 64), generator=g, device=dev).to(torch.bfloat16)
    w128 = torch.randn((3, 128, 64), generator=g, device=dev).to(torch.bfloat16)
    w64 = torch.randn((3, 64, 64), generator=g, device=dev).to(torch.bfloat16)
    n = KB.conv1_core.launches
    got = KB.conv1_core(x, w128, w64)
    torch.cuda.synchronize()
    assert KB.conv1_core.launches == n + 1
    err, ok = KB.within_one_bf16_step(got, KB.conv1_core_reference(x, w128, w64))
    assert ok, err
    x2 = x.clone()
    x2[:2] = -x2[:2]
    changed = (KB.conv1_core(x2, w128, w64) != got).flatten(1).any(1).nonzero().flatten().tolist()
    assert changed == sorted({0, 1, rows - 2, rows - 1})
    with pytest.raises(ValueError, match="multiple of 8"):
        KB.conv1_core(x[:5], w128, w64)


def test_async_save_snapshot_on_the_card(dev, tmp_path):
    """``save(block=False)`` on the card, then two more in-place steps: the
    checkpoint holds the params and Adam moments of the call."""
    import numpy as np

    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.engine import checkpoint as ckpt
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s

    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
             rng.integers(0, 3, (2, 64, 64), dtype=np.uint8))
    model = FCN8s(num_classes=3, width_mult=1 / 8, fc_channels=64, device=dev,
                  compute_dtype=torch.float32)
    kw = dict(learning_rate_schedule=lambda s: 1e-3, keep_prob=1.0, record_summaries=False)
    model.train(iter([batch] * 3), 1, 1, **kw)

    def by_path(params, tensors):
        return dict(zip(bridge.jax_leaf_paths(params), (t.detach().cpu().clone() for t in tensors)))

    want = by_path(model.params, bridge.param_leaves(model.params))
    want_mu = by_path(model.params, model.state.opt_state.inner.mu)
    path = model.save(str(tmp_path), block=False)
    model.train(iter([batch] * 3), 1, 2, **kw)
    model._join_pending_save()
    got = ckpt.load_checkpoint(path, model.optimizer)
    assert got["step"] == 1
    got_params = by_path(got["params"], bridge.param_leaves(got["params"]))
    got_mu = by_path(got["params"], got["opt_state"].inner.mu)
    assert got_params.keys() == want.keys() and got_mu.keys() == want_mu.keys()
    assert all(torch.equal(got_params[k], want[k]) and torch.equal(got_mu[k], want_mu[k])
               for k in want)
    now = by_path(model.params, bridge.param_leaves(model.params))
    assert not all(torch.equal(now[k], want[k]) for k in want)
