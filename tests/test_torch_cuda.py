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


# The CE kernels' cases: C of 2 (KITTI), 3, 5 (the fault-injection tool), 6
# (the endurance and convergence tools: a bf16 row of 5 or 6 logits is not
# 16-byte aligned, so rows go down row_tiles.cuh's ragged path), 20 and 150
# classes (a tile of 1024, 256 and 16 or 32 rows); 4099 pixels a sample, so
# P is no multiple of the tile; and inputs whose base lies one row (and one
# label) past an allocation's start, so no tensor is 16-byte aligned
# (logits[1:] is 8 bytes off at C = 20 bf16).
CE_CLASSES = [2, 3, 5, 6, 20, 150]
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


def _k5_ids(dev, case, c, pred_dtype, gt_dtype):
    """(pred, gt, pps) for K5's cases, three samples: ``random`` ids (some out
    of range); ``one_bin``, every pixel (gt, pred) = (3, 3); ``blocks``, eval-
    like ids (gt in 32x32 blocks of random classes over 64x96 frames, pred =
    gt but on ~10% of pixels); ``unaligned``, the blocks as views one label
    and three predictions into their allocations (``gt[1:]``, ``pred[3:]``);
    ``pps_odd``, random ids with 5003 pixels a sample, so 16-pixel vectors
    straddle samples."""
    g = torch.Generator(device=dev).manual_seed(5)
    n, h, w = 3, 64, 96
    if case in ("random", "pps_odd"):
        pps = 5003 if case == "pps_odd" else h * w
        gt = torch.randint(0, c + 3, (n * pps,), generator=g, device=dev)
        pred = torch.randint(-1, c + 1, (n * pps,), generator=g, device=dev)
    elif case == "one_bin":
        pps = h * w
        gt = torch.full((n * pps,), 3, device=dev)
        pred = gt.clone()
    else:
        pps = h * w
        blocks = torch.randint(0, c, (n, h // 32, w // 32), generator=g, device=dev)
        gt = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2).reshape(-1)
        flip = torch.rand(gt.shape, generator=g, device=dev) < 0.1
        pred = torch.where(flip, torch.randint(0, c, gt.shape, generator=g, device=dev), gt)
    gt, pred = gt.to(gt_dtype), pred.to(pred_dtype)  # a -1 prediction is 255 as uint8: out of range
    if case == "unaligned":
        gt = torch.cat([gt[:1], gt])[1:]
        pred = torch.cat([pred[:3], pred])[3:]
    assert gt.is_contiguous() and pred.is_contiguous()
    return pred, gt, pps


@pytest.mark.parametrize("case", ["random", "one_bin", "blocks", "unaligned", "pps_odd"])
@pytest.mark.parametrize("pred_dtype,gt_dtype", [(torch.int32, torch.uint8),
                                                 (torch.int32, torch.int32),
                                                 (torch.uint8, torch.uint8),
                                                 (torch.uint8, torch.int32)])
def test_confmat_kernel_equals_twin_on_coherent_and_unaligned_ids(dev, pred_dtype, gt_dtype,
                                                                   case):
    """Exact counts, added to a non-zero matrix in place, with one sample
    masked out, on every id layout the kernel's vector path meets."""
    c = 20
    pred, gt, pps = _k5_ids(dev, case, c, pred_dtype, gt_dtype)
    mask = torch.tensor([1.0, 0.0, 1.0], device=dev)
    start = torch.randint(0, 100, (c, c), device=dev, dtype=torch.int32)
    n = K.confusion_matrix_accumulate.launches
    got = K.confusion_matrix_accumulate(start.clone(), pred, gt, mask, pps)
    assert K.confusion_matrix_accumulate.launches == n + 1
    want = K.confusion_matrix_accumulate_plain(start.clone(), pred, gt, mask, pps)
    assert torch.equal(got, want)
    if case == "one_bin":
        assert int(got[3, 3] - start[3, 3]) == 2 * pps


@pytest.mark.parametrize("case", ["blocks", "unaligned"])
def test_confmat_kernel_global_bins_on_coherent_ids(dev, case):
    """C = 150: the bins do not fit in shared memory and runs go to the
    global matrix directly."""
    pred, gt, pps = _k5_ids(dev, case, 150, torch.int32, torch.uint8)
    mask = torch.tensor([1.0, 1.0, 0.0], device=dev)
    zeros = torch.zeros((150, 150), dtype=torch.int32, device=dev)
    got = K.confusion_matrix_accumulate(zeros.clone(), pred, gt, mask, pps)
    assert torch.equal(got, K.confusion_matrix_accumulate_plain(zeros.clone(), pred, gt, mask, pps))


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
    assert torch.equal(got, K.ce_grad(logits, labels, weights, g, arg))  # deterministic
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


@pytest.mark.parametrize("rows", [8, 16, 64])
@pytest.mark.parametrize("width", [512, 64, 45, 3, 1000])
def test_conv1_core_kernel_matches_twin(dev, rows, width):
    """KB at W = 512 (the calibration's), at widths that leave a strip half
    or wholly empty (64, 45, 3) and at one that is no multiple of the
    128-pixel strip (1000), within one bf16 step of the twin; R = 8 is one
    tile whose halo wraps onto itself. Flipping rows 0 and 1 changes exactly
    the output rows whose taps reach them."""
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


def test_conv1_core_kernel_passes_nan(dev):
    """A NaN input pixel makes its three output rows NaN at that pixel, as
    in the twin (the ReLU keeps a NaN); every other element stays within
    one bf16 step."""
    from fcn8s_tensorflow_tpu_torch.ops import conv1_core as KB

    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((16, 200, 64), generator=g, device=dev).to(torch.bfloat16)
    w128 = torch.randn((3, 128, 64), generator=g, device=dev).to(torch.bfloat16)
    w64 = torch.randn((3, 64, 64), generator=g, device=dev).to(torch.bfloat16)
    x[3, 130, 5] = float("nan")
    got, want = KB.conv1_core(x, w128, w64), KB.conv1_core_reference(x, w128, w64)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert nan.any(2).nonzero().tolist() == [[1, 130], [2, 130], [3, 130]]
    err, ok = KB.within_one_bf16_step(torch.nan_to_num(got), torch.nan_to_num(want))
    assert ok, err


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


# ---------------------------------------------------------------------------
# the training features' plain PyTorch on the card: EMA, augmentation,
# summary statistics
# ---------------------------------------------------------------------------


def test_ema_foreach_update_on_the_card_equals_the_cpu(dev):
    """Three ``_update_ema`` calls (a seed copy, two ``_foreach_`` updates)
    on the card and on the CPU from the same trees: within 1e-6 of the
    update's terms (the card may fuse the add into an FMA)."""
    import types

    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s

    g = torch.Generator().manual_seed(0)
    trees = [{"encoder": {"a": {"weight": torch.randn(64, 32, 3, 3, generator=g),
                                "bias": torch.randn(64, generator=g)}},
              "decoder": {"b_deconv": {"kernel": torch.randn(4, 4, 8, 8, generator=g),
                                       "bias": torch.randn(8, generator=g)}}} for _ in range(3)]
    runs = {}
    for device in ("cpu", dev):
        ns = types.SimpleNamespace(_ema=None, _ema_run=None, params=None)
        for tree in trees:
            ns.params = {p: {n: {k: t.to(device) for k, t in layer.items()}
                             for n, layer in part.items()} for p, part in tree.items()}
            FCN8s._update_ema(ns, 0.999)
        runs[str(device)] = ns._ema
    cpu, card = runs["cpu"], runs[str(dev)]
    for part in cpu:
        for name in cpu[part]:
            for k, want in cpu[part][name].items():
                got = card[part][name][k].cpu()
                bound = 1e-6 * (want.abs() + trees[2][part][name][k].abs()) + 1e-30
                assert bool(((got - want).abs() <= bound).all()), (part, name, k)


def test_augment_applies_on_the_card_equal_the_cpu(dev):
    """Every apply function on the card against its CPU run on the same
    draws (made on the card): labels and the exact transforms bit-equal,
    rounded fp32 blends within 1 LSB."""
    from fcn8s_tensorflow_tpu_torch.ops import augment_device as A

    n, h, w = 4, 96, 160
    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.randint(0, 256, (n, h, w, 3), generator=g, device=dev, dtype=torch.uint8)
    labels = torch.randint(0, 20, (n, h, w), generator=g, device=dev, dtype=torch.uint8)
    factor = A.draw_photometric(g, n, 0.6, 1.6, 1.0, 1.0)
    dx, dy = A.draw_translate(g, n, (4, 40), 12, 1.0)
    zoom = A.draw_scale(g, n, 0.7, 1.4, 1.0)
    y0, x0 = A.draw_crop(g, n, h, w, 64, 128)
    fire, values = A.draw_label_noise(g, (n, h, w), 0.2, 4, 20)
    cases = {
        "flip": (lambda im, lb, d: A.apply_flip(im, lb, d[0]), [A.draw_flip(g, n, 0.5)], 0),
        "brightness": (lambda im, lb, d: (A.apply_brightness(im, d[0]), lb), [factor], 1),
        "contrast": (lambda im, lb, d: (A.apply_contrast(im, d[0]), lb), [factor], 1),
        "saturation": (lambda im, lb, d: (A.apply_saturation(im, d[0]), lb), [factor], 1),
        "gamma": (lambda im, lb, d: (A.apply_gamma(im, d[0]), lb), [factor], 1),
        "hue": (lambda im, lb, d: (A.apply_hue(im, d[0] - 1.0), lb), [factor], 1),
        "crop": (lambda im, lb, d: A.apply_crop(im, lb, d[0], d[1], 64, 128), [y0, x0], 0),
        "translate": (lambda im, lb, d: A.apply_translate(im, lb, d[0], d[1], 3), [dx, dy], 0),
        "scale": (lambda im, lb, d: A.apply_scale(im, lb, d[0], 3), [zoom], 1),
        "translate_scale": (lambda im, lb, d: A.apply_translate_scale(im, lb, *d, 3),
                            [dx, dy, zoom], 1),
        "resize": (lambda im, lb, d: A.resize(im, lb, (57, 203)), [], 1),
        "grayscale": (lambda im, lb, d: (A.grayscale(im), lb), [], 0),
        "label_noise": (lambda im, lb, d: (im, A.apply_label_noise(lb, d[0], d[1], 4)),
                        [fire, values], 0),
    }
    for name, (fn, draws, lsb) in cases.items():
        ci, cl = fn(images, labels, draws)
        hi, hl = fn(images.cpu(), labels.cpu(), [d.cpu() for d in draws])
        assert ci.device == dev and ci.dtype == torch.uint8, name
        assert torch.equal(cl.cpu(), hl), name
        assert int((ci.cpu().int() - hi.int()).abs().max()) <= lsb, name


def test_summary_stats_pull_one_sample_per_leaf(dev, monkeypatch):
    """fc6's kernel (4096 x 512 x 7 x 7, 411 MB) in its JAX layout: one
    device-to-host copy of 4 statistics + 65,536 samples, not the leaf."""
    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.engine import summaries

    w = torch.randn((4096, 512, 7, 7), device=dev)
    view = bridge.leaf_to_jax(w, "encoder/fc6/kernel")
    pulled = []
    real_cpu = torch.Tensor.cpu

    def spy(t, *a, **k):
        pulled.append(t.numel())
        return real_cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    stats, sample = summaries.summary_stats(view)
    monkeypatch.undo()
    assert pulled == [4 + 65536] and sample.shape == (65536,)
    flat_idx = torch.arange(0, w.numel(), w.numel() // 65536, device=dev)
    want = view.reshape(-1)[flat_idx].cpu().numpy()  # the reshape copies: the reference only
    assert (sample == want).all()
    assert abs(float(stats[2]) - float(w.min())) == 0 and abs(float(stats[3]) - float(w.max())) == 0


# ---------------------------------------------------------------------------
# the rest of predict: the int8 conv route, the TTA resize, TTA and tiled
# predict on the card against the CPU
# ---------------------------------------------------------------------------

# (NHWC input, OHWI kernel shape): conv1_1 (K = 27, padded to 32), a 3x3
# middle layer, fc6 (7x7, K = 25,088) and fc7 (1x1) at full width, M = 17
# (just above _int_mm's 16) and M = 4 (rows padded)
INT8_CONVS = [((2, 32, 64, 3), (64, 3, 3, 3)), ((2, 16, 32, 128), (128, 3, 3, 128)),
              ((2, 4, 8, 512), (4096, 7, 7, 512)), ((2, 4, 8, 4096), (4096, 1, 1, 4096)),
              ((1, 1, 17, 64), (64, 3, 3, 64)), ((1, 2, 2, 512), (4096, 7, 7, 512))]


@pytest.mark.parametrize("x_shape,k_shape", INT8_CONVS)
def test_int8_conv_route_equals_fp64_twin(dev, x_shape, k_shape):
    """``_int_mm`` over the im2col on the card: int32 accumulators equal the
    fp64 twin's, extreme products included."""
    from fcn8s_tensorflow_tpu_torch.ops import quantize as Q

    g = torch.Generator(device=dev).manual_seed(0)
    xq = torch.randint(-127, 128, x_shape, generator=g, device=dev, dtype=torch.int8)
    kq = torch.randint(-127, 128, k_shape, generator=g, device=dev, dtype=torch.int8)
    xq[0, 0, 0, :] = 127
    kq[0, 0, 0, :] = 127
    layer = Q.quantized_layer(kq, torch.ones(k_shape[0], device=dev),
                              torch.zeros(k_shape[0], device=dev))
    n = Q.conv2d_int8_im2col.launches
    got = Q.int8_conv_acc(xq, layer)
    assert Q.conv2d_int8_im2col.launches == n + 1
    want = Q.conv2d_int8_reference(xq, kq)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("static", [False, True])
def test_conv2d_int8_on_the_card_equals_the_cpu(dev, dtype, static):
    """The whole quantized conv (quantize, route, dequant) on the card
    against the CPU (the twin): within one ulp of ``dtype``."""
    from fcn8s_tensorflow_tpu_torch.ops import quantize as Q

    g = torch.Generator().manual_seed(1)
    x = (torch.randn((2, 64, 16, 32), generator=g) * 3).to(dtype).contiguous(
        memory_format=torch.channels_last)
    q, scale = Q.quantize_kernel_per_channel(torch.randn((96, 64, 3, 3), generator=g))
    act = torch.tensor(float(x.float().abs().max()) * 1.25 / 127) if static else None
    layer = Q.quantized_layer(q.permute(0, 2, 3, 1), scale, torch.randn(96, generator=g), act)
    want = Q.conv2d_int8(x, layer, compute_dtype=dtype).float()
    got = Q.conv2d_int8(x.to(dev), {k: t.to(dev) for k, t in layer.items()},
                        compute_dtype=dtype).float().cpu()
    big = torch.maximum(got.abs(), want.abs())
    ulp = (torch.nextafter(big, torch.full_like(big, float("inf"))) - big if dtype == torch.float32
           else torch.exp2(torch.floor(torch.log2(big.clamp(min=2.0 ** -126))) - 7))
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("size", [(48, 72), (50, 70), (80, 120), (96, 160)])
def test_resize_on_the_card_equals_the_cpu(dev, size):
    """The card's antialiased bilinear kernel is another code path than the
    CPU's: within 1e-5 on values in [0, 1), down and up."""
    from fcn8s_tensorflow_tpu_torch.ops.nn import resize_bilinear

    x = torch.rand((2, 64, 96, 20), generator=torch.Generator().manual_seed(2))
    want = resize_bilinear(x, size)
    got = resize_bilinear(x.to(dev), size).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.fixture
def no_tf32():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.parametrize("quantized", [False, True])
def test_tta_and_tiled_predict_on_the_card_equal_the_cpu(dev, no_tf32, monkeypatch, quantized):
    """A narrow fp32 model (TF32 off) on the card and on the CPU from the
    same weights: ``predict_tta`` (three scales, flip) and tiled predict
    (hard paste and blend) give the same ids on >= 99.9% of pixels, and
    the same wherever the CPU's top-2 probability margin exceeds 1e-3. The
    decoder is redrawn at unit fan-in scale, as tests/test_torch_model.py's
    ``_tree`` does: the fresh init's near-tied logits would leave most
    pixels to rounding.

    int8 TTA is the exception: the card's antialiased resize rounds its
    views ~1e-6 away from the CPU's, which flips the int8 rounding of a few
    view values, and the flips cascade through the 15 quantized layers
    (measured on NVIDIA H100 80GB HBM3, 700.00 W: 99.65% of the ids agree,
    probabilities within 0.0076, no disagreeing pixel with a margin above
    0.0033; the tiled calls within 2.4e-7). It is held at a 0.05 margin and
    99% agreement. Every int8 call on the card also equals, bit for bit,
    the same call with the int8 convolutions on their fp64 twin on the
    card."""
    import numpy as np

    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
    from fcn8s_tensorflow_tpu_torch.ops import quantize as Q

    kw = dict(width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32)
    rng = np.random.default_rng(3)
    tree = bridge.to_numpy(FCN8s(num_classes=5, seed=3, device="cpu", **kw).params)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = rng.normal(size=layer["bias"].shape).astype(np.float32) * 0.1
    cpu = FCN8s.from_params(tree, device="cpu", **kw)
    card = FCN8s.from_params(tree, device=dev, **kw)
    images = rng.integers(0, 256, (2, 100, 150, 3), dtype=np.uint8)
    calls = {"tta": lambda m, **a: m.predict_tta(images, scales=(0.75, 1.0, 1.25),
                                                  quantized=quantized, **a),
             "tiled": lambda m, **a: m.predict(images, tile=(64, 64), tile_overlap=32,
                                               quantized=quantized, **a),
             "blend": lambda m, **a: m.predict(images, tile=(64, 64), tile_overlap=32,
                                               tile_blend=True, quantized=quantized, **a)}
    for name, call in calls.items():
        margin, agree = (0.05, 0.99) if quantized and name == "tta" else (1e-3, 0.999)
        probs = call(cpu, argmax=False)
        top2 = np.sort(probs, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > margin
        got, want = call(card), call(cpu)
        assert got.shape == want.shape == (2, 100, 150), name
        np.testing.assert_array_equal(got[clear], want[clear], err_msg=name)
        assert (got == want).mean() >= agree, name
    if quantized:
        routed = {name: call(card, argmax=False) for name, call in calls.items()}
        monkeypatch.setattr(Q, "int8_conv_acc", lambda xq, qlayer, halo=False:
                            Q.conv2d_int8_reference(xq, qlayer["kernel_q"], halo))
        # the facade's eager steps: a replay would run the route its graph recorded
        monkeypatch.setattr(card, "_eager_steps", True, raising=False)
        for name, call in calls.items():
            np.testing.assert_array_equal(routed[name], call(card, argmax=False), err_msg=name)


def _narrow_pair(dev, num_classes=20, seed=8):
    """A narrow fp32 model on the card and on the CPU from the same weights,
    the decoder redrawn at unit fan-in scale (margins for the ids)."""
    import numpy as np

    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s

    kw = dict(width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32)
    rng = np.random.default_rng(seed)
    tree = bridge.to_numpy(FCN8s(num_classes=num_classes, seed=seed, device="cpu", **kw).params)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = rng.normal(size=layer["bias"].shape).astype(np.float32) * 0.1
    return FCN8s.from_params(tree, device="cpu", **kw), FCN8s.from_params(tree, device=dev, **kw)


def _margins(model, paths, threshold=1e-3):
    """Per file: the CPU softmax's top-2 margin > ``threshold``."""
    import numpy as np
    from PIL import Image

    out = {}
    for p in paths:
        probs = model.predict(np.asarray(Image.open(p).convert("RGB"))[None], argmax=False)[0]
        top2 = np.sort(probs, axis=-1)[..., -2:]
        out[p.name] = (top2[..., 1] - top2[..., 0]) > threshold
    return out


def test_predict_and_save_on_the_card_equals_the_cpu(dev, no_tf32, tmp_path):
    """The same files from the card and the CPU (TF32 off): ids and the host
    overlay equal where the CPU's top-2 margin exceeds 1e-3 and on >= 99.9%
    of pixels, the on-card overlay within 1 LSB there; a tiled directory too."""
    import numpy as np
    from PIL import Image

    from fcn8s_tensorflow_tpu_torch.labels import TRAINIDS_TO_IDS_ARRAY, TRAINIDS_TO_RGBA_DICT

    cpu, card = _narrow_pair(dev)
    rng = np.random.default_rng(4)
    src = tmp_path / "images"
    src.mkdir()
    for i, (h, w) in enumerate([(64, 128), (64, 128), (96, 64)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(src / f"i{i}.png")
    clear = _margins(cpu, sorted(src.glob("*.png")))
    clear_tiled = {}
    for p in sorted(src.glob("*.png")):
        probs = cpu.predict(np.asarray(Image.open(p))[None], argmax=False, tile=(64, 64),
                            tile_overlap=32)[0]
        top2 = np.sort(probs, axis=-1)[..., -2:]
        clear_tiled[p.name] = (top2[..., 1] - top2[..., 0]) > 1e-3
    cases = {"ids": dict(output_format="ids", id_map=TRAINIDS_TO_IDS_ARRAY),
             "device_overlay": dict(color_map=TRAINIDS_TO_RGBA_DICT),
             "host_overlay": dict(color_map=TRAINIDS_TO_RGBA_DICT, on_device_overlay=False),
             "tiled": dict(output_format="ids", tile=(64, 64), tile_overlap=32)}
    for name, kw in cases.items():
        files = []
        for m, tag in ((cpu, "cpu"), (card, "card")):
            out = tmp_path / f"{name}_{tag}"
            m.predict_and_save(str(out), str(src), batch_size=2, verbose=False, **kw)
            files.append({p.name: np.asarray(Image.open(p)) for p in sorted(out.glob("*.png"))})
        want, got = files
        assert sorted(got) == sorted(want) == ["i0.png", "i1.png", "i2.png"], name
        agree = []
        for f in want:
            c = (clear_tiled if name == "tiled" else clear)[f]
            if name == "device_overlay":
                assert np.abs(got[f][c].astype(int) - want[f][c]).max() <= 1, (name, f)
            else:
                np.testing.assert_array_equal(got[f][c], want[f][c], err_msg=f"{name} {f}")
            agree.append((got[f] == want[f]).reshape(c.shape[0], c.shape[1], -1).all(-1).ravel())
        assert np.concatenate(agree).mean() >= 0.999, name


def test_score_benchmark_on_the_card_equals_the_cpu(dev, no_tf32, tmp_path):
    """One split scored from the card and from the CPU: the labelId matrices
    differ by at most 2 counts per pixel whose CPU margin is below 1e-3."""
    import numpy as np
    from PIL import Image

    cpu, card = _narrow_pair(dev)
    rng = np.random.default_rng(5)
    ds = tmp_path / "ds"
    img_dir, gt_dir = ds / "leftImg8bit" / "val" / "c", ds / "gtFine" / "val" / "c"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    for n in range(3):
        gt = rng.choice([0, 7, 11, 24, 26], size=(64, 128)).astype(np.uint8)
        Image.fromarray(rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)).save(
            img_dir / f"c_{n:06d}_000019_leftImg8bit.png")
        Image.fromarray(gt).save(gt_dir / f"c_{n:06d}_000019_gtFine_labelIds.png")
        inst = gt.astype(np.uint16)
        inst[10:30, 20:60] = 26001
        Image.fromarray(inst).save(gt_dir / f"c_{n:06d}_000019_gtFine_instanceIds.png")
    want = cpu.score_benchmark(str(ds), str(tmp_path / "cpu"))
    got = card.score_benchmark(str(ds), str(tmp_path / "card"))
    unclear = sum(int((~c).sum()) for c in _margins(cpu, sorted(img_dir.glob("*.png"))).values())
    diff = np.abs(np.asarray(got["confMatrix"], np.int64) - np.asarray(want["confMatrix"]))
    assert np.asarray(got["confMatrix"]).sum() == 3 * 64 * 128
    assert diff.sum() <= 2 * unclear


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_find_learning_rate_on_the_card_restores_bit_for_bit(dev, optimizer):
    """On the card, fresh and after two train steps: params, the optimizer's
    tensors and counters and the step bit-equal after the sweep,
    ``opt_state`` None again on the fresh model, device memory back within
    1 MB, predict unchanged; the sweep launched the train kernels."""
    import numpy as np

    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s, _opt_scalars, _opt_tensors

    model = FCN8s(num_classes=20, width_mult=1 / 16, fc_channels=64, device=dev, seed=1,
                  optimizer=optimizer)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    labels = rng.integers(0, 20, (2, 128, 128), dtype=np.uint8)

    def gen():
        while True:
            yield images, labels

    for trained in (False, True):
        if trained:
            model.train(gen(), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-3,
                        keep_prob=0.5, record_summaries=False)
        opt = model.state.opt_state
        assert (opt is None) != trained
        params = [t.detach().clone() for t in bridge.param_leaves(model.params)]
        moments = None if opt is None else ([t.clone() for t in _opt_tensors(opt)],
                                            _opt_scalars(opt))
        step, ids = model.state.step, model.predict(images)
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated(dev)
        k4a, grad = P.maxpool2x2_code_nhwc.launches, K.ce_grad.launches
        result = model.find_learning_rate(gen(), steps=12, min_lr=1e-6, max_lr=10.0)
        assert P.maxpool2x2_code_nhwc.launches > k4a and K.ce_grad.launches > grad
        assert len(result["losses"]) >= 2
        torch.cuda.synchronize()
        assert abs(torch.cuda.memory_allocated(dev) - mem) <= 2**20
        assert model.state.step == step
        assert all(torch.equal(a, b) for a, b in zip(bridge.param_leaves(model.params), params))
        if moments is None:
            assert model.state.opt_state is None
        else:
            assert _opt_scalars(model.state.opt_state) == moments[1]
            assert all(torch.equal(a, b)
                       for a, b in zip(_opt_tensors(model.state.opt_state), moments[0]))
        np.testing.assert_array_equal(model.predict(images), ids)


# ---------------------------------------------------------------------------
# K4f as a registered op, and the torch.export artifact on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_registered_pool_op_equals_twin_and_counts(dev, dtype):
    """``torch.ops.fcn8s_torch.maxpool2x2_nhwc`` (what an exported graph
    calls) launches K4f: bit-exact with the twin, one launch counted."""
    x = torch.randn((2, 64, 32, 48), device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last)
    n = maxpool2x2_nhwc.launches
    y = torch.ops.fcn8s_torch.maxpool2x2_nhwc(x)
    assert maxpool2x2_nhwc.launches == n + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, max_pool_2x2(x))


def test_registered_pool_op_never_launches_for_a_cpu_tensor(dev, monkeypatch):
    """A CPU tensor takes the twin inside the op; the ctypes library is
    never reached. A CUDA tensor in NCHW memory raises, through the wrapper
    and through the op alike."""
    from fcn8s_tensorflow_tpu_torch.kernels import build

    def no_library():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(build, "library", no_library)
    x = torch.randn((2, 8, 6, 10)).contiguous(memory_format=torch.channels_last)
    n = maxpool2x2_nhwc.launches
    assert torch.equal(torch.ops.fcn8s_torch.maxpool2x2_nhwc(x), max_pool_2x2(x))
    assert torch.equal(maxpool2x2_nhwc(x), max_pool_2x2(x))
    assert maxpool2x2_nhwc.launches == n
    monkeypatch.undo()
    nchw = torch.randn((2, 8, 6, 10), device=dev)
    for fn in (maxpool2x2_nhwc, torch.ops.fcn8s_torch.maxpool2x2_nhwc):
        with pytest.raises(ValueError, match="channels_last"):
            fn(nchw)


def test_card_exported_artifact_equals_predict(dev, tmp_path):
    """Exported on the card and loaded there: ids and softmax equal the
    facade's predict, 5 K4f launches per artifact forward."""
    import numpy as np

    from fcn8s_tensorflow_tpu_torch.engine.export import load_serving_artifact
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s

    model = FCN8s(num_classes=5, width_mult=1 / 8, fc_channels=64, device=dev, seed=2)
    images = np.random.default_rng(0).integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
    for argmax in (True, False):
        out = model.export_serving(str(tmp_path / str(argmax)), input_hw=(64, 96),
                                   argmax=argmax)
        art = load_serving_artifact(out, device="cuda")
        n = maxpool2x2_nhwc.launches
        got = art.predict(images)
        assert maxpool2x2_nhwc.launches == n + 5
        np.testing.assert_array_equal(got, model.predict(images, argmax=argmax))
        np.testing.assert_array_equal(art.predict(images[:1]),
                                      model.predict(images[:1], argmax=argmax))
    with pytest.raises(ValueError, match="traced on cuda:0.*asked for cpu"):
        load_serving_artifact(out, device="cpu")
    model.close()


# ---------------------------------------------------------------------------
# the compiled steps (parallel/steps.py compile_*_step, parallel/graphs.py):
# captured in CUDA graphs and held against the eager steps bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def deterministic():
    """``tools.make_deterministic`` for the test, then the switches back."""
    from fcn8s_tensorflow_tpu_torch.tools import make_deterministic

    switches = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark)
    make_deterministic()
    yield
    torch.use_deterministic_algorithms(switches[0])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = switches[1:]


def _compiled_setup(dev, n_batches=3, c=5):
    from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s

    tree = init_fcn8s(torch.Generator().manual_seed(4), c, width_mult=1 / 16, fc_channels=64)
    g = torch.Generator(device=dev).manual_seed(5)
    ims = torch.randint(0, 256, (n_batches, 4, 64, 96, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    lbs = torch.randint(0, c, (n_batches, 4, 64, 96), generator=g, device=dev, dtype=torch.uint8)
    lbs[:, :, :8] = 255  # ignored rows
    return tree, ims, lbs, torch.ones(4, device=dev)


def _train_state(dev, tree, opt):
    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.parallel import steps as S

    return S.create_train_state(bridge.to_port(tree, device=dev), opt)


def _states_equal(a, b) -> bool:
    from fcn8s_tensorflow_tpu_torch import bridge

    ia, ib = a.opt_state.inner, b.opt_state.inner
    return (a.step == b.step and ia.count == ib.count
            and all(torch.equal(x, y) for x, y in zip(
                bridge.param_leaves(a.params) + ia.mu + ia.nu,
                bridge.param_leaves(b.params) + ib.mu + ib.nu)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_compiled_train_step_equals_eager_on_the_card(dev, deterministic, dtype):
    """keep_prob 0.5, device augmentation, grad_accum=2, ignore_label, TF1
    Adam, a changing learning rate: three replays give the eager steps'
    losses, params and moments bit for bit, and each replay counts the
    kernels it recorded."""
    from fcn8s_tensorflow_tpu_torch.ops.augment_device import make_augment_fn
    from fcn8s_tensorflow_tpu_torch.parallel import steps as S

    tree, ims, lbs, mask = _compiled_setup(dev)
    opt = S.make_optimizer()
    aug = make_augment_fn(flip=0.5, brightness=(0.8, 1.2, 0.5), translate=(8, 4, 0.5))
    kw = dict(compute_dtype=dtype, grad_accum=2, ignore_label=255, augment_fn=aug)
    eager, comp = _train_state(dev, tree, opt), _train_state(dev, tree, opt)
    step = S.compile_train_step(None, opt, 5, **kw, device=dev)
    for i in range(3):
        lr = 1e-3 * (i + 1)
        _, want = S.train_step(eager, ims[i], lbs[i], mask, 9, lr, 1e-3, 0.5, optimizer=opt,
                               num_classes=5, **kw)
        before = (P.maxpool2x2_code_nhwc.launches, K.ce_grad.launches, K.ce_sum_weighted.launches)
        _, got = step(comp, ims[i], lbs[i], mask, 9, lr, 1e-3, 0.5)
        after = (P.maxpool2x2_code_nhwc.launches, K.ce_grad.launches, K.ce_sum_weighted.launches)
        if i > 0:  # a replay: the recorded launches, 5 pools and 2 microbatches
            assert [a - b for a, b in zip(after, before)] == [10, 2, 2]
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert _states_equal(comp, eager)


def test_compiled_multi_step_equals_single_steps_on_the_card(dev, deterministic):
    from fcn8s_tensorflow_tpu_torch.parallel import steps as S

    tree, ims, lbs, mask = _compiled_setup(dev)
    opt = S.make_optimizer()
    singles, multi_state = _train_state(dev, tree, opt), _train_state(dev, tree, opt)
    step = S.compile_train_step(None, opt, 5, device=dev)
    want = torch.stack([step(singles, ims[i], lbs[i], mask, 9, 1e-3, 1e-3, 0.5)[1]
                        for i in range(3)])
    multi = S.compile_multi_train_step(None, opt, 5, steps_per_dispatch=3, device=dev)
    _, got = multi(multi_state, ims, lbs, mask.expand(3, -1).contiguous(), 9, 1e-3, 1e-3, 0.5)
    assert torch.equal(got, want) and len(set(got.tolist())) == 3
    assert _states_equal(multi_state, singles)


def test_compiled_train_step_recaptures_a_swapped_state_on_the_card(dev, deterministic):
    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.parallel import steps as S

    tree, ims, lbs, mask = _compiled_setup(dev)
    opt = S.make_optimizer()
    first, second, eager = (_train_state(dev, tree, opt) for _ in range(3))
    step = S.compile_train_step(None, opt, 5, device=dev)
    step(first, ims[0], lbs[0], mask, 9, 1e-3, 0.0, 0.5)
    kept = [t.clone() for t in bridge.param_leaves(first.params)]
    old, = step.captures.values()
    _, got = step(second, ims[1], lbs[1], mask, 9, 1e-3, 0.0, 0.5)
    new = step.captures.values()[-1]
    _, want = S.train_step(eager, ims[1], lbs[1], mask, 9, 1e-3, 0.0, 0.5, optimizer=opt,
                           num_classes=5)
    assert new is not old and torch.equal(got, want) and _states_equal(second, eager)
    assert step.captures_made == 2 and len(step.captures) == 2
    assert all(torch.equal(a, b) for a, b in zip(bridge.param_leaves(first.params), kept))


def test_compiled_forward_steps_equal_eager_on_the_card(dev, deterministic):
    """Eval (K4f, K1, K5 in the graph), predict (ids, overlay, int8) and
    TTA replayed on two batches give the eager results bit for bit."""
    import numpy as np

    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.ops.metrics import empty_metrics_state
    from fcn8s_tensorflow_tpu_torch.ops.quantize import quantize_fcn8s_params
    from fcn8s_tensorflow_tpu_torch.parallel import steps as S

    tree, ims, lbs, mask = _compiled_setup(dev)
    master = bridge.to_port(tree, device=dev)
    run = bridge.cast_params(master, torch.bfloat16)
    qtree = quantize_fcn8s_params(master)
    lut = np.array([[255, 0, 0, 128], [0, 255, 0, 0], [0, 0, 255, 255], [9, 9, 9, 77],
                    [0, 0, 0, 200]], np.float32)
    ev = S.compile_eval_step(None, 5, ignore_label=255, device=dev)
    got, want = empty_metrics_state(5, dev), empty_metrics_state(5, dev)
    n5 = P.maxpool2x2_nhwc.launches, K.confusion_matrix_accumulate.launches
    for i in range(2):
        ev(run, got, ims[i], lbs[i], mask)
    assert [a - b for a, b in zip((P.maxpool2x2_nhwc.launches,
                                   K.confusion_matrix_accumulate.launches), n5)] == [20, 4]
    for i in range(2):
        S.eval_step(run, want, ims[i], lbs[i], mask, num_classes=5, ignore_label=255)
    assert all(torch.equal(got[k], want[k]) for k in want)
    cases = [(S.compile_predict_step(None, id_dtype=torch.uint8, device=dev), run,
              dict(id_dtype=torch.uint8), S.predict_step),
             (S.compile_predict_step(None, overlay_lut=lut, device=dev), run,
              dict(overlay_lut=lut), S.predict_step),
             (S.compile_predict_step(None, quantized=True, device=dev), qtree,
              dict(quantized=True), S.predict_step),
             (S.compile_tta_step(None, scale_hw=(96, 128), device=dev), run,
              dict(scale_hw=(96, 128)), S.tta_step)]
    for step, params, kw, eager in cases:
        for i in range(2):
            assert torch.equal(step(params, ims[i]), eager(params, ims[i], **kw))


def test_compiled_facade_equals_its_eager_steps_on_the_card(dev, deterministic):
    """The facade on its compiled steps against the same facade on its
    eager steps, from one seed: ``train`` (keep_prob 0.5, device augment,
    EMA, ``prefetch=2``: the prefetcher pins memory while the train step
    is captured, an evaluation on 'train' each epoch), then ``predict``
    (ids, int8, ``use_ema``), tiled and ``predict_tta``, bit for bit; one
    train and one eval capture, and none more while the trees
    alternate."""
    import itertools

    import numpy as np

    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s

    rng = np.random.default_rng(16)
    batches = [(rng.integers(0, 256, (3, 128, 96, 3), dtype=np.uint8),
                rng.integers(0, 5, (3, 128, 96), dtype=np.uint8)) for _ in range(8)]
    images = rng.integers(0, 256, (2, 100, 150, 3), dtype=np.uint8)
    kw = dict(epochs=2, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-3 * (1 + s),
              keep_prob=0.5, metrics={"loss", "mean_iou"}, eval_frequency=1,
              record_summaries=False, ema_decay=0.9, prefetch=2,
              device_augment=dict(flip=0.5, brightness=(0.8, 1.2, 0.5), translate=(8, 4, 0.5)))
    models = [FCN8s(num_classes=5, width_mult=1 / 16, fc_channels=64, device=dev, seed=16)
              for _ in range(2)]
    models[1]._eager_steps = True
    for m in models:
        m.train(itertools.cycle(batches), **kw)
    compiled, eager = models
    for a, b in ((compiled.params, eager.params), (compiled.ema_params, eager.ema_params)):
        assert all(torch.equal(x, y) for x, y in zip(bridge.param_leaves(a),
                                                     bridge.param_leaves(b)))
    assert compiled.metric_values == eager.metric_values
    assert compiled.capture_counts() == {"train": 1, "eval": 1, "predict": 0, "tta": 0}
    calls = [dict(), dict(quantized=True), dict(use_ema=True)]
    for call in calls + calls:
        np.testing.assert_array_equal(compiled.predict(images, **call),
                                      eager.predict(images, **call))
    tiled = dict(tile=(64, 64), tile_overlap=32)
    np.testing.assert_array_equal(compiled.predict(images, **tiled), eager.predict(images, **tiled))
    np.testing.assert_array_equal(compiled.predict_tta(images, scales=(0.75, 1.0)),
                                  eager.predict_tta(images, scales=(0.75, 1.0)))
    assert compiled.capture_counts() == {"train": 1, "eval": 1, "predict": 4, "tta": 2}


def test_a_capture_that_syncs_raises_on_the_card(dev):
    """No fallback: a body that reads a value back fails its capture."""
    from fcn8s_tensorflow_tpu_torch.parallel import graphs as G

    t = torch.ones(4, device=dev)
    with pytest.raises(RuntimeError):
        G.capture(lambda: t.sum().item(), dev)


# ---------------------------------------------------------------------------
# fc6's forward as one GEMM over its im2col (ops.nn.conv2d_im2col) at fc6's
# real shapes: b8's 16x32 map (batch 8 of 512x1024) and predict's 32x64
# (batch 8 of 1024x2048)
# ---------------------------------------------------------------------------

FC6_MAPS = [(8, 512, 16, 32), (8, 512, 32, 64)]


def _fc6_inputs(dev, shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn(shape, generator=g, device=dev).bfloat16().contiguous(memory_format=cl)
    w = (torch.randn((4096, 512, 7, 7), generator=g, device=dev) / (512 * 49) ** 0.5)
    b = torch.randn(4096, generator=g, device=dev)
    return x, w.bfloat16().contiguous(memory_format=cl), b.bfloat16()


@pytest.mark.parametrize("shape", FC6_MAPS)
def test_fc6_route_is_within_one_bf16_rounding_of_the_fp32_conv(dev, no_tf32, shape):
    """The bf16 GEMM (fp32 accumulation over K = 25,088, the bias in fp32,
    one rounding) against cuDNN's fp32 convolution of the same bf16 values:
    within half a bf16 ulp of each output, plus 1e-4 of the largest for the
    fp32 sums' order; a channels_last output; one launch counted."""
    from fcn8s_tensorflow_tpu_torch.ops.nn import conv2d_im2col

    x, w, b = _fc6_inputs(dev, shape)
    n = conv2d_im2col.launches
    got = conv2d_im2col(x, w, b)
    assert conv2d_im2col.launches == n + 1
    want = F.conv2d(x.float(), w.float(), b.float(), padding=3)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - 7)
    assert bool(((got.float() - want).abs() <= ulp / 2 + 1e-4 * want.abs().max()).all())


@pytest.mark.parametrize("shape", FC6_MAPS)
def test_fc6_route_backward_is_cudnns_bit_for_bit(dev, deterministic, shape):
    """Under autograd the route's input, weight and bias gradients for a
    given output gradient are ``conv2d``'s (cuDNN's dgrad and wgrad)."""
    from fcn8s_tensorflow_tpu_torch.ops.nn import conv2d, conv2d_im2col

    x, w, b = _fc6_inputs(dev, shape, seed=1)
    g = torch.randn((shape[0], 4096, shape[2], shape[3]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    g = g.bfloat16().contiguous(memory_format=torch.channels_last)
    grads = []
    for fn in (conv2d, conv2d_im2col):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    assert all(torch.equal(a, c) for a, c in zip(*grads))


def test_fcn8s_adam_update_is_the_per_leaf_rule_at_full_size_on_the_card(dev, deterministic):
    """FCN-8s at full size, two b8 steps of 512x1024 with keep_prob 0.5:
    the optimizer's multi-tensor TF1 Adam gives the per-leaf loop's params
    and moments bit for bit (``tests/per_leaf_adam.py``), so FCN's numbers
    are the loop's."""
    from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s
    from fcn8s_tensorflow_tpu_torch.parallel import steps as S
    from tests.per_leaf_adam import PerLeafAdam

    tree = init_fcn8s(torch.Generator().manual_seed(6), 20)
    g = torch.Generator(device=dev).manual_seed(7)
    ims = torch.randint(0, 256, (2, 8, 512, 1024, 3), generator=g, device=dev, dtype=torch.uint8)
    lbs = torch.randint(0, 20, (2, 8, 512, 1024), generator=g, device=dev, dtype=torch.uint8)
    mask = torch.ones(8, device=dev)
    opt, loop = S.make_optimizer(), PerLeafAdam("adam")
    fused, looped = _train_state(dev, tree, opt), _train_state(dev, tree, loop)
    for i in range(2):
        _, want = S.train_step(looped, ims[i], lbs[i], mask, 9, 1e-4, 1e-4, 0.5, optimizer=loop,
                               num_classes=20)
        _, got = S.train_step(fused, ims[i], lbs[i], mask, 9, 1e-4, 1e-4, 0.5, optimizer=opt,
                              num_classes=20)
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert _states_equal(fused, looped)


def test_fc6_route_in_full_size_captured_steps_equals_eager(dev, deterministic):
    """The b8 train step (keep_prob 0.5) and the FCN-32s predict call at
    full size: the captured steps give the eager steps' loss, state and ids
    bit for bit, and an eager train step or predict call runs fc6's route
    once (its forward), as each replay counts it once."""
    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s
    from fcn8s_tensorflow_tpu_torch.ops.nn import conv2d_im2col
    from fcn8s_tensorflow_tpu_torch.parallel import steps as S

    tree = init_fcn8s(torch.Generator().manual_seed(6), 20)
    g = torch.Generator(device=dev).manual_seed(7)
    ims = torch.randint(0, 256, (2, 8, 512, 1024, 3), generator=g, device=dev, dtype=torch.uint8)
    lbs = torch.randint(0, 20, (2, 8, 512, 1024), generator=g, device=dev, dtype=torch.uint8)
    mask = torch.ones(8, device=dev)
    opt = S.make_optimizer()
    eager, comp = _train_state(dev, tree, opt), _train_state(dev, tree, opt)
    step = S.compile_train_step(None, opt, 20, device=dev)
    for i in range(2):
        n = conv2d_im2col.launches
        _, want = S.train_step(eager, ims[i], lbs[i], mask, 9, 1e-4, 1e-4, 0.5, optimizer=opt,
                               num_classes=20)
        assert conv2d_im2col.launches == n + 1
        _, got = step(comp, ims[i], lbs[i], mask, 9, 1e-4, 1e-4, 0.5)
        assert torch.equal(got, want)
        if i > 0:  # a replay
            assert conv2d_im2col.launches == n + 2
    torch.cuda.synchronize()
    assert _states_equal(comp, eager)
    del eager, comp, step, ims, lbs

    run = bridge.cast_params(bridge.to_port(init_fcn8s(torch.Generator().manual_seed(8), 20,
                                                       variant="fcn32s"), device=dev),
                             torch.bfloat16)
    frames = torch.randint(0, 256, (2, 8, 1024, 2048, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    predict = S.compile_predict_step(None, id_dtype=torch.uint8, device=dev)
    for i in range(2):
        n = conv2d_im2col.launches
        want = S.predict_step(run, frames[i], id_dtype=torch.uint8)
        assert conv2d_im2col.launches == n + 1
        assert torch.equal(predict(run, frames[i]), want)
        if i > 0:
            assert conv2d_im2col.launches == n + 2


def _segformer_b5(seed):
    from fcn8s_tensorflow_tpu_torch.models.segformer import init_segformer

    return init_segformer(torch.Generator().manual_seed(seed), 20)


def test_segformer_b5_captured_steps_equal_eager_on_the_card(dev, deterministic):
    """SegFormer-B5 at its published widths, batch 1 of 512x512, keep_prob
    0.9 (DropPath and the head's channel dropout drawn), AdamW with the
    head's and the norms' multipliers: two replays of the captured train
    step give the eager steps' losses, params, moments and BatchNorm
    statistics bit for bit, the multi-tensor update TF1 AdamW's per-leaf
    loop (``tests/per_leaf_adam.py``), and the compiled predict step the
    eager ids."""
    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.parallel import steps as S
    from tests.per_leaf_adam import PerLeafAdam

    tree = _segformer_b5(11)
    g = torch.Generator(device=dev).manual_seed(12)
    ims = torch.randint(0, 256, (3, 1, 512, 512, 3), generator=g, device=dev, dtype=torch.uint8)
    lbs = torch.randint(0, 20, (3, 1, 512, 512), generator=g, device=dev, dtype=torch.uint8)
    mask = torch.ones(1, device=dev)
    keys = {"decoder": {"lr_mult": 10.0}, "norm": {"decay_mult": 0.0}}
    opt = S.make_optimizer("adamw", weight_decay=0.01, custom_keys=keys)
    loop = PerLeafAdam("adamw", weight_decay=0.01, custom_keys=keys)
    eager, comp = _train_state(dev, tree, opt), _train_state(dev, tree, opt)
    looped = _train_state(dev, tree, loop)
    step = S.compile_train_step(None, opt, 20, device=dev)
    for i in range(3):
        _, want = S.train_step(eager, ims[i], lbs[i], mask, 9, 6e-5, 0.0, 0.9, optimizer=opt,
                               num_classes=20)
        _, got = step(comp, ims[i], lbs[i], mask, 9, 6e-5, 0.0, 0.9)
        assert torch.equal(got, want)
        _, by_loop = S.train_step(looped, ims[i], lbs[i], mask, 9, 6e-5, 0.0, 0.9,
                                  optimizer=loop, num_classes=20)
        assert torch.equal(by_loop, want)
    torch.cuda.synchronize()
    assert _states_equal(comp, eager) and _states_equal(looped, eager)
    assert all(torch.equal(a, b) for a, b in zip(bridge.state_leaves(comp.params),
                                                 bridge.state_leaves(eager.params)))
    run = bridge.cast_params(eager.params, torch.bfloat16)
    predict = S.compile_predict_step(None, id_dtype=torch.uint8, device=dev)
    with torch.no_grad():
        want = S.predict_step(run, ims[0], id_dtype=torch.uint8)
        assert torch.equal(predict(run, ims[0]), want)
        assert torch.equal(predict(run, ims[0]), want)


def test_segformer_attention_kernels_match_the_roofline_readers_names(dev):
    """The fused attention's forward and backward kernels on the card, at
    SegFormer's bf16 shapes (head dim 64), are what the benchmark's
    ``attention_*`` readers match by name, and nothing else is."""
    from portbench.metrics.arith.segformer import is_attention_kernel

    q = torch.randn(2, 1, 4096, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    kv = torch.randn(2, 2, 1, 256, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        o = torch.nn.functional.scaled_dot_product_attention(q, kv[0], kv[1])
        o.float().sum().backward()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    matched = sorted(n for n in names if is_attention_kernel(n))
    print("attention kernels:", matched)
    assert any(k in n.lower() for n in matched for k in ("bwd", "bprop", "backward")), names
    assert len(matched) >= 2, names
    assert not any(is_attention_kernel(n) for n in names
                   if "elementwise" in n or "reduce" in n.lower())
