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

from fcn8s_tensorflow_tpu_torch.ops import kernels as K  # noqa: E402
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


@pytest.mark.parametrize("logit_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label_dtype", [torch.uint8, torch.int32])
def test_ce_kernel_matches_twin(dev, logit_dtype, label_dtype):
    n, pps, c = 3, 4096, 20
    logits = (torch.randn(n * pps, c, device=dev) * 4).to(logit_dtype)
    labels = torch.randint(0, c, (n * pps,), device=dev).to(label_dtype)
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
