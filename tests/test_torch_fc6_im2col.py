"""PyTorch port, fc6's route (``ops.nn.conv2d_im2col``: one GEMM over the
NHWC im2col, cuDNN's backward) against ``ops.nn.conv2d`` and against the
JAX package's encoder head, on the CPU.

Tolerances, with their reasons:

* fp32 forward: ``atol = 1e-5 * max|conv2d|`` — the GEMM and oneDNN's
  convolution sum the 7x7xC products in different orders;
* bf16 forward: within one bf16 rounding of the fp32 convolution of the
  same bf16 values (the product is accumulated in fp32 and rounded once);
* gradients: equal bit for bit — both routes call the same
  ``aten.convolution_backward`` with the same arguments and output gradient;
* the head against JAX: ``test_torch_model.py``'s logits tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.models.vgg16 import apply_vgg16 as j_apply_vgg16  # noqa: E402
from fcn8s_tensorflow_tpu.models.vgg16 import init_vgg16 as j_init_vgg16  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.vgg16 import apply_vgg16 as t_apply_vgg16  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.nn import conv2d, conv2d_im2col, nhwc  # noqa: E402

N, C, O, H, W, K = 2, 16, 24, 4, 8, 7  # fc6's 7x7 on a 2x4x8 map, narrowed
SHARDS = 2  # _run_head_tp's column split of fc6's output channels


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -126))) - 7)


def _inputs(case: str, dtype, seed: int = 0):
    """``(x, weight, bias, halo)`` as fc6's call site passes them in
    ``case``: the whole map (``plain``), a width block extended by its halo
    (``halo``), or one rank's column shard of the kernel (``column_shard``)."""
    g = torch.Generator().manual_seed(seed)
    halo = case == "halo"
    width = W + 2 * (K // 2) if halo else W
    x = torch.randn((N, C, H, width), generator=g).to(dtype)
    w = (torch.randn((O, C, K, K), generator=g) / (C * K * K) ** 0.5).to(dtype)
    b = torch.randn(O, generator=g)
    if case == "column_shard":
        o = O // SHARDS
        w, b = w[o:2 * o], b[o:2 * o]
    cl = torch.channels_last
    return (x.contiguous(memory_format=cl), w.contiguous(memory_format=cl), b.to(dtype), halo)


def _run(fn, x, w, b, halo, grad_out):
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    y = fn(*leaves, halo=halo)
    y.backward(grad_out)
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["plain", "halo", "column_shard"])
def test_conv2d_im2col_equals_conv2d(case, dtype):
    """Forward within the summation order (fp32) or one rounding (bf16) of
    ``conv2d``; input, weight and bias gradients bit for bit; a channels_last
    output; one launch counted per call, with and without autograd."""
    x, w, b, halo = _inputs(case, dtype)
    ref = conv2d(x.float(), w.float(), b.float(), halo=halo)
    grad_out = torch.randn(ref.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    grad_out = grad_out.contiguous(memory_format=torch.channels_last)
    want, want_grads = _run(conv2d, x, w, b, halo, grad_out)

    n = conv2d_im2col.launches
    got, got_grads = _run(conv2d_im2col, x, w, b, halo, grad_out)
    assert conv2d_im2col.launches == n + 1
    with torch.no_grad():
        again = conv2d_im2col(x, w, b, halo=halo)
    assert conv2d_im2col.launches == n + 2 and again.grad_fn is None
    assert torch.equal(again, got)

    assert got.shape == want.shape == (N, w.shape[0], H, W) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    else:
        slack = _bf16_ulp(ref) / 2 + 1e-5 * ref.abs().max()  # one rounding, then the sum order
        assert bool(((got.float() - ref).abs() <= slack).all())
    for g, wg in zip(got_grads, want_grads):
        assert g.dtype == wg.dtype and torch.equal(g, wg)


def test_conv2d_im2col_takes_odd_kernels_only():
    x = torch.zeros((1, 4, 4, 4))
    with pytest.raises(ValueError, match="odd kernels"):
        conv2d_im2col(x, torch.zeros((8, 4, 2, 2)))


def test_conv2d_im2col_weight_matrix_is_a_view_of_a_channels_last_kernel():
    """The OIHW kernel in channels_last memory is OHWI bytes: its (O, 49 C)
    matrix needs no copy, so the GEMM reads the cast weights in place."""
    _, w, _, _ = _inputs("plain", torch.bfloat16)
    assert nhwc(w).reshape(w.shape[0], -1).data_ptr() == w.data_ptr()
    assert nhwc(w).reshape(w.shape[0], -1).is_contiguous()


@pytest.mark.parametrize("train", [False, True])
def test_vgg16_head_through_the_route_matches_jax(train):
    """The narrow encoder (fc6 7x7x16x32 on a 2x4 map) in fp32 against the
    JAX package's: fc7's output within the logits tolerance, fc6 counted
    once a forward; under autograd, fc6's kernel gradient too."""
    tree = jax.tree.map(np.array, j_init_vgg16(jax.random.PRNGKey(3), width_mult=1 / 32,
                                                fc_channels=32))
    images = np.random.default_rng(3).integers(0, 256, (N, 64, 128, 3), dtype=np.uint8)
    g = np.random.default_rng(4).normal(size=(N, 2, 4, 32)).astype(np.float32)

    def j_loss(fc6_kernel):
        params = dict(tree, fc6={"kernel": fc6_kernel, "bias": tree["fc6"]["bias"]})
        fc7 = j_apply_vgg16(params, jnp.asarray(images), compute_dtype=jnp.float32)[2]
        return jnp.sum(fc7 * g), fc7

    (_, want), want_grad = jax.value_and_grad(j_loss, has_aux=True)(tree["fc6"]["kernel"])
    run = bridge.cast_params(bridge.to_port({"encoder": tree}), torch.float32)["encoder"]
    fc6_w = run["fc6"]["weight"].requires_grad_(train)
    n = conv2d_im2col.launches
    with torch.set_grad_enabled(train):
        got = t_apply_vgg16(run, torch.from_numpy(images), compute_dtype=torch.float32)[2]
    assert conv2d_im2col.launches == n + 1
    got_nhwc = nhwc(got).detach().numpy()
    want = np.asarray(want)
    assert got_nhwc.shape == want.shape == (N, 2, 4, 32)
    np.testing.assert_allclose(got_nhwc, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    if train:
        (nhwc(got) * torch.from_numpy(g)).sum().backward()
        got_grad = fc6_w.grad.permute(2, 3, 1, 0).numpy()  # OIHW -> HWIO
        want_grad = np.asarray(want_grad)
        np.testing.assert_allclose(got_grad, want_grad, rtol=1e-4,
                                   atol=1e-4 * np.abs(want_grad).max())
