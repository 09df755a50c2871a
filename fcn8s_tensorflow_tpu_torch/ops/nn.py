"""Core NN ops: SAME convolution, the plain 2x2 max pool, dropout and the
bilinear resize of the TTA head.

Port of ``fcn8s_tensorflow_tpu/ops/nn.py``. Activations inside the port are
NCHW-shaped tensors in ``torch.channels_last`` memory, which is the JAX
package's NHWC byte layout: cuDNN takes it directly, and the pool kernel
(``ops/pool.py``) reads it as NHWC. Kernels are OIHW (the bridge converts
JAX's HWIO). ``nhwc``/``nchw`` switch between the two logical views of the
same memory without a copy.

Every deconv of the model runs through ``ops/subpixel.py``.
``conv2d_transpose`` is JAX's input-dilated form, written out as one: the
decoder's ``subpixel=False`` path and a reference for the subpixel rewrite.
``nn.ConvTranspose2d`` would be wrong here (its kernel is the spatial flip
of JAX's lhs-dilated cross-correlation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    """NHWC view -> NCHW view of the same memory (channels_last when the
    input is contiguous)."""
    return x_nhwc.permute(0, 3, 1, 2)


def nhwc(x_nchw: torch.Tensor) -> torch.Tensor:
    """NCHW view -> NHWC view of the same memory (contiguous when the input
    is channels_last)."""
    return x_nchw.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
           halo: bool = False) -> torch.Tensor:
    """Stride-1 SAME convolution, NCHW x OIHW -> NCHW, in ``x``'s dtype.

    Every kernel of the model is odd (3x3, 7x7) or 1x1, so TF-SAME padding is
    the symmetric ``k // 2``. The weight is cast to ``x.dtype`` as JAX's
    ``conv2d`` does; callers that hold weights already in the compute dtype
    (``bridge.cast_params``) make that a no-op. The bias is added inside the
    convolution's fp32 accumulator instead of after the rounding to the
    compute dtype: exact in fp32, within one bf16 rounding otherwise.

    ``halo=True``: ``x`` is a width block already extended by ``kw // 2``
    columns on each side (``parallel.collectives.halo_exchange``), so only
    the height is padded and the output has the block's width."""
    kh, kw = weight.shape[2], weight.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"conv2d: SAME padding here needs odd kernels, got {kh}x{kw}")
    return F.conv2d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    padding=(kh // 2, 0 if halo else kw // 2))


def _same_transpose_padding(k: int, s: int) -> tuple[int, int]:
    """(lo, hi) padding of the s-dilated input so that a stride-1 conv with
    kernel k yields exactly in*s outputs, as TF's SAME deconv crops."""
    pad_total = s + k - 2
    if k - s >= 0:
        pad_lo = k - 1 - (k - s + 1) // 2
    else:
        pad_lo = (pad_total + 1) // 2
    return pad_lo, pad_total - pad_lo


def conv2d_transpose(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, *,
                     strides=(2, 2)) -> torch.Tensor:
    """Fractionally strided convolution with TF-SAME semantics (JAX's
    ``conv2d_transpose``): NCHW ``x`` -> NCHW ``(n, O, h*sh, w*sw)``, for an
    HWIO ``kernel`` (I = ``x``'s channels) as the port's deconv layers keep
    it. The input is dilated by the strides with zeros, padded by
    ``_same_transpose_padding`` and cross-correlated with the kernel, in
    ``x``'s dtype; the bias is added after."""
    n, c, h, w = x.shape
    kh, kw = kernel.shape[0], kernel.shape[1]
    sh, sw = strides
    dilated = x.new_zeros((n, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
    dilated[:, :, ::sh, ::sw] = x
    (ph_lo, ph_hi), (pw_lo, pw_hi) = _same_transpose_padding(kh, sh), _same_transpose_padding(kw, sw)
    dilated = F.pad(dilated, (pw_lo, pw_hi, ph_lo, ph_hi))
    out = F.conv2d(dilated, kernel.permute(3, 2, 0, 1).to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None, None]
    return out.contiguous(memory_format=torch.channels_last)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool with SAME padding on NCHW: odd dims round up
    (``ceil_mode``), matching ``lax.reduce_window(..., padding='SAME')``.
    NaN propagates like ``lax.max``. The plain twin of the K4f kernel."""
    return F.max_pool2d(x, kernel_size=2, stride=2, ceil_mode=True)


def resize_bilinear(x_nhwc: torch.Tensor, size_hw) -> torch.Tensor:
    """``jax.image.resize(x, (n, h, w, c), method="bilinear")`` of an NHWC
    float tensor: half-pixel centres, and when it downscales a triangle
    kernel widened by the scale, which is ``F.interpolate``'s
    ``antialias=True`` (without it a downscale differs by up to half the
    input's range). Returns a contiguous NHWC tensor."""
    h, w = size_hw
    out = F.interpolate(nchw(x_nhwc), size=(int(h), int(w)), mode="bilinear",
                        align_corners=False, antialias=True)
    return nhwc(out).contiguous()


def applies_dropout(keep_prob) -> bool:
    """Whether dropout at ``keep_prob`` drops anything: a float below 1, or
    a 0-d tensor, which a step captured in a CUDA graph passes in place of
    a keep_prob below 1 (``parallel/graphs.py``: its value is filled in
    before each replay, and reading it back here would sync)."""
    return isinstance(keep_prob, torch.Tensor) or keep_prob < 1.0


def dropout_mask(shape, keep_prob, generator: torch.Generator) -> torch.Tensor:
    """A bool keep-mask of NCHW ``shape`` (channels_last memory, like the
    activations), each unit kept with probability ``keep_prob`` (a float,
    or a 0-d fp32 tensor on the generator's device), drawn from
    ``generator`` on its device. Drawn apart from ``dropout`` so that a
    recomputed forward (remat) can apply the same mask again. Both forms
    compare the fp32 uniforms with the fp32 ``keep_prob``."""
    n, c, h, w = shape
    u = torch.rand((n, h, w, c), generator=generator, device=generator.device)
    return nchw(u < keep_prob)


def dropout(x: torch.Tensor, keep_prob, mask: torch.Tensor) -> torch.Tensor:
    """Inverted dropout as TF's ``tf.nn.dropout`` (the JAX package's
    ``dropout``): kept units are divided by ``max(keep_prob, 1e-8)``, that
    scale rounded to ``x.dtype`` first, and dropped units are exact zeros.
    At a float ``keep_prob >= 1`` it is the identity, as JAX's
    bernoulli(1.0) is. A 0-d fp32 tensor ``keep_prob`` on ``x``'s device
    (``applies_dropout``) gives the float's result bit for bit, its scale
    computed on the device instead of the host."""
    if not applies_dropout(keep_prob):
        return x
    kp = keep_prob
    if not isinstance(kp, torch.Tensor):
        kp = torch.tensor(keep_prob, dtype=torch.float32)  # a 0-d CPU tensor acts as a scalar
    scale = (1.0 / torch.clamp(kp, min=1e-8)).to(x.dtype)
    return torch.where(mask, x * scale, 0.0)
