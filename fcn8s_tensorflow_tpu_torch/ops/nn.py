"""Core NN ops: SAME convolution, the plain 2x2 max pool, dropout and the
bilinear resize of the TTA head.

Port of ``fcn8s_tensorflow_tpu/ops/nn.py``. Activations inside the port are
NCHW-shaped tensors in ``torch.channels_last`` memory, which is the JAX
package's NHWC byte layout: cuDNN takes it directly, and the pool kernel
(``ops/pool.py``) reads it as NHWC. Kernels are OIHW (the bridge converts
JAX's HWIO). ``nhwc``/``nchw`` switch between the two logical views of the
same memory without a copy.

Every convolution of the model runs on cuDNN (``conv2d``) but fc6's
forward: ``conv2d_im2col`` runs it as one bf16 GEMM over its explicit NHWC
im2col on the tensor cores, with cuDNN's dgrad and wgrad for its backward.
At fc6's shapes (7x7, 512 -> 4096, a 16x32 or 32x64 map) cuDNN's heuristics
pick a CUDA-core forward kernel, while its backward already runs on the
tensor cores. Only fc6 takes the route: its im2col is 49 times an input of
a few hundred pixels a frame (0.2 GB at batch 8 of 512x1024, 0.8 GB of
1024x2048), where a 3x3 conv's at 0.5-2 MP a frame would be several GB, and
cuDNN runs those on tensor-core kernels already.

Every deconv of the model runs through ``ops/subpixel.py``.
``conv2d_transpose`` is JAX's input-dilated form, written out as one: the
decoder's ``subpixel=False`` path and a reference for the subpixel rewrite.
``nn.ConvTranspose2d`` would be wrong here (its kernel is the spatial flip
of JAX's lhs-dilated cross-correlation).
"""

from __future__ import annotations

from collections import Counter

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
    (``bridge.cast_params``) make that a no-op. On the card PyTorch adds the
    bias after cuDNN's convolution, as its own add in ``x``'s dtype, as
    JAX's ``conv2d`` adds it after the convolution: a second rounding in
    bf16 (``conv2d_im2col`` adds it in fp32, before its one rounding).

    ``halo=True``: ``x`` is a width block already extended by ``kw // 2``
    columns on each side (``parallel.collectives.halo_exchange``), so only
    the height is padded and the output has the block's width."""
    kh, kw = weight.shape[2], weight.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"conv2d: SAME padding here needs odd kernels, got {kh}x{kw}")
    return F.conv2d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    padding=(kh // 2, 0 if halo else kw // 2))


def im2col_nhwc(xq: torch.Tensor, kh: int, kw: int, k_cols: int,
                halo: bool = False) -> torch.Tensor:
    """The (N*H*W, k_cols) im2col of an NHWC tensor for a stride-1 SAME
    kh x kw convolution: the input zero-padded by (kh//2, kw//2), its
    kh*kw shifted views concatenated along channels in (ky, kx, c) order,
    then zero columns up to ``k_cols``. A 1x1 kernel without padding is a
    view. ``halo=True``: the input is a width block already extended by
    ``kw // 2`` columns on each side (``ops.nn.conv2d``'s ``halo``), so
    only the height is padded."""
    n, h, w, c = xq.shape
    if halo:
        w -= 2 * (kw // 2)
    k = kh * kw * c
    if (kh, kw) == (1, 1) and k == k_cols:
        return xq.reshape(n * h * w, c)
    xp = F.pad(xq, (0, 0, 0 if halo else kw // 2, 0 if halo else kw // 2, kh // 2, kh // 2))
    views = [xp[:, ky:ky + h, kx:kx + w, :] for ky in range(kh) for kx in range(kw)]
    if k_cols > k:
        views.append(xq.new_zeros((n, h, w, k_cols - k)))
    cols = torch.cat(views, dim=3)
    del xp, views
    return cols.reshape(n * h * w, k_cols)


def _conv2d_im2col_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                           halo: bool) -> torch.Tensor:
    """``conv2d_im2col``'s arithmetic: the im2col times the kernel's
    ``(O, kh*kw*C)`` matrix in fp32, the bias added in fp32, one rounding
    into a fresh channels_last ``(N, O, H, W)`` tensor of ``x``'s dtype."""
    o, c, kh, kw = weight.shape
    n, h, w = x.shape[0], x.shape[2], x.shape[3] - (2 * (kw // 2) if halo else 0)
    cols = im2col_nhwc(nhwc(x), kh, kw, kh * kw * c, halo)
    mat = nhwc(weight).reshape(o, -1).t()  # a view where the weight is channels_last (OHWI)
    if x.is_cuda and x.dtype != torch.float32:
        # an fp32 result: cuBLAS keeps any split-K's partial sums in fp32
        acc = torch.mm(cols, mat, out_dtype=torch.float32)
    else:
        acc = torch.mm(cols.float(), mat.float())
    del cols
    if bias is not None:
        acc += bias.float()
    out = torch.empty((n, o, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    nhwc(out).copy_(acc.view(n, h, w, o))
    return out


class _Conv2dIm2col(torch.autograd.Function):
    """``conv2d_im2col`` under autograd: the GEMM forward, and for the
    backward ``aten.convolution_backward`` with the arguments autograd of
    ``F.conv2d`` passes it, so the gradients are cuDNN's dgrad and wgrad
    of ``conv2d``, bit for bit for a given output gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, halo):
        ctx.save_for_backward(x, weight)
        ctx.has_bias, ctx.halo = bias is not None, halo
        return _conv2d_im2col_forward(x, weight, bias, halo)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        kh, kw = weight.shape[2], weight.shape[3]
        need = ctx.needs_input_grad
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad, x, weight, [weight.shape[0]] if ctx.has_bias else None, [1, 1],
            [kh // 2, 0 if ctx.halo else kw // 2], [1, 1], False, [0, 0], 1,
            [need[0], need[1], ctx.has_bias and need[2]])
        return gx, gw, gb, None


def conv2d_im2col(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
                  halo: bool = False) -> torch.Tensor:
    """``conv2d`` (same arguments, same result up to the order of the sums)
    as one GEMM over the explicit NHWC im2col (``im2col_nhwc``): bf16
    operands on the tensor cores, fp32 accumulation over the whole
    ``kh*kw*C``, the bias added in fp32, one rounding to ``x``'s dtype.
    Returns a channels_last ``(N, O, H, W)`` tensor, as ``conv2d`` does.

    For fc6 (7x7, 512 -> 4096) at a few hundred pixels a frame, where cuDNN
    picks a CUDA-core kernel for the forward; its ~1 GB im2col at
    predict's map is affordable there, not at a 3x3 conv's 0.5-2 MP maps.
    Under autograd the backward is cuDNN's (``_Conv2dIm2col``); without it
    the GEMM runs alone. Runs on any device: on the CPU the product is an
    fp32 ``mm`` of the upcast operands. Counts its calls in
    ``conv2d_im2col.launches``."""
    kh, kw = weight.shape[2], weight.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"conv2d_im2col: SAME padding here needs odd kernels, got {kh}x{kw}")
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    conv2d_im2col.launches += 1
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias)):
        return _Conv2dIm2col.apply(x, weight, bias, halo)
    return _conv2d_im2col_forward(x, weight, bias, halo)


conv2d_im2col.launches = 0


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


# ---------------------------------------------------------------------------
# the transformer ops of SegFormer (models/segformer.py): token-major linear
# layers, the attention, LayerNorm, GELU, the strided and depthwise
# convolutions, the bilinear upsample of its head and training-mode BatchNorm
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ kernel + bias`` over the last dim of token-major ``x`` (any
    leading dims), ``kernel`` ``(in, out)`` as the JAX layout keeps a dense
    kernel, in ``x``'s dtype: one GEMM with the bias in its epilogue."""
    return F.linear(x, kernel.to(x.dtype).t(), None if bias is None else bias.to(x.dtype))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` per head of ``q`` (B, heads, N, d)
    and ``k``, ``v`` (B, heads, M, d), through
    ``F.scaled_dot_product_attention`` (the card's fused kernels). Counts
    the call's ``(B, heads, N, M, d)`` in ``attention.calls``, which a
    captured step adds to once per replay (``parallel/graphs.py``)."""
    n_b, heads, n, d = q.shape
    attention.calls[(n_b, heads, n, k.shape[2], d)] += 1
    return F.scaled_dot_product_attention(q, k, v)


attention.calls = Counter()


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """LayerNorm over the last dim, computed in fp32 (the input upcast, the
    fp32 ``scale``/``bias``), the result in ``out_dtype`` (default ``x``'s)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(out_dtype or x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the exact erf, in ``x``'s dtype."""
    return F.gelu(x)


def conv2d_strided(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, stride: int,
                   padding: int) -> torch.Tensor:
    """``nn.Conv2d``'s convolution: NCHW x OIHW, ``stride`` and symmetric
    zero ``padding`` as given, in ``x``'s dtype (a patch embedding, or a
    spatial reduction with kernel = stride and no padding)."""
    return F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding)


def depthwise_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A 3x3 depthwise convolution with zero padding 1 (``groups`` = the
    channels), NCHW x ``(C, 1, 3, 3)``, in ``x``'s dtype."""
    return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), padding=1, groups=x.shape[1])


def upsample_bilinear(x: torch.Tensor, size_hw) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size_hw`` with half-pixel centres
    (``align_corners=False``) and no antialiasing, in ``x``'s dtype: the
    resize of SegFormer's head and of its logits to the input (upsampling
    only; ``resize_bilinear`` is the antialiased form of the TTA head)."""
    return F.interpolate(x, size=(int(size_hw[0]), int(size_hw[1])), mode="bilinear",
                         align_corners=False)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
               var: torch.Tensor, *, training: bool, momentum: float = 0.1,
               eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over the channels of NCHW ``x``, in fp32, the result in
    ``x``'s dtype. ``training``: normalised by the batch's statistics (the
    biased variance), and the fp32 running ``mean``/``var`` updated IN PLACE
    with ``momentum`` (the unbiased variance), as ``nn.BatchNorm2d`` does;
    otherwise normalised by the running statistics."""
    y = F.batch_norm(x.float(), mean, var, scale.float(), bias.float(), training=training,
                     momentum=momentum, eps=eps)
    return y.to(x.dtype)


def keep_mask(u: torch.Tensor, keep) -> tuple[torch.Tensor, torch.Tensor]:
    """The keep-mask ``u < keep`` of fp32 uniforms ``u`` and the scale
    ``1 / keep`` of the kept entries (``keep`` a float or fp32 tensor that
    broadcasts against ``u``), both compared and divided in fp32, so a float
    and a 0-d tensor ``keep`` of the same value give the same bits."""
    keep = torch.as_tensor(keep, dtype=torch.float32, device=u.device)
    return u < keep, 1.0 / torch.clamp(keep, min=1e-8)


def scale_kept(x: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x * scale`` where ``mask`` holds and exact zeros elsewhere, the
    scale rounded to ``x``'s dtype first (``mask`` and ``scale`` broadcast
    against ``x``): inverted dropout with a given mask."""
    return torch.where(mask, x * scale.to(x.dtype), 0.0)
