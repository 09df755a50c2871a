"""Int8 quantized inference (serving). Port of
``fcn8s_tensorflow_tpu/ops/quantize.py``.

* **weights**: per-output-channel symmetric int8, ``scale = max|w| / 127``
  per output channel (1 where a channel is all zero),
  ``w_q = round(w / scale)`` with round-half-to-even, as ``jnp.round``;
* **activations**: per-tensor symmetric int8, dynamic (the scale from the
  tensor's own ``max|x|``, on the device, no host sync) or calibrated static
  (``collect_activation_absmax`` then ``quantize_fcn8s_params(params,
  absmax)``: each conv's ``act_scale`` is frozen);
* **accumulation**: int8 x int8 -> int32, dequantized as
  ``acc * (x_scale * w_scale) + bias`` in fp32 by one ``torch.addcmul``, a
  fused multiply-add as XLA compiles JAX's expression, then cast to the
  compute dtype.

Every scale's ``/ 127`` is a multiplication by fp32(1/127), as XLA compiles
the JAX functions (it rewrites a division by a constant so; JAX run op by
op divides, and 5% of the scales then differ by an ulp): the scales equal
the jitted JAX facade's bit for bit. ``w / scale`` and ``x / scale`` are
true divisions in both.

The decoder stays in the compute dtype (``models/fcn8s.apply_fcn8s_decoder``);
the encoder's pools are ``ops/pool.maxpool2x2`` (K4f on the card), which
computes the same max as the JAX path's ``lax.reduce_window``.

**The int8 convolution's route.** JAX runs it as XLA's
``conv_general_dilated(..., preferred_element_type=int32)``, not a Pallas
kernel, and eager PyTorch has no public CUDA int8 convolution. On the card
``conv2d_int8_im2col`` builds the im2col of the NHWC int8 input explicitly
(zero-pad by the SAME margins, concatenate the kh x kw shifted views along
channels: K index ``(ky * kw + kx) * I + c``) and runs one
``torch._int_mm`` (cuBLASLt) of ``(N*H*W, K) x (K, O)``. ``_int_mm`` wants
more than 16 rows and K and N multiples of 8, so the layer's GEMM matrix
``kernel_mat`` is laid out once, at quantization time, zero-padded to
multiples of 8 (conv1_1's K = 27 becomes 32), and a product of 16 rows or
fewer gets zero rows appended; anything else it rejects raises. The plain
twin ``conv2d_int8_reference`` convolves the same int8 values in fp64 and
casts to int32: every product is exact and every sum stays below 2^53 (the
largest is 127^2 * 25,088 ~ 4.0e8), so it is exact too. A CPU tensor takes
the twin; the card never does unless a caller asks for it by name.

A quantized layer is ``{'kernel_q': (O, kh, kw, I) int8 (OHWI, the
im2col's K order), 'kernel_mat': (O8, K8) int8 (a view of kernel_q where no
padding is needed), 'scale': (O,) fp32, 'bias': (O,) fp32[, 'act_scale':
0-d fp32]}``; ``bridge.quantized_to_port`` builds the same tree from the JAX
package's ``quantize_fcn8s_params`` output.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import bridge
from ..models.fcn8s import apply_fcn8s_decoder
from ..models.vgg16 import _BLOCK_ENDS, VGG16_CONV_LAYERS, VGG_MEAN_RGB
from ..parallel.collectives import all_reduce
from .nn import conv2d, nchw, nhwc
from .pool import maxpool2x2

INT8_MAX = 127.0
_INV_INT8_MAX = float(np.float32(1.0) / np.float32(INT8_MAX))  # XLA's folded 1 / 127
_GEMM_ALIGN = 8  # _int_mm's K and N multiple
_GEMM_MIN_ROWS = 17  # _int_mm wants more than 16 rows


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def quantize_kernel_per_channel(weight: torch.Tensor):
    """OIHW kernel -> (OIHW int8 kernel, (O,) fp32 scale), as the JAX
    function on the HWIO kernel: ``scale = max|w| over (I, H, W) / 127``,
    1 where that max is 0; ``w_q = clip(round(w / scale), -127, 127)``."""
    w = weight.detach().float()
    absmax = w.abs().amax(dim=(1, 2, 3))
    scale = torch.where(absmax > 0, absmax * _INV_INT8_MAX, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale[:, None, None, None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def quantized_layer(kernel_q_ohwi: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    act_scale: torch.Tensor | None = None) -> dict:
    """A quantized layer from its OHWI int8 kernel: the GEMM matrix
    ``kernel_mat`` (O, K) in the im2col's K order, zero-padded to multiples
    of 8 in both dims (a view of the kernel where none is needed)."""
    kq = kernel_q_ohwi.contiguous()
    o, k = kq.shape[0], kq[0].numel()
    mat = kq.reshape(o, k)
    o8, k8 = _round_up(o, _GEMM_ALIGN), _round_up(k, _GEMM_ALIGN)
    if (o8, k8) != (o, k):
        mat = F.pad(mat, (0, k8 - k, 0, o8 - o))
    layer = {"kernel_q": kq, "kernel_mat": mat, "scale": scale.float(), "bias": bias.float()}
    if act_scale is not None:
        layer["act_scale"] = act_scale.float()
    return layer


def quantize_vgg16_params(encoder_params: dict, act_absmax: dict | None = None) -> dict:
    """Per-layer quantized layers (``quantized_layer``) for the encoder
    convs of a port master tree (OIHW ``weight``, ``bias``).
    ``act_absmax`` (from ``collect_activation_absmax``) adds calibrated
    static activation scales, ``max(absmax, 1e-12) / 127``."""
    out = {}
    for name, layer in encoder_params.items():
        q, scale = quantize_kernel_per_channel(layer["weight"])
        act_scale = None
        if act_absmax is not None:
            act_scale = torch.clamp(torch.as_tensor(act_absmax[name], dtype=torch.float32),
                                    min=1e-12) * _INV_INT8_MAX
        out[name] = quantized_layer(q.permute(0, 2, 3, 1), scale,
                                    layer["bias"].detach().float().clone(), act_scale)
    return out


def quantize_activation(x: torch.Tensor, static_scale: torch.Tensor | None = None, mesh=None):
    """Per-tensor symmetric int8 of ``x``: returns ``(x_q int8, scale)``,
    scale a 0-d fp32 tensor on ``x``'s device. Dynamic mode
    (``static_scale=None``): ``max(max|x|, 1e-12) / 127``, the max taken
    over the whole batch when ``x`` is this rank's rows of a batch split
    over ``mesh``'s 'data' axis; static mode: the given scale.
    ``x_q = clip(round(x / scale), -127, 127)`` in fp32."""
    xf = x.float()
    if static_scale is None:
        absmax = all_reduce(xf.abs().amax(), mesh, op=dist.ReduceOp.MAX)
        scale = torch.clamp(absmax, min=1e-12) * _INV_INT8_MAX
    else:
        scale = static_scale.to(device=x.device, dtype=torch.float32)
    xq = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return xq, scale


def _kernel_hw(kernel_q: torch.Tensor) -> tuple[int, int]:
    kh, kw = kernel_q.shape[1], kernel_q.shape[2]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"int8 conv: SAME padding here needs odd kernels, got {kh}x{kw}")
    return kh, kw


def im2col_nhwc(xq: torch.Tensor, kh: int, kw: int, k_cols: int) -> torch.Tensor:
    """The (N*H*W, k_cols) im2col of an NHWC tensor for a stride-1 SAME
    kh x kw convolution: the input zero-padded by (kh//2, kw//2), its
    kh*kw shifted views concatenated along channels in (ky, kx, c) order,
    then zero columns up to ``k_cols``. A 1x1 kernel without padding is a
    view."""
    n, h, w, c = xq.shape
    k = kh * kw * c
    if (kh, kw) == (1, 1) and k == k_cols:
        return xq.reshape(n * h * w, c)
    xp = F.pad(xq, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    views = [xp[:, ky:ky + h, kx:kx + w, :] for ky in range(kh) for kx in range(kw)]
    if k_cols > k:
        views.append(xq.new_zeros((n, h, w, k_cols - k)))
    cols = torch.cat(views, dim=3)
    del xp, views
    return cols.reshape(n * h * w, k_cols)


def conv2d_int8_im2col(xq: torch.Tensor, kernel_q: torch.Tensor,
                       kernel_mat: torch.Tensor) -> torch.Tensor:
    """int32 accumulators ``(N, H, W, O)`` of the SAME convolution of NHWC
    int8 ``xq`` with the layer's int8 kernel, as one ``torch._int_mm`` over
    the explicit im2col (``im2col_nhwc``). Runs on any device; on the card
    it is the int8 conv's route. Counts its calls in
    ``conv2d_int8_im2col.launches``."""
    n, h, w, _ = xq.shape
    kh, kw = _kernel_hw(kernel_q)
    o = kernel_q.shape[0]
    cols = im2col_nhwc(xq, kh, kw, kernel_mat.shape[1])
    m = cols.shape[0]
    if m < _GEMM_MIN_ROWS:
        cols = F.pad(cols, (0, 0, 0, _GEMM_MIN_ROWS - m))
    acc = torch._int_mm(cols, kernel_mat.t())
    del cols
    conv2d_int8_im2col.launches += 1
    if m < _GEMM_MIN_ROWS or acc.shape[1] != o:
        acc = acc[:m, :o].contiguous()
    return acc.reshape(n, h, w, o)


conv2d_int8_im2col.launches = 0


def conv2d_int8_reference(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """The plain twin of ``conv2d_int8_im2col``: the same int8 values
    convolved in fp64 (exact, see the module docstring), cast to int32.
    NHWC in, ``(N, H, W, O)`` out."""
    kh, kw = _kernel_hw(kernel_q)
    x = nchw(xq).double()
    wt = kernel_q.permute(0, 3, 1, 2).double()
    out = F.conv2d(x, wt, padding=(kh // 2, kw // 2))
    return nhwc(out).to(torch.int32).contiguous()


def int8_conv_acc(xq: torch.Tensor, qlayer: dict) -> torch.Tensor:
    """int32 accumulators of a quantized layer on NHWC int8 ``xq``: the
    twin for a CPU tensor, the ``_int_mm`` route otherwise."""
    if xq.device.type == "cpu":
        return conv2d_int8_reference(xq, qlayer["kernel_q"])
    return conv2d_int8_im2col(xq, qlayer["kernel_q"], qlayer["kernel_mat"])


def conv2d_int8(x: torch.Tensor, qlayer: dict, *, compute_dtype=torch.bfloat16,
                mesh=None) -> torch.Tensor:
    """Quantized stride-1 SAME conv of an NCHW (channels_last) activation:
    int8 activations (dynamic, or static with the layer's ``act_scale``)
    times the per-channel int8 kernel, int32 accumulation, fp32 dequant
    ``acc * (x_scale * w_scale) + bias``, cast to ``compute_dtype``. The
    result is NCHW-shaped channels_last, as ``ops.nn.conv2d``'s."""
    xq, x_scale = quantize_activation(x, qlayer.get("act_scale"), mesh)
    acc = int8_conv_acc(nhwc(xq), qlayer)
    del xq
    accf = acc.float()
    del acc
    out = torch.addcmul(qlayer["bias"], accf, x_scale * qlayer["scale"])
    del accf
    return nchw(out.to(compute_dtype))


def _normalized(images: torch.Tensor, normalize: bool, compute_dtype) -> torch.Tensor:
    """The encoder's input: the mean-RGB subtraction in fp32 (unless not
    ``normalize``), the cast, NCHW channels_last."""
    x = images.float()
    if normalize:
        x = x - torch.tensor(VGG_MEAN_RGB, dtype=torch.float32, device=images.device)
    return nchw(x.to(compute_dtype).contiguous())


def apply_vgg16_int8(qparams: dict, images: torch.Tensor, *, compute_dtype=torch.bfloat16,
                     normalize: bool = True, mesh=None):
    """The quantized encoder (keep_prob 1, a serving path) on NHWC images:
    mean-RGB subtraction in fp32 (unless not ``normalize``), the cast to
    ``compute_dtype``, then ``conv2d_int8`` + ReLU per layer and the pools.
    Returns ``(pool3, pool4, fc7)`` as ``models.vgg16.apply_vgg16`` does.
    ``mesh``: ``images`` are this rank's rows of a batch split over 'data',
    and the dynamic scales are the whole batch's (the int8 tree itself is
    replicated, never tensor-parallel)."""
    x = _normalized(images, normalize, compute_dtype)
    pool3 = pool4 = None
    for name, _, _ in VGG16_CONV_LAYERS:
        x = torch.relu_(conv2d_int8(x, qparams[name], compute_dtype=compute_dtype, mesh=mesh))
        if name in _BLOCK_ENDS:
            x = maxpool2x2(x)
            if name == "conv3_3":
                pool3 = x
            elif name == "conv4_3":
                pool4 = x
    x = torch.relu_(conv2d_int8(x, qparams["fc6"], compute_dtype=compute_dtype, mesh=mesh))
    x = torch.relu_(conv2d_int8(x, qparams["fc7"], compute_dtype=compute_dtype, mesh=mesh))
    return pool3, pool4, x


def collect_activation_absmax(params: dict, images: torch.Tensor, *,
                              compute_dtype=torch.bfloat16, normalize: bool = True) -> dict:
    """Calibration pass: the float encoder (``params['encoder']``, master or
    ``bridge.cast_params`` weights, whole fc6/fc7) on NHWC ``images``;
    returns each quantized conv's INPUT ``max|x|`` (layer name -> 0-d fp32
    tensor on the device). Over several batches, take the elementwise max."""
    x = _normalized(images, normalize, compute_dtype)
    enc = params["encoder"]
    absmax = {}
    for name, _, _ in VGG16_CONV_LAYERS:
        absmax[name] = x.float().abs().amax()
        x = torch.relu_(conv2d(x, enc[name]["weight"], enc[name]["bias"]))
        if name in _BLOCK_ENDS:
            x = maxpool2x2(x)
    absmax["fc6"] = x.float().abs().amax()
    x = torch.relu_(conv2d(x, enc["fc6"]["weight"], enc["fc6"]["bias"]))
    absmax["fc7"] = x.float().abs().amax()
    return absmax


def quantize_fcn8s_params(params: dict, act_absmax: dict | None = None, *,
                          compute_dtype=torch.bfloat16) -> dict:
    """Full-model quantized tree from the port's fp32 master tree: the int8
    encoder (``quantize_vgg16_params``) and the decoder as the forward reads
    it (``bridge.cast_params`` in ``compute_dtype``). ``act_absmax``
    switches the activations from dynamic to calibrated static scales."""
    with torch.no_grad():
        return {"encoder_q": quantize_vgg16_params(params["encoder"], act_absmax),
                "decoder": bridge.cast_params({"decoder": params["decoder"]},
                                              compute_dtype)["decoder"]}


def apply_fcn8s_int8(qparams: dict, images: torch.Tensor, *, compute_dtype=torch.bfloat16,
                     normalize: bool = True, logits_dtype=torch.float32,
                     packed_final: bool = False, mesh=None) -> torch.Tensor:
    """Quantized end-to-end forward: the int8 encoder, then the decoder in
    ``compute_dtype``. The logits contract of ``models.fcn8s.apply_fcn8s``
    (NHWC, or the packed subpixel layout with ``packed_final``);
    ``normalize`` and ``mesh`` as in ``apply_vgg16_int8``."""
    pool3, pool4, fc7_out = apply_vgg16_int8(qparams["encoder_q"], images,
                                             compute_dtype=compute_dtype, normalize=normalize,
                                             mesh=mesh)
    return apply_fcn8s_decoder(qparams["decoder"], pool3, pool4, fc7_out,
                               compute_dtype=compute_dtype, logits_dtype=logits_dtype,
                               packed_final=packed_final)
