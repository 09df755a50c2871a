"""FCN-8s decoder and full model. Port of ``fcn8s_tensorflow_tpu/models/fcn8s.py``.

pool3 is scaled by 1e-4 and pool4 by 1e-2 (the paper's at-once trick),
three 1x1 score convs map the taps to ``num_classes`` channels, and the
subpixel deconvs (``ops/subpixel.py``) upsample 2x, 2x and 8x. The fcn16s
and fcn32s variants share the code path through ``_DECODER_SPECS``.
``decoder_l2_loss`` is the L2 term of the training loss.

Params are the port's tree (``bridge.to_port``); images are NHWC and logits
come back NHWC, like the JAX functions, while everything in between runs as
NCHW-shaped channels_last tensors.
"""

from __future__ import annotations

import torch

from ..ops.nn import conv2d, conv2d_transpose, nhwc
from ..ops.subpixel import conv2d_transpose_subpixel, subpixel_weight
from ..parallel.collectives import halo_exchange
from .initializers import bilinear_upsampling_kernel, truncated_normal
from .vgg16 import apply_vgg16, init_vgg16

POOL3_SCALE = 1e-4
POOL4_SCALE = 1e-2
STDDEV_1X1 = 0.001
STDDEV_DECONV = 0.01

# (name, kind, HWIO kernel shape); None is filled with num_classes, 'deconv'
# kernels are 2s x 2s for stride s
_DECODER_SPECS = {
    "fcn8s": [
        ("pool3_1x1", "conv", (1, 1, 256, None)),
        ("pool4_1x1", "conv", (1, 1, 512, None)),
        ("fc7_1x1", "conv", (1, 1, 4096, None)),
        ("fc7_deconv", "deconv", (4, 4, None, None)),
        ("fc7_pool4_deconv", "deconv", (4, 4, None, None)),
        ("fc7_pool4_pool3_deconv", "deconv", (16, 16, None, None)),
    ],
    "fcn16s": [
        ("pool4_1x1", "conv", (1, 1, 512, None)),
        ("fc7_1x1", "conv", (1, 1, 4096, None)),
        ("fc7_deconv", "deconv", (4, 4, None, None)),
        ("fc7_pool4_deconv", "deconv", (32, 32, None, None)),
    ],
    "fcn32s": [
        ("fc7_1x1", "conv", (1, 1, 4096, None)),
        ("fc7_deconv", "deconv", (64, 64, None, None)),
    ],
}


def init_fcn8s_decoder(gen: torch.Generator, num_classes: int, *,
                       bilinear_deconv_init: bool = False, pool3_ch: int = 256,
                       pool4_ch: int = 512, fc7_ch: int = 4096,
                       variant: str = "fcn8s") -> dict:
    """Fresh decoder params in the JAX tree layout (HWIO kernels)."""
    if variant not in _DECODER_SPECS:
        raise ValueError(f"variant must be one of {sorted(_DECODER_SPECS)}, got {variant!r}")
    tap_ch = {"pool3_1x1": pool3_ch, "pool4_1x1": pool4_ch, "fc7_1x1": fc7_ch}
    params = {}
    for name, kind, shape in _DECODER_SPECS[variant]:
        shape = tuple(num_classes if s is None else s for s in shape)
        if name in tap_ch:
            shape = (shape[0], shape[1], tap_ch[name], shape[3])
        if kind == "conv":
            kernel = truncated_normal(gen, shape, STDDEV_1X1)
        elif bilinear_deconv_init:
            kernel = bilinear_upsampling_kernel(shape[0], num_classes)
        else:
            kernel = truncated_normal(gen, shape, STDDEV_DECONV)
        params[name] = {"kernel": kernel, "bias": torch.zeros(num_classes)}
    return params


def init_fcn8s(gen: torch.Generator, num_classes: int, *, bilinear_deconv_init: bool = False,
               width_mult: float = 1.0, fc_channels: int | None = None,
               variant: str = "fcn8s") -> dict:
    """Full model params ``{'encoder', 'decoder'}`` in the JAX tree layout
    (fp32, CPU), drawn from ``gen``."""
    encoder = init_vgg16(gen, width_mult=width_mult, fc_channels=fc_channels)
    decoder = init_fcn8s_decoder(
        gen, num_classes, bilinear_deconv_init=bilinear_deconv_init,
        pool3_ch=encoder["conv3_3"]["kernel"].shape[-1],
        pool4_ch=encoder["conv4_3"]["kernel"].shape[-1],
        fc7_ch=encoder["fc7"]["kernel"].shape[-1], variant=variant)
    return {"encoder": encoder, "decoder": decoder}


def decoder_variant(decoder_params: dict) -> str:
    """The FCN variant of a decoder tree (its key set is unambiguous)."""
    if "fc7_pool4_pool3_deconv" in decoder_params:
        return "fcn8s"
    if "fc7_pool4_deconv" in decoder_params:
        return "fcn16s"
    return "fcn32s"


def apply_fcn8s_decoder(params: dict, pool3, pool4, fc7_out, *, compute_dtype=torch.bfloat16,
                        logits_dtype=torch.float32, subpixel: bool = True,
                        packed_final: bool = False, variant: str | None = None,
                        split=None) -> torch.Tensor:
    """Decode NCHW channels_last taps to NHWC logits ``(N, H, W, C)`` in
    ``logits_dtype``, or with ``packed_final`` the final deconv's packed
    subpixel layout ``(N, H/s, W/s, s, s, C)``. ``variant`` 'fcn8s',
    'fcn16s' or 'fcn32s' (None: the one the decoder tree holds).

    ``params`` is the decoder of ``bridge.cast_params`` (deconvs in their
    subpixel form) or of the master tree (deconvs as ``kernel``/``bias``,
    the subpixel form derived here). ``subpixel=False`` runs each deconv
    that is not packed as JAX's input-dilated convolution
    (``ops.nn.conv2d_transpose``), which needs the master ``kernel``.

    ``split`` (a ``parallel.mesh.WidthSplit``): the taps are this rank's
    columns of a width split over 'model', and so are the logits. The 1x1
    score convs and the skip adds are local; each subpixel deconv is a 3x3
    conv at the low resolution, run on its input extended by a one-column
    halo. The input-dilated form (``subpixel=False``) does not take a
    split."""
    if split is not None and not subpixel:
        raise ValueError("a width split runs the deconvs in their subpixel form "
                         "(subpixel=True): their halo is one low-resolution column")
    p = params
    variant = decoder_variant(params) if variant is None else variant

    def score(name, x, scale=None):
        x = x.to(compute_dtype)
        if scale is not None:
            x = x * torch.tensor(scale, dtype=x.dtype)  # the scale rounded to x's dtype, as in JAX
        return conv2d(x, p[name]["weight"], p[name]["bias"])

    def deconv(x, name, stride, packed=False):
        layer = p[name]
        if not (subpixel or packed):
            if "kernel" not in layer:
                raise ValueError("subpixel=False needs the deconv kernels of the master "
                                 "params, not the subpixel form of bridge.cast_params")
            return conv2d_transpose(x, layer["kernel"], layer["bias"], strides=(stride, stride))
        if "subpixel_weight" in layer:
            w, b = layer["subpixel_weight"], layer["subpixel_bias"]
        else:
            w, b = subpixel_weight(layer["kernel"], layer["bias"], stride)
        if split is not None:
            x = halo_exchange(x, 1, split)
        return conv2d_transpose_subpixel(x, w, b, stride=stride, packed=packed,
                                         halo=split is not None)

    def finish(x, name, stride):
        out = deconv(x, name, stride, packed=packed_final)
        return (out if packed_final else nhwc(out)).to(logits_dtype)

    fc7_score = score("fc7_1x1", fc7_out)
    if variant == "fcn32s":
        return finish(fc7_score, "fc7_deconv", 32)
    x = deconv(fc7_score, "fc7_deconv", 2) + score("pool4_1x1", pool4, POOL4_SCALE)
    if variant == "fcn16s":
        return finish(x, "fc7_pool4_deconv", 16)
    x = deconv(x, "fc7_pool4_deconv", 2) + score("pool3_1x1", pool3, POOL3_SCALE)
    return finish(x, "fc7_pool4_pool3_deconv", 8)


def apply_fcn8s(params: dict, images: torch.Tensor, *, keep_prob: float = 1.0,
                generator: torch.Generator | None = None, deterministic: bool = True,
                compute_dtype=torch.bfloat16, normalize: bool = True,
                logits_dtype=torch.float32, remat: bool = False, packed_final: bool = False,
                variant: str | None = None, mesh=None, tensor_parallel: bool = False,
                split=None) -> torch.Tensor:
    """End-to-end forward: NHWC images (H, W divisible by 32) -> NHWC
    logits, as ``apply_fcn8s`` of the JAX package. ``params`` are what
    ``bridge.cast_params`` gives. ``keep_prob``/``generator``/
    ``deterministic``/``normalize``/``remat`` and ``mesh``/
    ``tensor_parallel`` are the encoder's (``apply_vgg16``);
    ``packed_final`` and ``variant`` the decoder's
    (``apply_fcn8s_decoder``). The decoder is replicated on a mesh.
    ``split``: ``images`` and the logits are this rank's columns of a width
    split over 'model' (both halves of the model take it)."""
    pool3, pool4, fc7_out = apply_vgg16(params["encoder"], images, keep_prob=keep_prob,
                                        generator=generator, deterministic=deterministic,
                                        compute_dtype=compute_dtype, normalize=normalize,
                                        remat=remat, mesh=mesh, tensor_parallel=tensor_parallel,
                                        split=split)
    return apply_fcn8s_decoder(params["decoder"], pool3, pool4, fc7_out,
                               compute_dtype=compute_dtype, logits_dtype=logits_dtype,
                               packed_final=packed_final, variant=variant, split=split)


def decoder_l2_loss(decoder_params: dict) -> torch.Tensor:
    """TF-style L2 over the decoder's master kernels, biases exempt:
    ``sum(w**2) / 2`` per kernel, summed in fp32 (the caller multiplies the
    rate in). Every FCN variant's kernel set is covered; the sum of squares
    does not depend on the port's OIHW layout of the 1x1 convs. A layer
    without a kernel (SegFormer's BatchNorm) adds nothing."""
    kernels = (layer["kernel"] if "kernel" in layer else layer["weight"]
               for layer in decoder_params.values() if "kernel" in layer or "weight" in layer)
    return sum(0.5 * torch.sum(w.float() * w.float()) for w in kernels)
