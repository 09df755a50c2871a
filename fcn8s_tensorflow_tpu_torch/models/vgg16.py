"""Convolutionalized VGG-16 encoder. Port of ``fcn8s_tensorflow_tpu/models/vgg16.py``.

13 conv3x3+ReLU layers in 5 blocks, each block closed by a 2x2/s2 max pool
through the K4f kernel (``ops/pool.py``), then fc6 as a 7x7 SAME conv and
fc7 as a 1x1 conv, each with ReLU. Exposes (pool3, pool4, fc7) at strides
8/16/32. Dropout (``keep_prob < 1``) and remat come with the training path;
this forward is JAX's ``deterministic=True`` one.
"""

from __future__ import annotations

import torch

from ..ops.nn import conv2d, nchw
from ..ops.pool import maxpool2x2_nhwc
from .initializers import he_normal

# (name, in_ch, out_ch) per conv layer; a pool follows each block's last conv
VGG16_CONV_LAYERS = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
]
_BLOCK_ENDS = {"conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"}

FC6_KERNEL = (7, 7, 512, 4096)
FC7_KERNEL = (1, 1, 4096, 4096)

VGG_MEAN_RGB = (123.68, 116.779, 103.939)


def init_vgg16(gen: torch.Generator, *, width_mult: float = 1.0,
               fc_channels: int | None = None) -> dict:
    """Fresh encoder params in the JAX tree layout (HWIO kernels, zero
    biases, fp32, CPU); ``bridge.to_port`` turns them into port params.
    ``width_mult``/``fc_channels`` scale the widths as in the JAX package."""

    def scale(ch: int) -> int:
        return max(8, int(ch * width_mult)) if width_mult != 1.0 else ch

    fc_ch = fc_channels if fc_channels is not None else scale(FC6_KERNEL[-1])
    params = {}
    for name, in_ch, out_ch in VGG16_CONV_LAYERS:
        in_ch = 3 if in_ch == 3 else scale(in_ch)
        params[name] = {"kernel": he_normal(gen, (3, 3, in_ch, scale(out_ch))),
                        "bias": torch.zeros(scale(out_ch))}
    params["fc6"] = {"kernel": he_normal(gen, (7, 7, scale(FC6_KERNEL[2]), fc_ch)),
                     "bias": torch.zeros(fc_ch)}
    params["fc7"] = {"kernel": he_normal(gen, (1, 1, fc_ch, fc_ch)),
                     "bias": torch.zeros(fc_ch)}
    return params


def apply_vgg16(params: dict, images: torch.Tensor, *, compute_dtype=torch.bfloat16):
    """Run the encoder on NHWC ``images`` (float or uint8 in [0, 255], H and
    W divisible by 32), as ``apply_vgg16`` of the JAX package does at
    ``deterministic=True``: mean-RGB subtraction in fp32, then the cast to
    ``compute_dtype``. Returns ``(pool3, pool4, fc7)`` as NCHW-shaped
    channels_last tensors (NHWC memory) in ``compute_dtype``."""
    x = images.float() - torch.tensor(VGG_MEAN_RGB, dtype=torch.float32, device=images.device)
    x = nchw(x.to(compute_dtype).contiguous())
    pool3 = pool4 = None
    for name, _, _ in VGG16_CONV_LAYERS:
        layer = params[name]
        x = torch.relu_(conv2d(x, layer["weight"], layer["bias"]))
        if name in _BLOCK_ENDS:
            x = maxpool2x2_nhwc(x)
            if name == "conv3_3":
                pool3 = x
            elif name == "conv4_3":
                pool4 = x
    x = torch.relu_(conv2d(x, params["fc6"]["weight"], params["fc6"]["bias"]))
    x = torch.relu_(conv2d(x, params["fc7"]["weight"], params["fc7"]["bias"]))
    return pool3, pool4, x
