"""Parameter initializers. Port of ``fcn8s_tensorflow_tpu/models/initializers.py``.

Same distributions as the JAX package (He-normal encoder kernels, the
reference's truncated normal for the decoder, optional bilinear deconvs),
drawn from a ``torch.Generator``: the streams differ from ``jax.random``,
so tests hand both packages the same numpy weights instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def truncated_normal(gen: torch.Generator, shape, stddev: float) -> torch.Tensor:
    """TF-style truncated normal: a unit normal truncated at +/-2, scaled."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t * stddev


def he_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """He/Kaiming normal for an HWIO kernel (fan_in = kh * kw * in_ch)."""
    fan_in = math.prod(shape[:-1])
    return torch.randn(shape, generator=gen, dtype=torch.float32) * math.sqrt(2.0 / fan_in)


def bilinear_upsampling_kernel(kernel_size: int, channels: int) -> torch.Tensor:
    """HWIO (k, k, C, C) channelwise bilinear-upsampling kernel (the FCN
    paper's deconv init); off-diagonal channel pairs are zero."""
    factor = (kernel_size + 1) // 2
    center = factor - 1.0 if kernel_size % 2 == 1 else factor - 0.5
    og = np.ogrid[:kernel_size, :kernel_size]
    filt = (1 - abs(og[0] - center) / factor) * (1 - abs(og[1] - center) / factor)
    kernel = np.zeros((kernel_size, kernel_size, channels, channels), dtype=np.float32)
    for c in range(channels):
        kernel[:, :, c, c] = filt
    return torch.from_numpy(kernel)
