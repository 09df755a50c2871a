"""2x2/s2 max pool over NHWC memory: the K4f CUDA kernel and its dispatch.

Port of the primal-only path of ``fcn8s_tensorflow_tpu/ops/pallas_pool.py``
(``_fwd_only_kernel`` via ``_fwd_impl(with_idx=False)``, the primal of
``max_pool_2x2_pallas``). On the TPU the kernel lost to the relayouts around
it; on the card the activations are already NHWC (channels_last), so it is
a plain memory-bound pass and serves all five VGG-16 pools. The kernel is
``csrc/maxpool2x2.cu``; its plain twin is ``ops.nn.max_pool_2x2``. The
argmax-code forward and the backward (K4a/K4b) come with the training path.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels import build
from .nn import max_pool_2x2


def maxpool2x2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2/s2 max pool of an NCHW-shaped tensor.

    A CPU tensor takes the plain twin (SAME semantics, odd dims allowed). A
    CUDA tensor takes the K4f kernel, which needs channels_last memory,
    bf16 or fp32, and even H and W (every VGG pool input is even, since the
    facade pads images to multiples of 32); anything else raises. Counts
    each kernel launch in ``maxpool2x2_nhwc.launches``."""
    if x.device.type == "cpu":
        return max_pool_2x2(x)
    kernels.require(x.dim() == 4, f"maxpool2x2_nhwc: expected NCHW, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    kernels.require(h % 2 == 0 and w % 2 == 0,
                    f"maxpool2x2_nhwc: H and W must be even, got {h}x{w}")
    kernels.require(x.dtype in (torch.bfloat16, torch.float32),
                    f"maxpool2x2_nhwc: bf16 or fp32 only, got {x.dtype}")
    kernels.require(x.is_contiguous(memory_format=torch.channels_last),
                    "maxpool2x2_nhwc: input must be channels_last (NHWC memory)")
    dev = kernels.require_cuda(x)
    y = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype, device=dev,
                    memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_maxpool2x2_nhwc(
            x.data_ptr(), y.data_ptr(), n, h, w, c, kernels.dtype_code(x),
            kernels.stream_handle(dev))
    build.check(rc, "maxpool2x2_nhwc")
    maxpool2x2_nhwc.launches += 1
    return y


maxpool2x2_nhwc.launches = 0
