"""Core NN ops: SAME convolution and the plain 2x2 max pool.

Port of ``fcn8s_tensorflow_tpu/ops/nn.py``. Activations inside the port are
NCHW-shaped tensors in ``torch.channels_last`` memory, which is the JAX
package's NHWC byte layout: cuDNN takes it directly, and the pool kernel
(``ops/pool.py``) reads it as NHWC. Kernels are OIHW (the bridge converts
JAX's HWIO). ``nhwc``/``nchw`` switch between the two logical views of the
same memory without a copy.

The transposed convolution is not ported: every deconv of the model runs
through ``ops/subpixel.py``, and ``nn.ConvTranspose2d`` would be wrong anyway
(its kernel is the spatial flip of JAX's lhs-dilated cross-correlation).
Dropout waits for the training path.
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


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 SAME convolution, NCHW x OIHW -> NCHW, in ``x``'s dtype.

    Every kernel of the model is odd (3x3, 7x7) or 1x1, so TF-SAME padding is
    the symmetric ``k // 2``. The weight is cast to ``x.dtype`` as JAX's
    ``conv2d`` does; callers that hold weights already in the compute dtype
    (``bridge.cast_params``) make that a no-op. The bias is added inside the
    convolution's fp32 accumulator instead of after the rounding to the
    compute dtype: exact in fp32, within one bf16 rounding otherwise."""
    kh, kw = weight.shape[2], weight.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"conv2d: SAME padding here needs odd kernels, got {kh}x{kw}")
    return F.conv2d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    padding=(kh // 2, kw // 2))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool with SAME padding on NCHW: odd dims round up
    (``ceil_mode``), matching ``lax.reduce_window(..., padding='SAME')``.
    NaN propagates like ``lax.max``. The plain twin of the K4f kernel."""
    return F.max_pool2d(x, kernel_size=2, stride=2, ceil_mode=True)
