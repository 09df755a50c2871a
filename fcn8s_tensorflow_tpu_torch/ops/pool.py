"""2x2/s2 max pool over NHWC memory: the K4f, K4a and K4b CUDA kernels, their
plain twins, and the autograd pair.

Port of ``fcn8s_tensorflow_tpu/ops/pallas_pool.py``:

* ``maxpool2x2_nhwc`` (K4f) replaces ``_fwd_only_kernel``, the primal of
  ``max_pool_2x2_pallas``; its plain twin is ``ops.nn.max_pool_2x2``. It is
  a registered ``torch.library`` op (``fcn8s_torch::maxpool2x2_nhwc``,
  its CPU implementation the twin, its CUDA one the kernel, with a fake
  for tracing), so that an exported graph holds the kernel;
* ``maxpool2x2_code_nhwc`` (K4a) replaces ``_fwd_kernel``, the VJP forward:
  y plus a uint8 first-max code (the TPU stored the code in the input
  dtype only because Mosaic rejected an int8 relayout);
* ``maxpool2x2_bwd_nhwc`` (K4b) replaces ``_bwd_kernel``: dy routed to the
  coded position, from the code alone, never re-reading x;
* ``MaxPool2x2`` is the ``torch.autograd.Function`` around K4a/K4b, the
  counterpart of ``max_pool_2x2_pallas``'s custom VJP, and ``maxpool2x2``
  picks it under autograd and K4f otherwise.

On the TPU the kernels lost to the relayouts around them; on the card the
activations are already NHWC (channels_last), so each is a plain
memory-bound pass. All three share ``csrc/maxpool2x2.cu``. Every wrapper
takes its plain twin for a CPU tensor and launches its kernel for a CUDA
tensor, raising on anything the kernel does not take; each counts its
launches in ``<wrapper>.launches``. K4a/K4b stay an
``autograd.Function``: an exported artifact is inference only.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels import build
from .nn import max_pool_2x2

_CL = torch.channels_last


def _check_pool_input(x: torch.Tensor, name: str) -> None:
    kernels.require(x.dim() == 4, f"{name}: expected NCHW, got shape {tuple(x.shape)}")
    kernels.require(x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0,
                    f"{name}: H and W must be even, got {x.shape[2]}x{x.shape[3]}")
    kernels.require(x.dtype in (torch.bfloat16, torch.float32),
                    f"{name}: bf16 or fp32 only, got {x.dtype}")
    kernels.require(x.is_contiguous(memory_format=_CL),
                    f"{name}: input must be channels_last (NHWC memory)")


# ---------------------------------------------------------------------------
# K4f: forward only
# ---------------------------------------------------------------------------


def maxpool2x2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2/s2 max pool of an NCHW-shaped tensor: the registered op
    ``torch.ops.fcn8s_torch.maxpool2x2_nhwc``, so that ``torch.export``
    records the kernel itself (``engine/export.py``).

    A CPU tensor takes the plain twin (SAME semantics, odd dims allowed). A
    CUDA tensor takes the K4f kernel, which needs channels_last memory,
    bf16 or fp32, and even H and W (every VGG pool input is even, since the
    facade pads images to multiples of 32); anything else raises. The
    output is channels_last either way. Counts each kernel launch in
    ``maxpool2x2_nhwc.launches``.

    The op's fake answers a ``meta`` tensor's call, so a meta tensor is
    checked here, before the op, and raises as the kernel's wrapper does
    (a CUDA tensor is checked inside the op)."""
    if x.device.type == "meta":
        _check_pool_input(x, "maxpool2x2_nhwc")
        kernels.require_cuda(x)
    return torch.ops.fcn8s_torch.maxpool2x2_nhwc(x)


maxpool2x2_nhwc.launches = 0


@torch.library.custom_op("fcn8s_torch::maxpool2x2_nhwc", mutates_args=())
def _maxpool2x2_op(x: torch.Tensor) -> torch.Tensor:
    raise ValueError(f"maxpool2x2_nhwc: no kernel for a {x.device.type} tensor")


@_maxpool2x2_op.register_kernel("cpu")
def _maxpool2x2_cpu(x: torch.Tensor) -> torch.Tensor:
    return max_pool_2x2(x).contiguous(memory_format=_CL)


@_maxpool2x2_op.register_kernel("cuda")
def _maxpool2x2_cuda(x: torch.Tensor) -> torch.Tensor:
    _check_pool_input(x, "maxpool2x2_nhwc")
    dev = kernels.require_cuda(x)
    n, c, h, w = x.shape
    y = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype, device=dev, memory_format=_CL)
    if y.numel() == 0:
        return y
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_maxpool2x2_nhwc(
            x.data_ptr(), y.data_ptr(), n, h, w, c, kernels.dtype_code(x),
            kernels.stream_handle(dev))
    build.check(rc, "maxpool2x2_nhwc")
    maxpool2x2_nhwc.launches += 1
    return y


@_maxpool2x2_op.register_fake
def _maxpool2x2_fake(x: torch.Tensor) -> torch.Tensor:
    """The output's metadata while tracing: channels_last, as both
    implementations write it (later ops of an exported graph assume these
    strides). ``(d + 1) // 2`` is the twin's SAME size and the kernel's
    ``d // 2`` for the even dims it takes."""
    n, c, h, w = x.shape
    return torch.empty((n, c, (h + 1) // 2, (w + 1) // 2), dtype=x.dtype, device=x.device,
                       memory_format=_CL)


# ---------------------------------------------------------------------------
# K4a: forward with the first-max code
# ---------------------------------------------------------------------------


def maxpool2x2_code_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K4a on an NCHW tensor with even H and W: the four window
    taps in order (r0,w0),(r0,w1),(r1,w0),(r1,w1), a running max that a tap
    replaces when it is greater or NaN, and the uint8 index of the tap that
    last replaced it (the first maximum). Both outputs channels_last."""
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"maxpool2x2_code: H and W must be even, got {tuple(x.shape)}")
    taps = (x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2])
    y = taps[0]
    code = torch.zeros(y.shape, dtype=torch.uint8, device=x.device)
    for k in (1, 2, 3):
        take = (taps[k] > y) | torch.isnan(taps[k])
        y = torch.where(take, taps[k], y)
        code = code.masked_fill(take, k)
    return y.contiguous(memory_format=_CL), code.contiguous(memory_format=_CL)


def maxpool2x2_code_nhwc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K4a: ``(y, code)`` of the 2x2/s2 max pool of an NCHW-shaped tensor,
    ``code`` uint8 in 0..3 (the window position of the first maximum), both
    channels_last. A CPU tensor takes the plain twin; a CUDA tensor takes
    the kernel under K4f's conditions or raises. Counts launches in
    ``maxpool2x2_code_nhwc.launches``."""
    if x.device.type == "cpu":
        return maxpool2x2_code_plain(x)
    _check_pool_input(x, "maxpool2x2_code_nhwc")
    dev = kernels.require_cuda(x)
    n, c, h, w = x.shape
    y = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype, device=dev, memory_format=_CL)
    code = torch.empty(y.shape, dtype=torch.uint8, device=dev, memory_format=_CL)
    if y.numel() == 0:
        return y, code
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_maxpool2x2_code_nhwc(
            x.data_ptr(), y.data_ptr(), code.data_ptr(), n, h, w, c, kernels.dtype_code(x),
            kernels.stream_handle(dev))
    build.check(rc, "maxpool2x2_code_nhwc")
    maxpool2x2_code_nhwc.launches += 1
    return y, code


maxpool2x2_code_nhwc.launches = 0


# ---------------------------------------------------------------------------
# K4b: backward from the code
# ---------------------------------------------------------------------------


def maxpool2x2_bwd_plain(dy: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4b: ``torch.where`` on the four code values, then the
    interleave of the four taps into the (N, C, 2H, 2W) gradient
    (channels_last); every position the code does not name gets zero."""
    n, c, ho, wo = dy.shape
    zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
    taps = torch.stack([torch.where(code == k, dy, zero) for k in range(4)], dim=-1)
    dx = taps.view(n, c, ho, wo, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(n, c, 2 * ho, 2 * wo)
    return dx.contiguous(memory_format=_CL)


def maxpool2x2_bwd_nhwc(dy: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """K4b: the input gradient (N, C, 2H, 2W) of the pool from the output
    gradient ``dy`` and K4a's ``code``, both (N, C, H, W) channels_last. A
    CPU tensor takes the plain twin; a CUDA ``dy`` must be channels_last,
    bf16 or fp32, with a uint8 channels_last code of its shape, or the
    wrapper raises. Counts launches in ``maxpool2x2_bwd_nhwc.launches``."""
    if dy.device.type == "cpu":
        return maxpool2x2_bwd_plain(dy, code)
    name = "maxpool2x2_bwd_nhwc"
    kernels.require(dy.dim() == 4, f"{name}: expected NCHW, got shape {tuple(dy.shape)}")
    kernels.require(dy.dtype in (torch.bfloat16, torch.float32),
                    f"{name}: bf16 or fp32 only, got {dy.dtype}")
    kernels.require(dy.is_contiguous(memory_format=_CL), f"{name}: dy must be channels_last")
    kernels.require(code.dtype == torch.uint8 and code.shape == dy.shape
                    and code.is_contiguous(memory_format=_CL),
                    f"{name}: code must be a channels_last uint8 tensor of dy's shape")
    dev = kernels.require_cuda(dy, code)
    n, c, ho, wo = dy.shape
    dx = torch.empty((n, c, 2 * ho, 2 * wo), dtype=dy.dtype, device=dev, memory_format=_CL)
    if dx.numel() == 0:
        return dx
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_maxpool2x2_bwd_nhwc(
            dy.data_ptr(), code.data_ptr(), dx.data_ptr(), n, 2 * ho, 2 * wo, c,
            kernels.dtype_code(dy), kernels.stream_handle(dev))
    build.check(rc, name)
    maxpool2x2_bwd_nhwc.launches += 1
    return dx


maxpool2x2_bwd_nhwc.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class MaxPool2x2(torch.autograd.Function):
    """The pool under autograd: K4a forward, which saves only the uint8
    code, and K4b backward. The gradient is bit-identical to JAX's
    select-and-scatter and to ``F.max_pool2d``'s, ties included.

    autograd may hand the backward a ``dy`` that is not channels_last (where
    a pool output feeds two consumers, it sums their gradients). A CUDA
    ``dy`` in another layout is converted explicitly, and each conversion
    counts in ``MaxPool2x2.dy_conversions``; the kernel still runs on it."""

    dy_conversions = 0

    @staticmethod
    def forward(ctx, x):
        y, code = maxpool2x2_code_nhwc(x)
        ctx.save_for_backward(code)
        return y

    @staticmethod
    def backward(ctx, dy):
        (code,) = ctx.saved_tensors
        if dy.device.type == "cuda" and not dy.is_contiguous(memory_format=_CL):
            dy = dy.contiguous(memory_format=_CL)
            MaxPool2x2.dy_conversions += 1
        return maxpool2x2_bwd_nhwc(dy, code)


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """The VGG pool: the K4a/K4b pair when autograd records ``x``, the
    primal-only K4f otherwise (no code is written under ``no_grad`` or
    ``inference_mode``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPool2x2.apply(x)
    return maxpool2x2_nhwc(x)
