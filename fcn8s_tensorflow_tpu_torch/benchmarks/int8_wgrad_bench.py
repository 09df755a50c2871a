"""Buy-or-bury: an int8 weight-gradient (wgrad) convolution for training.
Port of ``benchmarks/int8_wgrad_bench.py``.

fc6's wgrad, 7x7x512 -> 4096 at (8, 32, 16, 512) (batch 8 at 1024x512),
is the train step's largest single contraction. This script measures, in
one process on the card:

  1. the bf16 wgrad through autograd of ``F.conv2d`` (cuDNN, the backward
     the train step runs),
  2. the same wgrad called directly (``torch.nn.grad.conv2d_weight``),
  3. int8 with in-step dynamic per-tensor quantization,
  4. int8 on pre-quantized operands (the upper bound, no quantization),

and each dW's relative error against an fp32 reference (TF32 off for both
cuDNN and matmul).

The int8 wgrad is the same library route as
``ops.quantize.conv2d_int8_im2col``: an explicit im2col of X (the SAME 7x7
window, K order (ky, kx, ci)) and one ``torch._int_mm``:
dW = X_col^T (49*512 x 4096 = N*H*W) x dY (4096 x 4096), int32
accumulation, dequantized by ``sx * sy``. ``_int_mm`` wants more than 16
rows and K, N multiples of 8, which hold. Each scale's ``/ 127`` is a
multiplication by fp32(1/127), as jitted JAX compiles it.

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.int8_wgrad_bench [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..examples import add_device_argument, resolve
from . import sync

N, H, W, CI, CO, K = 8, 32, 16, 512, 4096, 7
PAD = K // 2
INT8_MAX = 127.0
_INV_INT8_MAX = float(np.float32(1.0) / np.float32(INT8_MAX))
ITERS = 50


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as an NCHW-shaped channels_last view."""
    return x.permute(0, 3, 1, 2)


def wgrad_via_grad(x: torch.Tensor, dy: torch.Tensor, w0: torch.Tensor):
    """The train step's form: a function computing the forward conv's
    gradient for its kernel (OIHW) by autograd, the forward recorded once
    (only ``w`` requires grad, so only the wgrad runs); ``x``/``dy`` NHWC."""
    w = w0.detach().requires_grad_()
    y = F.conv2d(_nchw(x), w, padding=PAD)
    g = _nchw(dy)
    return lambda: torch.autograd.grad(y, w, g, retain_graph=True)[0]


def wgrad_conv(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The wgrad called directly (OIHW dW)."""
    return torch.nn.grad.conv2d_weight(_nchw(x), (CO, CI, K, K), _nchw(dy), padding=PAD)


def quantize(t: torch.Tensor):
    """Per-tensor symmetric int8: (t_q, scale), scale = max|t| * fp32(1/127)."""
    s = t.abs().amax().float() * _INV_INT8_MAX
    return torch.clamp(torch.round(t.float() / s), -INT8_MAX, INT8_MAX).to(torch.int8), s


def int8_wgrad_acc(xq: torch.Tensor, yq: torch.Tensor) -> torch.Tensor:
    """int32 dW (K, K, CI, CO), HWIO, of NHWC int8 ``xq``/``yq``: one
    ``torch._int_mm`` of the im2col's transpose and dY."""
    from ..ops.quantize import im2col_nhwc

    n, h, w, ci = xq.shape
    cols = im2col_nhwc(xq, K, K, K * K * ci)  # (N*H*W, K*K*CI)
    acc = torch._int_mm(cols.t().contiguous(), yq.reshape(n * h * w, -1))
    return acc.reshape(K, K, ci, -1)


def int8_wgrad_dynamic(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The deployable form: per-tensor dynamic scales computed in-step;
    fp32 HWIO dW."""
    xq, sx = quantize(x)
    yq, sy = quantize(dy)
    return int8_wgrad_acc(xq, yq).float() * (sx * sy)


def int8_wgrad_prequant(xq: torch.Tensor, yq: torch.Tensor, sxy: torch.Tensor) -> torch.Tensor:
    """The upper bound: operands already int8."""
    return int8_wgrad_acc(xq, yq).float() * sxy


def _time(dev, fn, *args, iters: int = ITERS) -> float:
    for _ in range(3):  # first use (cuDNN's plan, cuBLASLt's heuristics), then warm
        fn(*args)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync(dev)
    return (time.perf_counter() - t0) / iters * 1e3


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve(args.device)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N, H, W, CI)).astype(np.float32)).to(
        dev, torch.bfloat16)
    dy = torch.from_numpy((rng.normal(size=(N, H, W, CO)) * 1e-3).astype(np.float32)).to(
        dev, torch.bfloat16)
    w0 = torch.zeros((CO, CI, K, K), dtype=torch.bfloat16, device=dev).contiguous(
        memory_format=torch.channels_last)

    flops = 2 * N * H * W * CI * CO * K * K
    print(f"wgrad contraction: {flops / 1e9:.0f} GFLOP")
    t_grad = _time(dev, wgrad_via_grad(x, dy, w0))
    print(f"bf16 wgrad (autograd): {t_grad:.2f} ms ({flops / t_grad / 1e9:.1f} TFLOPs)")
    t_conv = _time(dev, wgrad_conv, x, dy)
    print(f"bf16 wgrad (direct conv2d_weight): {t_conv:.2f} ms")
    t_dyn = _time(dev, int8_wgrad_dynamic, x, dy)
    print(f"int8 wgrad (dynamic quant): {t_dyn:.2f} ms ({(t_dyn / t_grad - 1) * 100:+.0f}% vs bf16)")
    xq, sx = quantize(x)
    yq, sy = quantize(dy)
    t_pre = _time(dev, int8_wgrad_prequant, xq, yq, sx * sy)
    print(f"int8 wgrad (pre-quantized upper bound): {t_pre:.2f} ms "
          f"({(t_pre / t_grad - 1) * 100:+.0f}% vs bf16)")

    # accuracy against fp32 (HWIO, as the int8 dW)
    with _no_tf32():
        ref = wgrad_conv(x.float(), dy.float()).permute(2, 3, 1, 0).double()
    dq = int8_wgrad_dynamic(x, dy).double()
    bf = wgrad_conv(x, dy).permute(2, 3, 1, 0).double()

    def rel(a):
        return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref))

    e_int8, e_bf16 = rel(dq), rel(bf)
    print(f"dW relative error: int8 {e_int8:.2e}, bf16 {e_bf16:.2e}")
    return {"gflop": flops / 1e9, "bf16_grad_ms": t_grad, "bf16_direct_ms": t_conv,
            "int8_dynamic_ms": t_dyn, "int8_prequant_ms": t_pre, "dw_rel_err_int8": e_int8,
            "dw_rel_err_bf16": e_bf16}


if __name__ == "__main__":
    main()
