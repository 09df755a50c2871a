"""A/B: the hand max-pool pair (K4a forward + K4b backward) against
``F.max_pool2d`` at pool1. Port of ``benchmarks/pallas_pool_bench.py``
(whose name it keeps; the JAX script timed its Pallas pair, the port times
its CUDA pair in ``csrc/maxpool2x2.cu``).

Measures, in one process:

1. the standalone forward + backward pair at pool1's shape
   (8, 1024, 512, 64) bf16 channels_last: the hand pair through its
   autograd Function (``ops/pool.py``: K4a writes the max and a uint8
   first-max code, K4b routes dy by it) against
   ``F.max_pool2d(return_indices=True)`` and its backward;
2. the full train step as it is (the hand pair at every pool) against the
   step with pool1 alone swapped to the library pool (monkeypatched here,
   as the JAX script swaps its pool1; the package has no switch).

The JAX script's default step ran XLA's pool and its A/B swapped the Pallas
pair in; the port's default is the hand pair, so its A/B runs the other
way: ``step_delta_ms = step_library_pool1_ms - step_default_ms``.

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.pallas_pool_bench [--device cuda]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..examples import add_device_argument, resolve
from . import fresh_state, log, sync, to_device

N, H, W, C = 8, 1024, 512, 64
NUM_CLASSES = 20
WARMUP, ITERS = 3, 10


def kernel_pair(x: torch.Tensor, dy: torch.Tensor):
    """(y, dx) through the hand pair; ``x`` NCHW-shaped channels_last."""
    from ..ops.pool import maxpool2x2

    x = x.detach().requires_grad_()
    y = maxpool2x2(x)
    (dx,) = torch.autograd.grad(y, x, dy)
    return y.detach(), dx


def library_pair(x: torch.Tensor, dy: torch.Tensor):
    """(y, dx) through ``F.max_pool2d(return_indices=True)`` and autograd."""
    x = x.detach().requires_grad_()
    y, _ = F.max_pool2d(x, 2, 2, return_indices=True)
    (dx,) = torch.autograd.grad(y, x, dy)
    return y.detach(), dx


@contextlib.contextmanager
def library_pool1():
    """The VGG forward with pool1 (the only 64-channel pool) on
    ``F.max_pool2d``, every other pool on the hand kernels."""
    from ..models import vgg16 as vgg16_mod

    orig = vgg16_mod.maxpool2x2

    def hybrid_pool(x):
        if x.shape[1] == 64:
            return F.max_pool2d(x, 2, 2)
        return orig(x)

    vgg16_mod.maxpool2x2 = hybrid_pool
    try:
        yield
    finally:
        vgg16_mod.maxpool2x2 = orig


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve(args.device)

    from ..ops.nn import nchw
    from ..parallel.steps import make_optimizer, train_step

    log(f"device: {dev}")
    rng = np.random.default_rng(0)
    x_host = rng.standard_normal((N, H, W, C)).astype(np.float32)
    dy_host = rng.standard_normal((N, H // 2, W // 2, C)).astype(np.float32)
    results = {}

    # ---- standalone pair ----
    def pair_time(pair, tag):
        x, dy = (nchw(t.to(torch.bfloat16)) for t in to_device(dev, x_host, dy_host))
        for _ in range(WARMUP):
            pair(x, dy)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            pair(x, dy)
        sync(dev)
        dt = (time.perf_counter() - t0) / ITERS * 1e3
        log(f"standalone {tag}: {dt:.2f} ms fwd+bwd")
        return dt

    results["standalone_library_ms"] = round(pair_time(library_pair, "library"), 2)
    results["standalone_kernel_ms"] = round(pair_time(kernel_pair, "kernel"), 2)

    # ---- full train step A/B ----
    optimizer = make_optimizer()
    im, lb, mk = to_device(dev, rng.integers(0, 255, (N, H, W, 3), np.uint8),
                           rng.integers(0, NUM_CLASSES, (N, H, W), np.uint8),
                           np.ones((N,), np.float32))

    def step_time(tag):
        state = fresh_state(NUM_CLASSES, dev, optimizer)
        for _ in range(WARMUP):
            state, loss = train_step(state, im, lb, mk, 1, 1e-4, 0.0, 0.5, optimizer=optimizer,
                                     num_classes=NUM_CLASSES)
        loss.item()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            state, loss = train_step(state, im, lb, mk, 1, 1e-4, 0.0, 0.5, optimizer=optimizer,
                                     num_classes=NUM_CLASSES)
        loss.item()
        dt = (time.perf_counter() - t0) / ITERS * 1e3
        log(f"train step [{tag}]: {dt:.1f} ms")
        return dt

    results["step_default_ms"] = round(step_time("hand pools"), 1)
    with library_pool1():
        results["step_library_pool1_ms"] = round(step_time("library pool1"), 1)
    results["step_delta_ms"] = round(
        results["step_library_pool1_ms"] - results["step_default_ms"], 1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
