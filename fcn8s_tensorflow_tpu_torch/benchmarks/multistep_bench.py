"""A/B: one train step per dispatch against S steps in one dispatch. Port
of ``benchmarks/multistep_bench.py``.

The JAX script timed ``compile_train_step``'s executable against
``compile_multi_train_step``'s ``lax.scan`` of S steps; on the TPU, XLA's
async dispatch hid the host and the two were within 0.1%. The port's eager
step dispatches several hundred ops a step from Python, so this times three
modes in one process, at the JAX script's shape (8 x 1024x512, full-width
FCN-8s, 20 classes, TF1 Adam, lr 1e-4, l2 0, keep_prob 0.5, one batch
resident on the device):

* ``eager``: ``parallel.steps.train_step``;
* ``single``: ``compile_train_step``, one CUDA-graph replay a step;
* ``multi``: ``compile_multi_train_step(steps_per_dispatch=S)``, one
  replay for S steps, on the batch stacked S times.

The three share one state, as the JAX script's two modes do. After an
interleaved warm-up (which captures both graphs), each mode re-enters its
steady state, then ``total_steps`` steps are timed on the host clock, the
last loss read back (a hard sync): ms a step. Then S more steps (one
dispatch of ``multi``) run under ``torch.profiler`` for the device busy
share (``utils.profiling.device_busy``; None where the profiler sees no
device). Semantics as in JAX: the S steps of a dispatch share (lr, l2,
keep_prob), and each draws its own dropout masks (those of its
``state.step``).

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.multistep_bench [S ...] [--device cuda]

S defaults to 4 and 8. Prints one JSON line per S; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..examples import add_device_argument, resolve
from . import device_name, fresh_state, log, to_device

NUM_CLASSES = 20
LEARNING_RATE, L2_RATE, KEEP_PROB, SEED = 1e-4, 0.0, 0.5, 0


def main(steps_per_dispatch=4, total_steps=16, h=1024, w=512, batch=8, *,
         device="cuda") -> dict:
    dev = resolve(device)

    from ..parallel.steps import (compile_multi_train_step, compile_train_step, make_optimizer,
                                  train_step)
    from ..utils.profiling import device_busy

    s = steps_per_dispatch
    if total_steps % s:
        raise ValueError(f"total_steps={total_steps} is no multiple of steps_per_dispatch={s}")
    log(f"device: {device_name(dev)}")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(batch, h, w, 3), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASSES, size=(batch, h, w), dtype=np.uint8)
    mask = np.ones((batch,), np.float32)
    im, lb, mk = to_device(dev, images, labels, mask)
    im_s, lb_s, mk_s = (x.expand(s, *x.shape).contiguous() for x in (im, lb, mk))
    scalars = (SEED, LEARNING_RATE, L2_RATE, KEEP_PROB)

    optimizer = make_optimizer()
    state = fresh_state(NUM_CLASSES, dev, optimizer)
    step1 = compile_train_step(None, optimizer, NUM_CLASSES, tensor_parallel=False, device=dev)
    stepS = compile_multi_train_step(None, optimizer, NUM_CLASSES, steps_per_dispatch=s,
                                     tensor_parallel=False, device=dev)

    def run_eager(n):
        for _ in range(n):
            _, loss = train_step(state, im, lb, mk, *scalars, optimizer=optimizer,
                                 num_classes=NUM_CLASSES)
        return loss.item()

    def run_single(n):
        for _ in range(n):
            _, loss = step1(state, im, lb, mk, *scalars)
        return loss.item()

    def run_multi(n_dispatch):
        for _ in range(n_dispatch):
            _, losses = stepS(state, im_s, lb_s, mk_s, *scalars)
        return losses[-1].item()

    # interleaved warm-up (captures both graphs), then timed windows
    run_eager(2)
    run_single(2)
    run_multi(1)
    results, busy = {}, {}
    for name, fn, n, per in (("eager", run_eager, total_steps, 1),
                             ("single", run_single, total_steps, 1),
                             ("multi", run_multi, total_steps // s, s)):
        fn(1 if name == "multi" else 2)  # re-enter steady state
        t0 = time.perf_counter()
        last = fn(n)
        dt = time.perf_counter() - t0  # the last call's read-back synced
        results[name] = dt / (n * per) * 1e3
        with torch.profiler.profile(activities=_activities(dev)) as prof:
            fn(s // per)
        busy[name] = device_busy(prof)["share"]
        log(f"{name}: {results[name]:.2f} ms/step, device busy {busy[name]} (last loss "
            f"{last:.4f})")
    log(f"delta: {results['single'] - results['multi']:+.2f} ms/step single vs multi "
        f"({(results['single'] / results['multi'] - 1) * 100:+.1f}% throughput), "
        f"{results['eager'] - results['single']:+.2f} ms/step eager vs single")
    return {**results, "busy_share": busy, "steps_per_dispatch": s, "total_steps": total_steps,
            "shape": [batch, h, w], "device": device_name(dev)}


def _activities(dev) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def cli(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("steps_per_dispatch", nargs="*", type=int, default=[4, 8],
                   help="S, one run each (default 4 8)")
    add_device_argument(p)
    args = p.parse_args(argv)
    out = []
    for s in args.steps_per_dispatch:
        out.append(main(steps_per_dispatch=s, device=args.device))
        print(json.dumps(out[-1]))
        sys.stdout.flush()
    return out


if __name__ == "__main__":
    cli()
