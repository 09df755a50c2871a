"""A/B: the full train step with and without device augmentation. Port of
``benchmarks/device_augment_bench.py``.

The step at the headline training shape (8 x 1024x512, full-width FCN-8s,
TF1 Adam, keep_prob 0.5) plain, with ``AUG`` (flip + brightness +
translate + scale, ``ops/augment_device.py`` through
``train_step(augment_fn=)``, outside autograd), and with ``AUG_PHOTO``
(the same plus contrast, saturation, hue and gamma), in one process. The
port's augmentations draw from ``torch.Generator``s of (seed, step, slot),
not from ``jax.random``: the same transforms on other draws.

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.device_augment_bench [--device cuda]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..examples import add_device_argument, resolve
from . import fresh_state, log, to_device

H, W = 1024, 512
BATCH = 8
NUM_CLASSES = 20
WARMUP = 3
ITERS = 10
AUG = dict(flip=0.5, brightness=(0.8, 1.2, 0.5), translate=((0, 16), (0, 8), 0.5),
           scale=(0.8, 1.2, 0.5), void_class_id=0)
AUG_PHOTO = dict(AUG, contrast=(0.7, 1.3, 0.5), saturation=(0.5, 1.5, 0.5), hue=(0.1, 0.5),
                 gamma=(0.7, 1.4, 0.5))


def time_step(step, state, batch):
    for _ in range(WARMUP):
        state, loss = step(state, *batch)
    loss.item()  # hard sync
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state, loss = step(state, *batch)
    loss.item()
    return (time.perf_counter() - t0) / ITERS, state


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve(args.device)

    from ..ops.augment_device import make_augment_fn
    from ..parallel.steps import make_optimizer, train_step

    log(f"device: {dev}")
    rng = np.random.default_rng(0)
    optimizer = make_optimizer()
    state = fresh_state(NUM_CLASSES, dev, optimizer)
    batch = to_device(dev, rng.integers(0, 255, (BATCH, H, W, 3), np.uint8),
                      rng.integers(0, NUM_CLASSES, (BATCH, H, W), np.uint8),
                      np.ones((BATCH,), np.float32))

    def stepper(augment_fn):
        def step(s, im, lb, mk):
            return train_step(s, im, lb, mk, 1, 1e-4, 0.0, 0.5, optimizer=optimizer,
                              num_classes=NUM_CLASSES, augment_fn=augment_fn)
        return step

    base_dt, state = time_step(stepper(None), state, batch)
    log(f"baseline: {base_dt * 1e3:.1f} ms/step")
    aug_dt, state = time_step(stepper(make_augment_fn(**AUG)), state, batch)
    log(f"device-augmented: {aug_dt * 1e3:.1f} ms/step")
    photo_dt, state = time_step(stepper(make_augment_fn(**AUG_PHOTO)), state, batch)
    log(f"+photometric extras: {photo_dt * 1e3:.1f} ms/step")

    result = {
        "metric": "device_augment_step_overhead_ms",
        "baseline_ms_per_step": round(base_dt * 1e3, 1),
        "augmented_ms_per_step": round(aug_dt * 1e3, 1),
        "overhead_ms": round((aug_dt - base_dt) * 1e3, 1),
        "overhead_pct": round((aug_dt / base_dt - 1) * 100, 1),
        "photometric_ms_per_step": round(photo_dt * 1e3, 1),
        "photometric_marginal_ms": round((photo_dt - aug_dt) * 1e3, 1),
        "config": "flip 0.5 + brightness(0.8,1.2,0.5) + translate((0,16),(0,8),0.5) + scale(0.8,1.2,0.5)",
        "photometric_config": "+ contrast(0.7,1.3,0.5) + saturation(0.5,1.5,0.5) + hue(0.1,0.5) + gamma(0.7,1.4,0.5)",
        "shape": f"{BATCH}x{H}x{W}",
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
