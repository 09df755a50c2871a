"""A/B: the cost of ``ignore_label`` in training. Port of
``benchmarks/ignore_label_bench.py``.

Three steps timed in one process, 19 classes, ~25% of pixels set to 255:

  baseline   no ignore label: K1, the per-sample CE kernel;
  masked     ``ignore_label=255``: K3 with valid-pixel weights;
  dense      ``ignore_label=255`` + unit ``class_weights``: K3 with class x
             valid-pixel weights (the same weights, the class lookup added).

In the JAX package the masked step blended ignored rows onto its
per-sample kernel and the dense one ran a per-pixel-weight kernel; in the
port both run K3 (``ops/kernels.py``) with the CE-grad kernel as the
backward, so the two losses agree to rounding
(``loss_rel_disagreement``, 0 or ~1e-7).

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.ignore_label_bench [--device cuda]

Prints one JSON line on stdout; chatter on stderr.
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
NUM_CLASSES = 19
IGNORE = 255
WARMUP = 3
ITERS = 10
CONFIGS = {
    "baseline (no ignore)": {},
    "masked (K3, valid-pixel weights)": {"ignore_label": IGNORE},
    "dense (K3, unit class weights)": {"ignore_label": IGNORE,
                                       "class_weights": (1.0,) * NUM_CLASSES},
}


def labels_with_ignored(rng, shape, num_classes: int = NUM_CLASSES, ignore: int = IGNORE):
    """Random ids with ~25% of the pixels set to ``ignore``."""
    labels = rng.integers(0, num_classes, shape, dtype=np.uint8)
    labels[rng.random(shape) < 0.25] = ignore
    return labels


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve(args.device)

    from ..parallel.steps import make_optimizer, train_step

    log(f"device: {dev}")
    rng = np.random.default_rng(0)
    optimizer = make_optimizer()
    labels_np = labels_with_ignored(rng, (BATCH, H, W))
    im, lb, mk = to_device(dev, rng.integers(0, 255, (BATCH, H, W, 3), np.uint8), labels_np,
                           np.ones((BATCH,), np.float32))

    def timed(tag, **step_kwargs):
        state = fresh_state(NUM_CLASSES, dev, optimizer)  # each section from step 0

        def step():
            return train_step(state, im, lb, mk, 1, 1e-4, 0.0, 0.5, optimizer=optimizer,
                              num_classes=NUM_CLASSES, **step_kwargs)[1]

        for _ in range(WARMUP):
            loss = step()
        first_loss = loss.item()  # hard sync
        t0 = time.perf_counter()
        for _ in range(ITERS):
            loss = step()
        loss.item()
        dt = (time.perf_counter() - t0) / ITERS
        log(f"{tag}: {dt * 1e3:.1f} ms/step ({BATCH / dt:.1f} img/s), loss@warm {first_loss:.6f}")
        return dt, first_loss

    (dt_base, _), (dt_masked, loss_masked), (dt_dense, loss_dense) = (
        timed(tag, **kw) for tag, kw in CONFIGS.items())
    rel = abs(loss_masked - loss_dense) / max(abs(loss_dense), 1e-9)
    log(f"masked-vs-dense loss agreement: {loss_masked:.6f} vs {loss_dense:.6f} "
        f"(rel {rel:.2e})")

    result = {
        "metric": "ignore_label_train_ms_per_step_1024x512",
        "unit": "ms/step",
        "shape": f"{BATCH}x{H}x{W}x{NUM_CLASSES}",
        "baseline_no_ignore_ms": round(dt_base * 1e3, 1),
        "masked_fast_ms": round(dt_masked * 1e3, 1),
        "dense_kernel_ms": round(dt_dense * 1e3, 1),
        "masked_overhead_vs_baseline_pct": round(100 * (dt_masked / dt_base - 1), 1),
        "dense_overhead_vs_baseline_pct": round(100 * (dt_dense / dt_base - 1), 1),
        "loss_rel_disagreement": float(f"{rel:.3e}"),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
