"""Closed-loop prediction: ``FCN8s.predict(images, argmax=True)`` on
batches held in host memory, one call after the other, ids back on the
host.

Set-up makes a cycle of seeded batches and the model, and predicts the
first batch once (the capture and its warm-up). The window calls
``predict`` on the cycle until ``--seconds`` have passed;
``predict_images_per_s`` is every image returned over the window. A sample
of the images the window returned, drawn from the seed (a reservoir, so
every image is as likely), keeps its ids; after the window the plain
reference computes their fp32 logits and the check reads the widest gap by
which a served id's logit lies below the reference's best.
"""

from __future__ import annotations

import time

import numpy as np

from .. import harness, system, tracing, weights
from ..metrics.arith import flops
from ..reference import compare, fcn
from ..traffic import scenes


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from ``rng``: the same stream and seed keep the same items."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, key, make) -> None:
        """Offer item ``key``; ``make()`` gives its value if it is kept."""
        if len(self.items) < self.size:
            self.items.append((key, make()))
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.size:
                self.items[slot] = (key, make())
        self.seen += 1


def make_data(ctx) -> list:
    n, (h, w) = ctx.mix("batch"), ctx.mix("image_hw")
    return [images for images, _ in
            scenes.batches(ctx.seed, scenes.PREDICT_STREAM, ctx.mix("cycle"), n, h, w)]


def gaps(cfg: dict, seed: int, device, width, kept: list, images: list) -> dict:
    """The answer gaps of the kept ``((batch, row), ids)`` against the
    reference's fp32 logits of their images."""
    tree = weights.make_tree(cfg, seed, device, width)
    with fcn.exact_fp32():
        out = compare.answer_gaps((fcn.logits(tree, images[b][row], cfg), ids)
                                  for (b, row), ids in kept)
    del tree
    return out


def run(ctx: harness.Context) -> harness.Result:
    cfg, device = ctx.cell.config, ctx.device
    data = make_data(ctx)
    n, hw = ctx.mix("batch"), ctx.mix("image_hw")
    system.reset_peak(device)
    model = system.model(cfg, ctx.seed, device, ctx.width)
    model.predict(data[0], argmax=True)
    system.sync(device)

    sample = Reservoir(ctx.mix("sample"), scenes.rng_for(ctx.seed, scenes.SAMPLE_STREAM, 0))
    calls = 0
    with tracing.traced(ctx.trace) as trace:
        start = time.perf_counter()
        with tracing.window():
            while True:
                b = calls % len(data)
                ids = model.predict(data[b], argmax=True)
                for row in range(ids.shape[0]):
                    sample.offer((b, row), lambda: ids[row].astype(np.uint8))
                calls += 1
                if time.perf_counter() - start >= ctx.seconds:
                    break
        end = time.perf_counter()
    peak = system.peak_bytes(device)
    del model
    system.free(device)

    found = gaps(cfg, ctx.seed, device, ctx.width, sample.items, data)
    widths = weights.scaled(cfg, ctx.width) if ctx.width else None
    images = calls * n
    return harness.Result(
        setup_s=start - ctx.t0, attempted=calls, failed=0,
        end_to_end={"predict_images_per_s": images / (end - start), "setup_s": start - ctx.t0},
        counters={"images": images, "calls": calls, "batch": n, "image_hw": list(hw), "chips": 1,
                  "flops": images * flops.predict_flops_per_image(cfg, hw, widths),
                  "config": cfg, "widths": widths, "kind": "predict"},
        checks=harness.checks(found, ctx.cell.limits),
        memory_peak_bytes=peak, device_count=1, trace=trace.summary, notes={"gaps": found})
