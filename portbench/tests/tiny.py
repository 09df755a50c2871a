"""The cells cut to what a CPU test holds: a narrow model, small frames,
and a driver's context for them."""

from __future__ import annotations

import time

from portbench import harness

WIDTH = {"mult": 1 / 16, "fc": 32}  # every conv width / 16 (at least 8), fc6/fc7 32
SHAPES = {  # the cells' mixes cut to what a CPU test holds
    "fcn8s.train.b8": {"batch": 2, "image_hw": [64, 128], "cycle": 4, "steps_per_call": 2},
    "fcn8s.serve.poisson": {"image_hw": [64, 128], "rate_per_s": 12},
    "fcn32s.predict.full": {"batch": 2, "image_hw": [64, 128], "cycle": 2, "sample": 2},
    "fcn8s.train.dp4": {"batch": 8, "image_hw": [64, 128], "cycle": 4, "steps_per_call": 2},
}
SEED = 2**31 + 17  # larger than 32 signed bits hold, as the driver's seeds are

# The serving cell is out of BENCHMARK.json until its latencies hold a bound
# (PERF.md); its driver, mix, limits and readers are tested under these entries.
SERVE = "fcn8s.serve.poisson"
HELD = {
    "workloads": [{"name": SERVE, "config": "fcn8s-vgg16-cityscapes",
                   "traffic": "serve_poisson", "chips": 1}],
    "end_to_end": [{"name": "request_p50_ms", "unit": "ms", "workloads": [SERVE]}],
    "per_layer": [{"name": name, "unit": unit, "workloads": [SERVE]}
                  for name, unit in (("request_p95_ms.serve", "ms"), ("batch_fill.serve", "%"),
                                     ("predict_call_ms.serve", "ms"),
                                     ("device_idle.serve", "%"))],
}


def cell_of(name: str) -> harness.Cell:
    """The cell ``name`` of ``BENCHMARK.json``, or of ``HELD``."""
    bench = harness.benchmark()
    if all(w["name"] != name for w in bench["workloads"]):
        bench = {**bench, **{key: bench[key] + HELD[key] for key in HELD}}
    return harness.cell(name, bench)


def tiny(cell: str, seed: int = SEED, seconds: float = 1.0, trace: bool = False):
    """A driver's context for ``cell`` on the CPU at the tiny size."""
    return harness.Context(cell=cell_of(cell), seed=seed, seconds=seconds, trace=trace,
                           t0=time.perf_counter(), device="cpu", width=WIDTH,
                           shape=SHAPES[cell])


def dry_run(cell: str, **kwargs) -> harness.Result:
    ctx = tiny(cell, **kwargs)
    return harness.driver(ctx.cell.traffic["kind"]).run(ctx)
