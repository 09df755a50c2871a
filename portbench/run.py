"""Run one cell of the port's benchmark once, on the card(s) of this machine.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads the cell's configuration and traffic, makes the weights and inputs
from the seed, warms up every shape the cell uses (``setup_s``), measures
for ``--seconds``, checks what the timed path produced against the plain
reference (``correct``), and prints one JSON line last on standard output:
the end-to-end metrics with ``--trace 0``, the per-layer metrics read from a
``torch.profiler`` trace of the window with ``--trace 1``. The numbers
compared and their limits are also the last lines of standard error.

It exits non-zero, printing no result, without enough CUDA cards for the
cell, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _fail(message: str, code: int = 2):
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def _print_kernels(summary: dict) -> None:
    """The traced window's device operations by time, and the hand kernels
    found among them, on standard error."""
    from .metrics.arith.kernels import kernel_of

    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])
    for name, (calls, secs) in ops[:30]:
        print(f"device op {secs:.6f} s, {calls} calls: {name[:160]}", file=sys.stderr)
    for name, (calls, secs) in ops:
        if kernel_of(name):
            print(f"hand kernel {kernel_of(name)}: {secs:.6f} s, {calls} calls: {name[:160]}",
                  file=sys.stderr)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from . import harness

    harness.cache_dirs()
    cell = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}")
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), t0=T0)
    with contextlib.redirect_stdout(sys.stderr):  # the program's prints stay off stdout
        result = harness.driver(cell.traffic["kind"]).run(ctx)
        found = harness.forbidden_modules()
        if found:
            _fail(f"modules of JAX or the JAX package were loaded: {', '.join(found)}", 3)
        per_layer = {}
        if args.trace:
            for metric in cell.per_layer:
                per_layer[metric["name"]] = harness.reader(metric["name"]).read(
                    {"trace": result.trace, "counters": result.counters,
                     "device_name": torch.cuda.get_device_name(0)})
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": result.device_count, "memory_peak_bytes": result.memory_peak_bytes,
              "power_limit": harness.power_limit()}
    if args.trace:
        device["busy_s"] = result.trace["busy_s"]
        device["window_s"] = result.trace["window_s"]
        _print_kernels(result.trace)
    print(f"setup_s {result.setup_s!r}; notes {json.dumps(result.notes)}", file=sys.stderr)
    for name, value, limit in result.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(f"correct: {result.correct}", file=sys.stderr, flush=True)
    print(json.dumps(harness.line(cell, result, bool(args.trace), per_layer, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
