"""Per-op profile of the FCN-8s train step on the card. Port of
``benchmarks/profile_train_step.py``.

Captures a ``torch.profiler`` trace of a few steady-state steps through
``utils.profiling.trace`` (a Chrome/Perfetto JSON file), sums the device
events (``cat`` ``kernel``, ``gpu_memcpy`` and ``gpu_memset``: cuDNN's and
cuBLAS's kernels, PyTorch's own, and the hand kernels launched through
ctypes, which CUPTI records the same way) by name, and prints them ranked
by total device time. Each step is a ``train_step`` span in the trace;
their count is the step count of a parsed file.

Usage::

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.profile_train_step \
        [--steps N] [--top K] [--device cuda]
    python -m fcn8s_tensorflow_tpu_torch.benchmarks.profile_train_step \
        --parse-only TRACE.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
from collections import defaultdict

import numpy as np

from ..examples import add_device_argument, resolve
from . import fresh_state, log, to_device

H, W = 1024, 512
BATCH = 8
NUM_CLASSES = 20
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_SPAN = "train_step"


def _trace_file(path: str) -> str:
    """``path`` itself, or the newest ``*.json`` under the directory ``path``."""
    if os.path.isfile(path):
        return path
    paths = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace JSON under {path}")
    return paths[-1]


def parse_trace(path: str, top: int = 40):
    """Aggregate device-event durations of a Chrome trace (``path``: the
    file, or a directory whose newest ``*.json`` it takes).

    Returns ([(op_name, total_ms, count)], device_total_ms, n_steps):
    ``top`` names ranked by total time, the sum of every device event, and
    the number of ``train_step`` spans (0 if absent)."""
    with open(_trace_file(path)) as f:
        events = json.load(f)["traceEvents"]
    totals: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    device_total_us = 0.0
    n_steps = 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if ev.get("name") == STEP_SPAN and ev.get("cat") == "user_annotation":
            n_steps += 1
        if ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        dur = float(ev.get("dur", 0.0))
        totals[ev["name"]] += dur / 1e3  # us -> ms
        counts[ev["name"]] += 1
        device_total_us += dur
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])
    return [(n, ms, counts[n]) for n, ms in ranked[:top]], device_total_us / 1e3, n_steps


def _print_table(ranked, device_total_ms: float, steps: int, source: str) -> None:
    print(f"device total: {device_total_ms:.1f} ms over {steps} steps ({source})")
    print(f"{'op':<60} {'total ms':>9} {'ms/step':>8} {'count':>6}")
    for name, ms, cnt in ranked:
        print(f"{name[:60]:<60} {ms:9.2f} {ms / steps:8.2f} {cnt:6d}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--keep-trace", default=None, help="directory to keep the trace in")
    ap.add_argument("--parse-only", default=None,
                    help="skip the run; parse an existing trace JSON (or the newest in a "
                         "directory)")
    ap.add_argument("--ignore-label", type=int, default=None,
                    help="profile the masked (ignore_label) train step; GT gets ~25%% "
                         "ignored pixels")
    ap.add_argument("--augment", action="store_true",
                    help="profile the step with the full device-augment set (flip + "
                         "brightness + fused translate/scale + label_noise)")
    ap.add_argument("--num-classes", type=int, default=NUM_CLASSES,
                    help="19 matches ignore_label_bench's Cityscapes-trainIds step")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    if args.parse_only:
        ranked, device_total_ms, n_steps = parse_trace(args.parse_only, args.top)
        steps = n_steps or args.steps
        _print_table(ranked, device_total_ms, steps, "from trace" if n_steps else "assumed")
        return {"ranked": ranked, "device_total_ms": device_total_ms, "steps": steps}

    from ..parallel.steps import make_optimizer, train_step
    from ..utils.profiling import annotate, trace

    dev = resolve(args.device)
    log(f"device: {dev}")
    rng = np.random.default_rng(0)
    nc = args.num_classes
    optimizer = make_optimizer()
    state = fresh_state(nc, dev, optimizer)
    augment_fn = None
    if args.augment:
        from ..ops.augment_device import make_augment_fn

        augment_fn = make_augment_fn(
            flip=0.5, brightness=(0.8, 1.2, 0.5), translate=((0, 16), (0, 8), 0.5),
            scale=(0.8, 1.2, 0.5), label_noise=(0.05, 4, nc))
    labels_np = rng.integers(0, nc, (args.batch, H, W), dtype=np.uint8)
    if args.ignore_label is not None:
        labels_np[rng.random(labels_np.shape) < 0.25] = args.ignore_label
    im, lb, mk = to_device(dev, rng.integers(0, 255, (args.batch, H, W, 3), np.uint8),
                           labels_np, np.ones((args.batch,), np.float32))

    def step():
        return train_step(state, im, lb, mk, 1, 1e-4, 0.0, 0.5, optimizer=optimizer,
                          num_classes=nc, ignore_label=args.ignore_label,
                          augment_fn=augment_fn)[1]

    for _ in range(3):
        loss = step()
    loss.item()  # hard sync

    trace_dir = args.keep_trace or tempfile.mkdtemp(prefix="fcn8s_trace_")
    with trace(trace_dir):
        for _ in range(args.steps):
            with annotate(STEP_SPAN):
                loss = step()
        loss.item()
    log(f"trace in {trace_dir}")

    ranked, device_total_ms, n_steps = parse_trace(trace_dir, args.top)
    steps = n_steps or args.steps
    _print_table(ranked, device_total_ms, steps, f"{device_total_ms / steps:.1f} ms/step")
    return {"ranked": ranked, "device_total_ms": device_total_ms, "steps": steps}


if __name__ == "__main__":
    main()
