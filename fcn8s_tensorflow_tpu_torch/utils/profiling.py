"""Profiling and tracing utilities. Port of
``fcn8s_tensorflow_tpu/utils/profiling.py``.

``trace`` captures a ``torch.profiler`` trace (host ops, and the card's
kernels where there is a card) and writes it as a Chrome/Perfetto JSON
file; ``annotate`` names a span in it; ``hard_sync`` waits for the devices
that hold a tree's tensors; ``StepTimer`` times steps with warm-up
exclusion; ``memory_stats`` reports the card's allocator under the JAX
package's keys; ``device_busy`` reads a finished trace's device busy share.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write the trace into ``log_dir``
    as ``trace_<pid>_<ns>.json`` (open it in Perfetto or
    chrome://tracing). Yields the profiler, whose events stay readable after
    the block (``device_busy``, ``key_averages``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named trace span context manager for host-side phases."""
    return torch.profiler.record_function(name)


def _tensor_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensor_leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensor_leaves(value)


def hard_sync(tree) -> None:
    """Wait for all queued work on every CUDA device that holds a tensor of
    ``tree`` (nested dicts, lists and tuples). CPU tensors and other leaves
    need no wait."""
    for device in {t.device for t in _tensor_leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


class StepTimer:
    """Steady-state step timing with warmup exclusion and percentiles.

    Usage::

        timer = StepTimer(warmup=3)
        for batch in data:
            with timer.step():
                state, loss = train_step(state, *batch)
                timer.sync_on(loss)
        print(timer.summary())
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: list[float] = []
        self._count = 0
        self._sync_target = None

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield self
        if self._sync_target is not None:
            hard_sync(self._sync_target)
            self._sync_target = None
        dt = time.perf_counter() - t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def sync_on(self, tree) -> None:
        """Register outputs to hard-sync on before the step's clock stops."""
        self._sync_target = tree

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "max_ms": float(arr.max() * 1e3),
        }


def memory_stats(device=None) -> dict:
    """The card's allocator under the JAX package's keys: ``bytes_in_use``
    and ``peak_bytes_in_use`` (PyTorch's allocated bytes, current and
    peak), ``bytes_limit`` (the card's memory) and ``utilization``. The CPU
    reports ``{}``, as JAX's CPU backend does. ``device`` defaults to the
    current card where there is one."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
           "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
           "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0))}
    if out["bytes_limit"]:
        out["utilization"] = round(out["bytes_in_use"] / out["bytes_limit"], 4)
    return out


def device_busy(prof) -> dict:
    """The device busy share of a finished ``trace``: the union of the
    device events' intervals (kernels, copies, sets) over the span of all of
    the trace's events. Returns ``{'window_us', 'busy_us', 'share',
    'device_events', 'host_syncs'}``; ``share`` is None where the trace
    holds no device event (no card, or a profiler that does not see it);
    ``host_syncs`` counts the runtime calls in which the host waited for
    the device (``cuda*Synchronize``), each a point where the card may run
    dry while the host catches up."""
    events = list(prof.events())
    syncs = sum(1 for e in events if e.name.startswith("cuda") and "Synchronize" in e.name)
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    window = (max(end for _, end in spans) - min(start for start, _ in spans)) if spans else 0.0
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in device:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return {"window_us": float(window), "busy_us": float(busy),
            "share": busy / window if device and window else None,
            "device_events": len(device), "host_syncs": syncs}
