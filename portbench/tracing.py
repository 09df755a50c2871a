"""The traced window: a ``torch.profiler`` trace of the host and the card
around the measured window, reduced to a small summary that the per-layer
readers and the result's ``breakdown`` read.

The window is the span ``portbench.window`` that the drivers open around
their timed calls; device events (kernels, copies, sets) are clipped to it.
The summary is plain JSON, so the ranks of a multi-card cell can hand it to
rank 0: ``window_s``, ``busy_s`` (the union of the device intervals inside
the window), ``kernels`` (``{name: [calls, seconds]}``) and ``gaps`` (the
longest idle stretches, each named by the innermost host event open at its
middle).
"""

from __future__ import annotations

import contextlib

import torch

from .metrics.arith import busy as intervals

WINDOW = "portbench.window"
TOP = 10


@contextlib.contextmanager
def traced(enabled: bool):
    """Yield a holder whose ``summary`` is set after the block when
    ``enabled``; without it the block runs untraced."""
    holder = type("Trace", (), {"summary": None})()
    if not enabled:
        yield holder
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield holder
    holder.summary = summarize(prof)


def window():
    """The span that marks the measured window inside a traced block."""
    return torch.profiler.record_function(WINDOW)


def _annotation(event) -> bool:
    """A span's copy on the device timeline (``record_function`` ranges
    show there too), which is no device work."""
    return (bool(getattr(event, "is_user_annotation", False))
            or event.name.startswith("portbench."))


def _host_label(host: list, a: float, b: float) -> str:
    """What the host was doing in the idle stretch ``[a, b]``: the innermost
    host event open at its middle, or else the last one to end before it
    (the host then ran code the profiler does not record)."""
    mid = (a + b) / 2
    inside = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
    if inside:
        return min(inside, key=lambda e: e.time_range.end - e.time_range.start).name
    before = [e for e in host if e.time_range.end <= a]
    if before:
        return "after " + max(before, key=lambda e: e.time_range.end).name
    return "no host event"


def summarize(prof) -> dict:
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.name == WINDOW and e.device_type != cuda]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    device = [e for e in events if e.device_type == cuda and not _annotation(e)]
    host = [e for e in events if e.device_type != cuda and e.name != WINDOW]
    spans_us = [(e.time_range.start, e.time_range.end) for e in device]
    kernels: dict = {}
    for e in device:
        start, end = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if end <= start:
            continue
        entry = kernels.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += (end - start) / 1e6
    idle = sorted(intervals.gaps(spans_us, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    gaps = [[_host_label(host, a, b), (b - a) / 1e6] for a, b in idle]
    return {"window_s": (hi - lo) / 1e6, "busy_s": intervals.busy(spans_us, lo, hi) / 1e6,
            "kernels": kernels, "gaps": gaps, "device_events": len(device)}


def merge(summaries: list[dict]) -> dict:
    """One summary of the ranks' traces: the window and busy time averaged
    over the ranks, the kernels summed, the gaps pooled."""
    n = len(summaries)
    kernels: dict = {}
    for s in summaries:
        for name, (calls, secs) in s["kernels"].items():
            entry = kernels.setdefault(name, [0, 0.0])
            entry[0] += calls
            entry[1] += secs
    gaps = sorted((g for s in summaries for g in s["gaps"]), key=lambda g: -g[1])[:TOP]
    return {"window_s": sum(s["window_s"] for s in summaries) / n,
            "busy_s": sum(s["busy_s"] for s in summaries) / n,
            "kernels": kernels, "gaps": gaps,
            "device_events": sum(s["device_events"] for s in summaries)}


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, each at most ``TOP``."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"device_ops": [[name, secs] for name, (_, secs) in ops],
            "idle_gaps": [list(g) for g in summary["gaps"]]}
