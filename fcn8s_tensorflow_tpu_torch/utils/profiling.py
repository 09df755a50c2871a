"""Profiling and tracing utilities. Port of
``fcn8s_tensorflow_tpu/utils/profiling.py``.

``trace`` captures a ``torch.profiler`` trace (host ops, and the card's
kernels where there is a card) and writes it as a Chrome/Perfetto JSON
file; ``annotate`` names a span in it (the port's spans, ``fcn8s.*``, and
their layers: ``PERF.md`` section 3); ``hard_sync`` waits for the devices
that hold a tree's tensors; ``StepTimer`` times steps with warm-up
exclusion; ``memory_stats`` reports the card's allocator under the JAX
package's keys; ``device_busy`` reads a finished trace's device busy share,
and ``span_table`` its device idle time and collectives' exposed time under
each of the port's spans.
"""

from __future__ import annotations

import bisect
import contextlib
import math
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
    the block (``device_busy``, ``span_table``, ``key_averages``). Every
    thread of the process is traced where the installed torch can (the
    input prefetcher's span, ``fcn8s.prefetch.h2d``, runs on a thread of its
    own); else the thread that enters the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                experimental_config=_all_threads()) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _all_threads():
    """The profiler's setting that traces every thread, or None where the
    installed torch lacks it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


# what ``annotate`` returns while no profiler runs: one shared context that
# does nothing
_NULL_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named span of the host's work, as a context manager: while a
    profiler runs, a ``torch.profiler.record_function`` range, which lands on
    the profiler's clock beside the card's events; else the shared no-op
    context, after one check of the profiler's flag and no dispatcher call.
    The port's spans are named ``fcn8s.<layer>.<phase>``."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NULL_SPAN
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
    dry while the host catches up. A span's copy on the device timeline
    (``annotate``'s ranges show there too) is no device work and is left
    out."""
    events = list(prof.events())
    syncs = sum(1 for e in events if e.name.startswith("cuda") and "Synchronize" in e.name)
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    device = [(e.time_range.start, e.time_range.end) for e in _device_events(events)]
    window = (max(end for _, end in spans) - min(start for start, _ in spans)) if spans else 0.0
    busy = _length(_merged(device, -math.inf, math.inf))
    return {"window_us": float(window), "busy_us": float(busy),
            "share": busy / window if device and window else None,
            "device_events": len(device), "host_syncs": syncs}


def _device_events(events) -> list:
    """The device's work among a trace's events: kernels, copies and sets,
    not the spans' copies on the device timeline."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _merged(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out: list = []
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _length(merged) -> float:
    return sum(b - a for a, b in merged)


def _gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cursor = [], lo
    for a, b in _merged(intervals, lo, hi):
        if a > cursor:
            out.append((cursor, a))
        cursor = b
    if hi > cursor:
        out.append((cursor, hi))
    return out


# the port's spans (``annotate``): every name begins with SPAN_PREFIX; the
# threads that open a public call's span cut the card's idle time
SPAN_PREFIX = "fcn8s."
CALL_SPANS = ("fcn8s.train", "fcn8s.predict")
MESH_SPANS = "fcn8s.mesh."
UNSPANNED = "-"  # the idle time under none of the port's spans


def span_table(prof, window: str | None = None) -> dict:
    """The port's spans (``fcn8s.*``) in a finished ``trace`` against the
    card's work: ``{name: [count, host_s, idle_s, exposed_s]}``, in seconds,
    for every span inside the window (the span named ``window``, else the
    whole trace):

    * ``count`` and ``host_s``: the span's calls and their summed host time,
      clipped to the window;
    * ``idle_s``: the card's idle time in the window under the span. Each
      stretch in which no device event runs is cut at the boundaries of the
      spans on the threads that opened ``fcn8s.train`` or ``fcn8s.predict``,
      and each piece goes to the innermost span open over it (a span's own
      entry holds its self time); a piece under none goes to ``-``;
    * ``exposed_s``, for the collectives (``fcn8s.mesh.*``) only: the device
      time of the events their host ops launched (the profiler's
      launch-to-kernel link) that no other device event overlaps.

    Without a card every stretch of the window is idle. On a mesh each rank
    traces its own process: sum the ranks' tables entry by entry."""
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    device = _device_events(events)
    if window is None:
        lo = min((e.time_range.start for e in events), default=0.0)
        hi = max((e.time_range.end for e in events), default=0.0)
    else:
        marks = [e for e in host if e.name == window]
        if not marks:
            raise ValueError(f"the trace holds no span {window!r}")
        lo, hi = marks[0].time_range.start, marks[0].time_range.end
    return _span_table(host, device, lo, hi, _link_of(prof, events))


def _link_of(prof, events: list):
    """``link(event)``: the id of the host op under which a device event or a
    runtime call was made (the profiler's launch-to-kernel link), 0 for
    none. The trace's events carry it where the installed torch gives them
    ``linked_correlation_id``; else it is read from the profiler's raw
    events, by id and by device (a kernel's name may be demangled) or, for
    a runtime call, by id and name."""
    if not events or hasattr(events[0], "linked_correlation_id"):
        return lambda e: getattr(e, "linked_correlation_id", 0)
    raw = getattr(getattr(prof, "profiler", prof), "kineto_results", None)
    if raw is None:
        return lambda e: 0
    cuda = torch.autograd.DeviceType.CUDA
    links = {}
    for k in raw.events():
        if k.linked_correlation_id():
            on_card = k.device_type() == cuda
            links[(k.correlation_id(), on_card, None if on_card else k.name())] = (
                k.linked_correlation_id())

    def link(e):
        on_card = e.device_type == cuda
        return links.get((e.id, on_card, None if on_card else e.name), 0)

    return link


def _span_table(host: list, device: list, lo: float, hi: float, link) -> dict:
    """``span_table`` on a trace's host and device events in ``[lo, hi]``
    (microseconds); ``link`` as ``_link_of``'s."""
    ours = [e for e in host if e.name.startswith(SPAN_PREFIX)]
    table: dict = {}

    def entry(name):
        return table.setdefault(name, [0, 0.0, 0.0, 0.0])

    for e in ours:
        start, end = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if end > start:
            entry(e.name)[0] += 1
            entry(e.name)[1] += (end - start) / 1e6
    threads = {e.thread for e in ours if e.name in CALL_SPANS}
    cut = [(max(e.time_range.start, lo), min(e.time_range.end, hi), e.name)
           for e in ours if e.thread in threads]
    idle = _gaps([(e.time_range.start, e.time_range.end) for e in device], lo, hi)
    for name, us in _idle_by_span(idle, _innermost(cut)).items():
        entry(name)[2] += us / 1e6
    mesh = [e for e in ours if e.name.startswith(MESH_SPANS)]
    for name, mine in _launched(device, host, mesh, link).items():
        own = {id(d) for d in mine}
        rest = [(d.time_range.start, d.time_range.end) for d in device if id(d) not in own]
        both = rest + [(d.time_range.start, d.time_range.end) for d in mine]
        exposed = _length(_merged(both, lo, hi)) - _length(_merged(rest, lo, hi))
        entry(name)[3] += exposed / 1e6
    return table


def _innermost(spans: list) -> list:
    """``spans`` (``(start, end, name)``) cut at all their boundaries into
    contiguous ``(start, end, name)`` stretches, each named by the innermost
    span open over it (the one that began last), or None."""
    marks = sorted({t for a, b, _ in spans if b > a for t in (a, b)})
    ordered = sorted((s for s in spans if s[1] > s[0]), key=lambda s: (s[0], -s[1]))
    out, open_, i = [], [], 0
    for a, b in zip(marks, marks[1:]):
        open_ = [s for s in open_ if s[1] > a]
        while i < len(ordered) and ordered[i][0] <= a:
            if ordered[i][1] > a:
                open_.append(ordered[i])  # a parent before its child
            i += 1
        out.append((a, b, open_[-1][2] if open_ else None))
    return out


def _idle_by_span(idle: list, stretches: list) -> dict:
    """The length of the ``(start, end)`` stretches ``idle`` under each name
    of ``stretches`` (``_innermost``'s); the rest under ``UNSPANNED``."""
    out: dict = {}

    def add(name, length):
        if length > 0:
            key = name or UNSPANNED
            out[key] = out.get(key, 0.0) + length

    first = stretches[0][0] if stretches else math.inf
    last = stretches[-1][1] if stretches else math.inf
    starts = [s[0] for s in stretches]
    for a, b in idle:
        add(None, min(b, first) - a)  # before the first span
        add(None, b - max(a, last))  # after the last
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(stretches) and stretches[k][0] < b:
            s0, s1, name = stretches[k]
            add(name, min(b, s1) - max(a, s0))
            k += 1
    return out


def _launched(device: list, host: list, spans: list, link) -> dict:
    """The device events that the host ops inside each of ``spans`` (which
    do not nest) launched: ``{span name: [device event]}``. A device event's
    ``link`` is the id of the host op it was launched under, which lies
    inside the span on the span's thread."""
    by_thread: dict = {}
    for e in sorted(spans, key=lambda e: e.time_range.start):
        by_thread.setdefault(e.thread, []).append(e)
    starts = {t: [e.time_range.start for e in items] for t, items in by_thread.items()}
    # the host ops by id (a runtime call links to its op as a kernel does,
    # and its own id is the runtime's)
    ops = {e.id: e for e in host if not link(e)}
    out: dict = {}
    for d in device:
        op = ops.get(link(d) or None)
        if op is None or op.thread not in by_thread:
            continue
        # the last span to begin before the op (no two of them nest)
        k = bisect.bisect_right(starts[op.thread], op.time_range.start) - 1
        if k >= 0 and by_thread[op.thread][k].time_range.end >= op.time_range.end:
            out.setdefault(by_thread[op.thread][k].name, []).append(d)
    return out
