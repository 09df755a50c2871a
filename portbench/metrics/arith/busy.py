"""Interval arithmetic of a device trace: a frozen copy of the port's
``utils/profiling.py`` ``device_busy`` union, clipped to a window, and the
idle gaps between the merged intervals."""

from __future__ import annotations


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(b - a for a, b in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of ``[lo, hi]`` that no interval covers."""
    out, cursor = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > cursor:
            out.append((cursor, a))
        cursor = b
    if hi > cursor:
        out.append((cursor, hi))
    return out
