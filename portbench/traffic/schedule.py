"""Seeded open-loop schedules: which request is due when, with which body,
and which answers the check keeps."""

from __future__ import annotations

import numpy as np

from . import scenes


def arrivals(seed: int, rate: float, seconds: float, stream: int = 0) -> np.ndarray:
    """Poisson arrivals at ``rate`` a second over ``seconds``, conditioned on
    their count: the gaps between ``round(rate * seconds)`` times drawn
    uniformly over the window, drawn once for every seed, and put in the
    seed's order. So every seed offers the same requests with the same
    gaps, bursts and lulls, in another order. ``stream`` 3 is the
    warm-up's, apart from the window's 0."""
    n = int(round(rate * seconds))
    fixed = scenes.rng_for(0, scenes.SCHEDULE_STREAM, 100 + stream)
    gaps = np.diff(np.sort(fixed.uniform(0.0, seconds, n)), prepend=0.0)
    order = scenes.rng_for(seed, scenes.SCHEDULE_STREAM, stream).permutation(n)
    return np.cumsum(gaps[order])


def picks(seed: int, n: int, pool: int) -> np.ndarray:
    """The pool scene each of ``n`` requests sends."""
    return scenes.rng_for(seed, scenes.SCHEDULE_STREAM, 1).integers(0, pool, n)


def keep(seed: int, n: int, k: int) -> list[int]:
    """``k`` request indices (of ``n``) whose answers the check compares."""
    rng = scenes.rng_for(seed, scenes.SCHEDULE_STREAM, 2)
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-quantile (0 < q <= 1) of ``values``."""
    ordered = sorted(values)
    return float(ordered[max(0, int(np.ceil(q * len(ordered))) - 1)])
