"""Learning-rate schedules. Port of ``fcn8s_tensorflow_tpu/engine/schedules.py``.

The trainer takes any ``step -> float`` callable and calls it on the host
with the global step before every step (``FCN8s.train``); the helpers
below build the canonical ones. Pure Python, the same formulas as the JAX
package's.
"""

from __future__ import annotations

import math


def piecewise_constant(boundaries, values):
    """``values[i]`` while ``step < boundaries[i]``; ``values[-1]`` after.

    ``len(values) == len(boundaries) + 1``.
    """
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")

    def schedule(step: int) -> float:
        for boundary, value in zip(boundaries, values):
            if step < boundary:
                return value
        return values[-1]

    return schedule


def reference_tutorial_schedule():
    """The canonical schedule from the reference tutorial (cell 15):
    1e-4 (<=10k) -> 1e-5 (<=20k) -> 3e-6 (<=40k) -> 1e-6."""
    return piecewise_constant([10000, 20000, 40000], [1e-4, 1e-5, 3e-6, 1e-6])


def constant(lr: float):
    return lambda step: lr


def warmup_cosine(peak_lr: float, total_steps: int, *, warmup_steps: int = 0,
                  final_lr: float = 0.0):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then cosine decay
    to ``final_lr`` at ``total_steps``."""
    if total_steps <= warmup_steps:
        raise ValueError("total_steps must exceed warmup_steps")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak_lr * (step + 1) / warmup_steps
        t = min(1.0, (step - warmup_steps) / (total_steps - warmup_steps))
        return final_lr + 0.5 * (peak_lr - final_lr) * (1 + math.cos(math.pi * t))

    return schedule


def exponential_decay(initial_lr: float, decay_steps: int, decay_rate: float,
                      *, staircase: bool = False):
    """``initial_lr * decay_rate ** (step / decay_steps)`` —
    ``tf.train.exponential_decay`` semantics."""

    def schedule(step: int) -> float:
        exponent = step // decay_steps if staircase else step / decay_steps
        return initial_lr * decay_rate ** exponent

    return schedule


def polynomial_decay(initial_lr: float, total_steps: int, *, power: float = 0.9,
                     end_lr: float = 0.0, warmup_steps: int = 0):
    """The segmentation-standard "poly" schedule (FCN follow-ups, DeepLab):
    ``end_lr + (initial_lr - end_lr) * (1 - t)**power`` with
    ``t = (step - warmup) / (total - warmup)`` clamped to [0, 1], after an
    optional linear warmup."""
    if total_steps <= warmup_steps:
        raise ValueError("total_steps must exceed warmup_steps")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return initial_lr * (step + 1) / warmup_steps
        t = min(1.0, (step - warmup_steps) / (total_steps - warmup_steps))
        return end_lr + (initial_lr - end_lr) * (1.0 - t) ** power

    return schedule
