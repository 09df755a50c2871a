"""Seeded street scenes with their labels, in numpy.

A frozen copy of the port's ``tools/synthetic.py`` ``synth_batch`` (flat
colour scenes: a sky band over a road band, then 1-3 rectangles each of
buildings, cars and people, pixel noise of +-30), with the labels written as
Cityscapes trainIds of the modified scheme (void 0, evaluated classes
1..19) and the noise drawn as int16. Each batch has a generator of its own,
``(seed, stream, index)``, so any batch or scene can be made again alone,
and ``batches`` makes many at once on a few threads.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the scene classes: (RGB colour, trainId)
ROAD, SKY, CAR, BUILDING, PERSON = ((128, 64, 128), 1), ((70, 130, 180), 11), \
    ((0, 0, 142), 14), ((70, 70, 70), 3), ((220, 20, 60), 12)

# the streams of SeedSequence([seed, stream, index]); weights use stream 1
TRAIN_STREAM, PREDICT_STREAM, SERVE_STREAM, SCHEDULE_STREAM, SAMPLE_STREAM = 2, 3, 4, 5, 6


def rng_for(seed: int, stream: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream, index]))


def synth_batch(rng: np.random.Generator, n: int, h: int, w: int):
    """``n`` scenes of ``h`` x ``w``: uint8 images (n, h, w, 3) and uint8
    trainId maps (n, h, w)."""
    images = np.zeros((n, h, w, 3), np.int16)
    labels = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        horizon = rng.integers(h // 4, h // 2)
        labels[i, :horizon], images[i, :horizon] = SKY[1], SKY[0]
        labels[i, horizon:], images[i, horizon:] = ROAD[1], ROAD[0]
        for colour, train_id in (BUILDING, CAR, PERSON):  # draw order
            for _ in range(rng.integers(1, 4)):
                bh = rng.integers(h // 8, h // 3)
                bw = rng.integers(w // 10, w // 4)
                y0 = rng.integers(0, h - bh)
                x0 = rng.integers(0, w - bw)
                labels[i, y0:y0 + bh, x0:x0 + bw] = train_id
                images[i, y0:y0 + bh, x0:x0 + bw] = colour
    images += rng.integers(-30, 30, images.shape, dtype=np.int16)
    return np.clip(images, 0, 255).astype(np.uint8), labels


def batch(seed: int, stream: int, index: int, n: int, h: int, w: int):
    """Batch ``index`` of a stream: the same bytes whenever it is made."""
    return synth_batch(rng_for(seed, stream, index), n, h, w)


def batches(seed: int, stream: int, count: int, n: int, h: int, w: int) -> list:
    """Batches 0..count-1 of a stream, made on up to 8 threads."""
    workers = max(1, min(8, count, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda k: batch(seed, stream, k, n, h, w), range(count)))
