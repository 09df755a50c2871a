"""The synthetic training workloads of the survival tools, in numpy.

Copies of ``benchmarks/convergence_synthetic.py``'s scene generator
(``CLASS_COLORS``, ``NUM_CLASSES``, ``synth_batch``) and of
``benchmarks/endurance_canonical.py``'s data half (``synth_hard_batch``,
``prepare_packed``, ``load_packed``, ``LABEL_NOISE``, ``AUGMENT_CONFIGS``,
``batch_for_step``, ``make_eval_batches``): for one seed they give the same
bytes as the JAX package's, so both packages train on the same stream.
``prepare_packed`` packs through this package's ``data.pack_dataset``.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

CLASS_COLORS = {
    1: (128, 64, 128),   # road
    2: (70, 130, 180),   # sky
    3: (0, 0, 142),      # car
    4: (70, 70, 70),     # building
    5: (220, 20, 60),    # person
}
NUM_CLASSES = 6  # 0 = void/background
LABEL_NOISE = 0.05

# "flip" is the tutorial's recipe (h-flip 0.5) with HOST-side label noise
# (batch_for_step); "full" is the whole device pipeline with the noise
# carried ON DEVICE after the geometric transforms, so the void borders of
# translate/scale are noised too (host noise is then off: no double noising)
AUGMENT_CONFIGS = {
    "flip": {"flip": 0.5},
    "full": {"flip": 0.5, "brightness": (0.8, 1.2, 0.5),
             "translate": ((0, 16), (0, 8), 0.5),
             "scale": (0.8, 1.2, 0.5),
             "label_noise": (0.05, 4, 6)},  # (rate, block, num_classes)
}


def synth_batch(rng, n, h, w):
    """Flat-colour scenes: a sky band over a road band and 1-3 rectangles
    each of buildings, cars and people, colours by class, pixel noise +-30."""
    images = np.zeros((n, h, w, 3), np.int16)
    labels = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        horizon = rng.integers(h // 4, h // 2)
        labels[i, :horizon] = 2
        images[i, :horizon] = CLASS_COLORS[2]
        labels[i, horizon:] = 1
        images[i, horizon:] = CLASS_COLORS[1]
        for cls in (4, 3, 5):  # buildings, cars, people (draw order)
            for _ in range(rng.integers(1, 4)):
                bh = rng.integers(h // 8, h // 3)
                bw = rng.integers(w // 10, w // 4)
                y0 = rng.integers(0, h - bh)
                x0 = rng.integers(0, w - bw)
                labels[i, y0:y0 + bh, x0:x0 + bw] = cls
                images[i, y0:y0 + bh, x0:x0 + bw] = CLASS_COLORS[cls]
    images = np.clip(images + rng.integers(-30, 30, images.shape), 0, 255).astype(np.uint8)
    return images, labels


def synth_hard_batch(rng, n, h, w):
    """Palette-jittered, clutter-heavy scenes, the endurance workload: each
    scene draws its own palette around the class colours (sigma 40, so
    colour alone is ambiguous across scenes), 2-6 objects a class down to
    h/16, pixel noise +-40. A 13,000-step run stays in honest descent
    instead of reaching the label-noise floor by step ~2k."""
    images = np.zeros((n, h, w, 3), np.int16)
    labels = np.zeros((n, h, w), np.uint8)
    # class 0 (void) never appears in the drawn scenes: row 0 is a placeholder
    base = np.array([(0, 0, 0)] + [CLASS_COLORS[c] for c in range(1, 6)], np.float32)
    for i in range(n):
        palette = np.clip(base + rng.normal(0, 40, base.shape), 0, 255)
        horizon = rng.integers(h // 4, h // 2)
        labels[i, :horizon] = 2
        images[i, :horizon] = palette[2]
        labels[i, horizon:] = 1
        images[i, horizon:] = palette[1]
        for cls in (4, 3, 5):  # buildings, cars, people (draw order)
            for _ in range(rng.integers(2, 7)):
                bh = rng.integers(h // 16, h // 3)
                bw = rng.integers(w // 20, w // 4)
                y0 = rng.integers(0, h - bh)
                x0 = rng.integers(0, w - bw)
                labels[i, y0:y0 + bh, x0:x0 + bw] = cls
                images[i, y0:y0 + bh, x0:x0 + bw] = palette[cls]
    images = np.clip(images + rng.integers(-40, 40, images.shape), 0, 255)
    return images.astype(np.uint8), labels


def prepare_packed(packed_dir: str, n: int, h: int, w: int) -> str:
    """Write ``n`` hard scenes (seed 7) as PNGs, then pack them through
    ``data.pack_dataset`` (``BatchGenerator`` discovery, then memmaps).
    An existing pack (its ``index.json``) is reused."""
    if os.path.isfile(os.path.join(packed_dir, "index.json")):
        return packed_dir
    from PIL import Image

    from ..data import BatchGenerator, pack_dataset

    png_dir = packed_dir + "_png"
    img_dir = os.path.join(png_dir, "img")
    gt_dir = os.path.join(png_dir, "gt", "img")  # pairing: <gt>/<img subdir>/
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    rng = np.random.default_rng(7)
    images, labels = synth_hard_batch(rng, n, h, w)
    for i in range(n):
        Image.fromarray(images[i]).save(os.path.join(img_dir, f"scene_{i:04d}_img.png"))
        Image.fromarray(labels[i]).save(os.path.join(gt_dir, f"scene_{i:04d}_gt.png"))
    gen = BatchGenerator(image_dirs=[img_dir],
                         ground_truth_dirs=[os.path.join(png_dir, "gt")],
                         image_name_split_separator="_img",
                         ground_truth_suffix="_gt", num_classes=NUM_CLASSES)
    pack_dataset(gen, packed_dir)
    shutil.rmtree(png_dir)
    return packed_dir


def load_packed(packed_dir: str):
    """The whole packed dataset in memory: (images, labels) arrays."""
    images = np.load(os.path.join(packed_dir, "images.npy"))
    labels = np.load(os.path.join(packed_dir, "labels.npy"))
    return np.ascontiguousarray(images), np.ascontiguousarray(labels)


def batch_for_step(images, labels, step: int, batch: int, host_noise: bool = True):
    """The batch consumed at global step ``step``: a pure function of the
    step (``default_rng(77_000 + step)``), so a resumed run replays the
    uninterrupted run's stream. With ``host_noise``, 5% label noise drawn
    per 4x4 block (it bounds Adam's logit growth on separable data; the
    clean eval set's optimum is unchanged); without it the labels are clean
    (the "full" config noises them on the card instead)."""
    rng = np.random.default_rng(77_000 + step)
    idx = rng.choice(len(images), size=batch, replace=False)
    # a stack of slices: numpy's fancy-index gather of a big pool is slower
    im = np.stack([images[i] for i in idx])
    lb = np.stack([labels[i] for i in idx])
    if not host_noise:
        return im, lb
    b = 4
    bh, bw = lb.shape[1] // b, lb.shape[2] // b
    flip = rng.random((batch, bh, bw), dtype=np.float32) < LABEL_NOISE
    vals = rng.integers(0, NUM_CLASSES, (batch, bh, bw), dtype=lb.dtype)
    np.copyto(lb, np.repeat(np.repeat(vals, b, 1), b, 2),
              where=np.repeat(np.repeat(flip, b, 1), b, 2))
    return im, lb


def make_eval_batches(h: int, w: int, batch: int, n_batches: int):
    """Clean-label batches of the training distribution (seed 999)."""
    rng = np.random.default_rng(999)
    return [synth_hard_batch(rng, batch, h, w) for _ in range(n_batches)]
