"""End-to-end train throughput with the real input pipeline. Port of
``benchmarks/e2e_input_bench.py``.

``bench``'s headline number times the step on device-resident batches.
This benchmark drives the public facade (``FCN8s.train`` with its
background prefetcher) through four input configurations, in one process,
``ROUNDS`` interleaved rounds, the best round of each:

  A  resident      a generator re-yielding a ring of preallocated batches
                   (the packed set's own content): the facade, prefetch and
                   H2D floor, no disk, no decode;
  B  packed        ``PackedDataset.generate`` (memmap reads, no host aug) +
                   ``DEVICE_AUG`` in the step;
  C  png           ``BatchGenerator.generate`` over the PNG tree (a decode
                   per image per step) + ``DEVICE_AUG``;
  D  packed+host   ``PackedDataset.generate`` with the host augmentations
                   ``HOST_AUG`` (flip, brightness, translate, scale).

The dataset tiles one 256x512 picture to 1024x512, rolled per image, with
random trainId GT maps. The JAX script tiles the reference's example
photograph, which neither this repository nor the card's machine holds;
the port tiles a seeded synthetic scene (``tools.synthetic.synth_batch``)
unless ``--image PATH`` names a picture (resized to 256x512 as
``cv2.resize`` does). ``tile_source`` in the line says which.

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.e2e_input_bench \
        [--image PATH] [--device cuda]

Prints one JSON line on stdout; chatter on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from ..examples import add_device_argument, resolve
from . import MODEL, log, sync

H, W = 1024, 512
BATCH = 8
NUM_CLASSES = 20
WARM_STEPS = 4
TIMED_STEPS = 12
TILE_H = 256
TILE_SEED = 1
DEVICE_AUG = {
    "flip": 0.5,
    "brightness": (0.8, 1.2, 0.5),
    "translate": ((0, 16), (0, 8), 0.5),
    "scale": (0.8, 1.2, 0.5),
}
HOST_AUG = dict(flip=0.5, brightness=(0.8, 1.2, 0.5),
                translate=((0, 16), (0, 8), 0.5), scale=(0.8, 1.2, 0.5),
                void_class_id=0)
ROUNDS = 3  # interleaved A, B, C, D rounds; the best of each


def tile_image(image_path: str | None = None) -> tuple[np.ndarray, str]:
    """The (TILE_H, W, 3) RGB tile and its source: ``image_path`` resized
    bilinearly, or a seeded synthetic scene."""
    if image_path is None:
        from ..tools.synthetic import synth_batch

        return (synth_batch(np.random.default_rng(TILE_SEED), 1, TILE_H, W)[0][0],
                f"synthetic scene (tools.synthetic.synth_batch, seed {TILE_SEED})")
    from PIL import Image

    from ..ops.resize_host import resize_linear_u8

    src = np.asarray(Image.open(image_path).convert("RGB"))
    return resize_linear_u8(src, (TILE_H, W)), os.path.abspath(image_path)


def build_dataset(root: str, tile: np.ndarray, n_images: int = 16):
    """A Cityscapes-layout tree: ``tile`` stacked to (H, W), rolled by 17
    columns per image and row of tiles, and random trainId GT (seed 0)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "leftImg8bit", "train", "city")
    gt_dir = os.path.join(root, "gtFine", "train", "city")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    for i in range(n_images):
        img = np.concatenate(
            [np.roll(tile, 17 * (i + j), axis=1) for j in range(H // TILE_H)], axis=0)
        gt = rng.integers(0, NUM_CLASSES, (H, W), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"city_{i:06d}_000019_leftImg8bit.png"))
        Image.fromarray(gt).save(os.path.join(gt_dir, f"city_{i:06d}_000019_gtFine_labelIds.png"))
    # split-level dirs (city subdirs inside), the reference's convention
    return os.path.join(root, "leftImg8bit", "train"), os.path.join(root, "gtFine", "train")


def _train_kwargs(device_augment):
    return dict(
        learning_rate_schedule=lambda step: 1e-4,
        record_summaries=False,
        save_during_training=False,
        eval_frequency=10**9,
        device_augment=device_augment,
        # a prime the global step never reaches: no config's timed window
        # gets a loss read-back the others do not
        summaries_frequency=999983,
    )


def timed_train(model, generator, *, device_augment, tag):
    """One timed ``train()`` call; sustained img/s over TIMED_STEPS."""
    t0 = time.perf_counter()
    model.train(generator, epochs=1, steps_per_epoch=TIMED_STEPS, **_train_kwargs(device_augment))
    sync(model.device)
    dt = time.perf_counter() - t0
    rate = TIMED_STEPS * BATCH / dt
    log(f"  {tag}: {dt / TIMED_STEPS * 1e3:.1f} ms/step sustained, {rate:.1f} img/s")
    return rate


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image", default=None,
                   help="a picture to tile (default: a seeded synthetic scene)")
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve(args.device)

    from ..data import BatchGenerator, PackedDataset, pack_dataset
    from ..engine.model import FCN8s

    log(f"device: {dev}")
    work = tempfile.mkdtemp(prefix="e2e_input_bench_")
    try:
        tile, tile_source = tile_image(args.image)
        img_dir, gt_dir = build_dataset(work, tile)
        gen = BatchGenerator(
            image_dirs=[img_dir], ground_truth_dirs=[gt_dir],
            image_name_split_separator="leftImg8bit",
            ground_truth_suffix="gtFine_labelIds", num_classes=NUM_CLASSES)
        packed_dir = os.path.join(work, "packed")
        pack_dataset(gen, packed_dir)
        packed = PackedDataset(packed_dir, num_classes=NUM_CLASSES)

        model = FCN8s(num_classes=NUM_CLASSES, device=dev, **MODEL)

        # a ring of preallocated batches with the packed set's content: the
        # same bytes as B and C, with no host work
        n = packed.dataset_size
        ring = [(np.array(packed.images[np.arange(i, i + BATCH) % n]),
                 np.array(packed.labels[np.arange(i, i + BATCH) % n]))
                for i in range(0, n, BATCH)]

        def resident_gen():
            i = 0
            while True:
                yield ring[i % len(ring)]
                i += 1

        # one long-lived generator per config, shared across rounds
        configs = [
            ("resident_floor", "A resident", resident_gen(), DEVICE_AUG),
            ("packed_device_aug", "B packed+device-aug",
             packed.generate(BATCH, convert_to_one_hot=False, seed=0), DEVICE_AUG),
            ("png_device_aug", "C png+device-aug",
             gen.generate(BATCH, convert_to_one_hot=False, seed=0), DEVICE_AUG),
            ("packed_host_aug", "D packed+host-aug",
             packed.generate(BATCH, convert_to_one_hot=False, seed=0, **HOST_AUG), None),
        ]

        log("warmup...")
        for aug in (DEVICE_AUG, None):
            model.train(resident_gen(), epochs=1, steps_per_epoch=WARM_STEPS,
                        **_train_kwargs(aug))
        sync(dev)

        samples = {key: [] for key, *_ in configs}
        for r in range(ROUNDS):
            log(f"round {r + 1}/{ROUNDS}:")
            for key, tag, generator, aug in configs:
                samples[key].append(timed_train(model, generator, device_augment=aug, tag=tag))
        results = {key: max(v) for key, v in samples.items()}  # best img/s
        model.close()

        line = {
            "metric": "e2e_train_images_per_sec_per_chip_1024x512",
            "unit": "images/sec/chip",
            "shape": f"{BATCH}x{H}x{W}",
            "timed_steps": TIMED_STEPS,
            "rounds": ROUNDS,
            **{k: round(v, 2) for k, v in results.items()},
            "samples": {k: [round(x, 1) for x in v] for k, v in samples.items()},
            "packed_vs_resident_pct": round(
                100 * results["packed_device_aug"] / results["resident_floor"], 1),
            "tile_source": tile_source,
        }
        print(json.dumps(line))
        return line
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
