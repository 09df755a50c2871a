"""Host input pipeline A/B: the PNG-decoding ``BatchGenerator`` against
``PackedDataset`` memmaps (``data/packed.py``), the same augmentation
config, batches/sec. Port of ``benchmarks/packed_input_bench.py``; host
only (no device), the same tree byte for byte.

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.packed_input_bench
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
from PIL import Image

N_IMAGES = 16
H, W = 512, 256
BATCH = 4
N_BATCHES = 20
AUG = dict(brightness=(0.5, 1.5, 0.5), flip=0.5,
           translate=((1, 8), (1, 8), 0.5), scale=(0.8, 1.2, 0.5))


def build_tree(root: str):
    from ..data import BatchGenerator

    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "images", "city")
    gt_dir = os.path.join(root, "gt", "city")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    for i in range(N_IMAGES):
        stem = f"city_{i:06d}_000019"
        Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"{stem}_leftImg8bit.png"))
        Image.fromarray(rng.integers(0, 20, (H, W), dtype=np.uint8)).save(
            os.path.join(gt_dir, f"{stem}_gtFine_labelIds.png"))
    return BatchGenerator(
        image_dirs=[os.path.join(root, "images")],
        ground_truth_dirs=[os.path.join(root, "gt")],
        image_name_split_separator="leftImg8bit",
        ground_truth_suffix="gtFine_labelIds",
        num_classes=20,
    )


def time_stream(make_iter) -> float:
    """Batches/sec over N_BATCHES after a 3-batch warm-up."""
    it = make_iter()
    for _ in range(3):
        next(it)
    t0 = time.perf_counter()
    for _ in range(N_BATCHES):
        next(it)
    return N_BATCHES / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    from ..data import PackedDataset, pack_dataset

    del argv
    with tempfile.TemporaryDirectory() as root:
        gen = build_tree(root)
        ds = PackedDataset(pack_dataset(gen, os.path.join(root, "packed")), num_classes=20)
        results = {}
        for name, kwargs in [("plain", {}), ("augmented", AUG)]:
            cfg = dict(batch_size=BATCH, convert_to_one_hot=False, void_class_id=0,
                       shuffle=True, seed=1, **kwargs)
            png = time_stream(lambda: gen.generate(**cfg))
            packed = time_stream(lambda: ds.generate(**cfg))
            results[name] = {"png_batches_per_s": round(png, 1),
                             "packed_batches_per_s": round(packed, 1),
                             "speedup": round(packed / png, 2)}
            print(f"{name:>10}: png {png:6.1f} b/s  packed {packed:6.1f} b/s "
                  f"({packed / png:.2f}x)  [batch {BATCH} @ {H}x{W}]")
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
