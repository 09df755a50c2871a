"""KITTI road-segmentation generator (2 classes: background / road).

Port of ``fcn8s_tensorflow_tpu/data/kitti.py``, with OpenCV's resizes
computed by ``ops/resize_host.py``: the same batches byte for byte. It
re-implements `data_generator/batch_generator_KITTI.py:8-107`:
images paired with GT by inserting ``_road_`` into the filename, road pixels
identified by NOT matching the background color [255, 0, 0] in the GT color
image, yielding a 2-channel one-hot (background, road).
"""

from __future__ import annotations

import os
import re
from glob import glob

import numpy as np
from PIL import Image

from ..ops.resize_host import resize_linear_u8, resize_nearest

BACKGROUND_COLOR = np.array([255, 0, 0], dtype=np.uint8)


def batch_generator(
    batch_size,
    image_dir,
    gt_dir=None,
    image_file_extension="png",
    resize=False,
    flip=False,
    shuffle=True,
    seed=None,
    one_hot=True,
):
    """Infinite (images, gt_one_hot) batches. ``resize`` is (height, width);
    ``flip`` a probability; ``one_hot=False`` yields uint8 ID maps
    (0=background, 1=road) for the device-side one-hot path."""
    image_paths = sorted(glob(os.path.join(image_dir, "*." + image_file_extension)))
    if not image_paths:
        raise ValueError(f"No images found in {image_dir}")

    gt_paths = {}
    if gt_dir is not None:
        for image_path in image_paths:
            name = os.path.basename(image_path)
            # e.g. um_000042.png -> um_road_000042.png (reference `:39-42`)
            gt_name = re.sub(r"^(\w+?)_(\d+)", r"\1_road_\2", name)
            gt_paths[name] = os.path.join(gt_dir, gt_name)

    rng = np.random.default_rng(seed)
    order = list(image_paths)
    if shuffle:
        rng.shuffle(order)
    current = 0

    while True:
        if current >= len(order):
            if shuffle:
                rng.shuffle(order)
            current = 0

        images, gts = [], []
        for image_path in order[current : current + batch_size]:
            image = np.asarray(Image.open(image_path).convert("RGB"))
            gt = None
            if gt_dir is not None:
                gt_rgb = np.asarray(
                    Image.open(gt_paths[os.path.basename(image_path)]).convert("RGB")
                )
                road = ~np.all(gt_rgb == BACKGROUND_COLOR, axis=-1)
                gt = road.astype(np.uint8)  # 0 = background, 1 = road

            if resize:
                image = resize_linear_u8(image, resize)
                if gt is not None:
                    gt = resize_nearest(gt, resize)

            if flip and rng.random() >= (1 - flip):
                image = image[:, ::-1]
                if gt is not None:
                    gt = gt[:, ::-1]

            images.append(image)
            if gt is not None:
                if one_hot:
                    gts.append(np.stack([gt == 0, gt == 1], axis=-1).astype(np.int32))
                else:
                    gts.append(gt)

        current += batch_size
        if gt_dir is not None:
            yield np.array(images), np.array(gts)
        else:
            yield np.array(images)
