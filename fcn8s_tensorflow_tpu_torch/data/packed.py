"""Packed binary dataset format: decode once, train forever from memmaps.

Port of ``fcn8s_tensorflow_tpu/data/packed.py``, with its on-disk format:
a directory packed by either package loads in the other. The reference's
answer to slow input pipelines is ``process_all`` — mirror the transformed
dataset back to disk as PNGs — which still pays a PNG decode per image per
epoch. ``pack_dataset`` instead decodes and statically transforms every
image/GT pair ONCE into flat ``.npy`` memmaps, and
``PackedDataset.generate`` then streams batches with no decode work while
running the SAME dynamic augmentation pipeline (same code, same draw order:
``generator.apply_augmentations``) as ``BatchGenerator.generate``, so a
given seed yields byte-identical batches from either backend.

Layout of a packed directory::

    images.npy   (N, H, W, 3) uint8   -- np.lib.format, memmap-friendly
    labels.npy   (N, H, W)    uint8/uint16   [only when GT exists]
    index.json   manifest: format_version, count, shapes, dtypes,
                 static transforms applied at pack time, source file names

Static (epoch-invariant) transforms — color->ID conversion, ID remap,
resize — are applied at pack time; dynamic (random) transforms stay at
``generate`` time, exactly as in ``BatchGenerator``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import augment
from .conversions import convert_between_ids_and_colors, convert_ids_to_one_hot
from .conversions import convert_ids_to_ids as _remap_ids_lut
from .conversions import convert_ids_to_ids_partial as _remap_ids_dict
from .generator import BatchGenerator, DataError, _imread, _pad_to_multiple, \
    apply_augmentations

FORMAT_VERSION = 1
_INDEX_NAME = "index.json"


def pack_dataset(
    generator: BatchGenerator,
    out_dir: str,
    *,
    convert_colors_to_ids=False,
    convert_ids_to_ids=False,
    resize=False,
) -> str:
    """Decode every image/GT pair indexed by ``generator`` (a
    ``BatchGenerator`` — its discovery/pairing/validation is reused as-is)
    into memmap arrays under ``out_dir``.

    ``convert_colors_to_ids`` / ``convert_ids_to_ids`` / ``resize`` take the
    same values as ``BatchGenerator.generate`` and are applied ONCE here, so
    the packed labels are already in their final ID scheme and resolution.
    All images must share one shape after the static transforms (pass
    ``resize`` to force it) — packed storage is a dense array, not a PNG
    forest. Returns ``out_dir``.
    """
    os.makedirs(out_dir, exist_ok=True)
    n = generator.get_num_files()
    has_gt = generator.ground_truth

    images_mm = labels_mm = None
    image_shape = gt_dtype = None
    for i, image_path in enumerate(generator.image_paths):
        image = _imread(image_path)
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        gt_image = None
        if has_gt:
            gt_path = generator.ground_truth_paths[os.path.basename(image_path)]
            gt_image = _imread(gt_path)
            if convert_colors_to_ids is not False:
                gt_image = convert_between_ids_and_colors(
                    gt_image, convert_colors_to_ids, gt_dtype=gt_image.dtype
                )
            if isinstance(convert_ids_to_ids, np.ndarray):
                gt_image = _remap_ids_lut(gt_image, convert_ids_to_ids)
            elif isinstance(convert_ids_to_ids, dict):
                gt_image = _remap_ids_dict(gt_image, convert_ids_to_ids)
        if resize:
            image, gt_image = augment.resize_pair(image, gt_image, resize)

        if images_mm is None:
            image_shape = image.shape
            images_mm = np.lib.format.open_memmap(
                os.path.join(out_dir, "images.npy"), mode="w+",
                dtype=np.uint8, shape=(n,) + image_shape)
            if has_gt:
                gt_dtype = np.uint16 if gt_image.dtype.itemsize > 1 else np.uint8
                labels_mm = np.lib.format.open_memmap(
                    os.path.join(out_dir, "labels.npy"), mode="w+",
                    dtype=gt_dtype, shape=(n,) + image_shape[:2])
        if image.shape != image_shape:
            raise DataError(
                f"'{image_path}' has shape {image.shape} but the pack is "
                f"{image_shape} — pass resize=(H, W) to pack_dataset to "
                f"force a uniform size.")
        images_mm[i] = image
        if has_gt:
            if gt_image.shape[:2] != image_shape[:2]:
                raise DataError(
                    f"GT for '{image_path}' has shape {gt_image.shape[:2]} "
                    f"!= image shape {image_shape[:2]}.")
            labels_mm[i] = gt_image

    images_mm.flush()
    if labels_mm is not None:
        labels_mm.flush()
    index = {
        "format_version": FORMAT_VERSION,
        "count": n,
        "image_shape": list(image_shape),
        "has_ground_truth": bool(has_gt),
        "label_dtype": np.dtype(gt_dtype).name if has_gt else None,
        "static_transforms": {
            "convert_colors_to_ids": convert_colors_to_ids is not False,
            "convert_ids_to_ids": convert_ids_to_ids is not False
            and not isinstance(convert_ids_to_ids, bool),
            "resize": list(resize) if resize else False,
        },
        "sources": [os.path.basename(p) for p in generator.image_paths],
    }
    with open(os.path.join(out_dir, _INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2)
    return out_dir


class PackedDataset:
    """Batch generator over a directory written by ``pack_dataset``, with
    ``BatchGenerator``'s ``generate`` semantics (same dynamic augmentations,
    same draw order, same shuffle/shard/epoch logic) minus the per-epoch
    decode cost. ``num_classes`` is only needed for one-hot output."""

    def __init__(self, directory: str, num_classes: int | None = None):
        index_path = os.path.join(directory, _INDEX_NAME)
        if not os.path.isfile(index_path):
            raise DataError(f"'{directory}' is not a packed dataset "
                            f"(missing {_INDEX_NAME}).")
        with open(index_path) as f:
            self.index = json.load(f)
        version = self.index.get("format_version")
        if version != FORMAT_VERSION:
            raise DataError(
                f"packed dataset at '{directory}' has format_version "
                f"{version}; this library reads version {FORMAT_VERSION}.")
        self.directory = directory
        self.num_classes = num_classes
        self.images = np.load(os.path.join(directory, "images.npy"),
                              mmap_mode="r")
        self.ground_truth = self.index["has_ground_truth"]
        self.labels = (np.load(os.path.join(directory, "labels.npy"),
                               mmap_mode="r")
                       if self.ground_truth else None)
        self.dataset_size = self.index["count"]
        if self.images.shape[0] != self.dataset_size:
            raise DataError(
                f"index.json says {self.dataset_size} images but images.npy "
                f"holds {self.images.shape[0]}.")

    def get_num_files(self) -> int:
        return self.dataset_size

    # ------------------------------------------------------------------
    def class_pixel_counts(self, num_classes=None, *, ignore_label=None):
        """Per-class pixel counts over the packed labels, shape
        ``(num_classes,)`` uint64 — the memmap-backed twin of
        ``BatchGenerator.class_pixel_counts`` (IDs are already remapped at
        pack time, so there is no LUT argument)."""
        if not self.ground_truth:
            raise DataError("class_pixel_counts requires ground truth maps.")
        num_classes = num_classes if num_classes is not None else self.num_classes
        if num_classes is None:
            raise ValueError("num_classes is required (not set on this dataset)")
        counts = np.zeros(num_classes, np.uint64)
        for i in range(self.dataset_size):
            ids = np.asarray(self.labels[i]).ravel()
            per = np.bincount(ids, minlength=int(ids.max(initial=0)) + 1)
            if ignore_label is not None and ignore_label < len(per):
                per[ignore_label] = 0
            if len(per) > num_classes and per[num_classes:].any():
                bad = int(np.nonzero(per[num_classes:])[0][0]) + num_classes
                raise DataError(
                    f"Packed labels[{i}] contain class id {bad} >= "
                    f"num_classes={num_classes} (and != ignore_label).")
            counts[: len(per)] += per[:num_classes].astype(np.uint64)
        return counts

    # ------------------------------------------------------------------
    def generate(
        self,
        batch_size,
        convert_to_one_hot=True,
        void_class_id=None,
        random_crop=False,
        crop=False,
        resize=False,
        brightness=False,
        flip=False,
        translate=False,
        scale=False,
        gray=False,
        contrast=False,
        saturation=False,
        hue=False,
        gamma=False,
        shuffle=True,
        seed=None,
        pad_to_multiple=None,
        shard=None,
    ):
        """Infinite batch iterator with ``BatchGenerator.generate``'s exact
        dynamic-augmentation semantics (shared ``apply_augmentations`` code;
        for a given ``seed`` the two backends yield byte-identical batches). Color/ID conversions happen at pack time, so
        there are no ``convert_*_to_ids`` arguments here."""
        if convert_to_one_hot and not self.ground_truth:
            raise ValueError("Cannot convert ground truth data: No ground truth data given.")
        if convert_to_one_hot and self.num_classes is None:
            raise ValueError(
                "One-hot conversion requires that you pass an integer value for `num_classes` "
                "in the constructor, but `num_classes` is `None`."
            )
        if hue and len(hue) != 2:
            raise ValueError(
                f"hue takes (max_delta, prob) — the rotation is drawn from "
                f"U(-max_delta, +max_delta), so there is no (lo, hi) pair; "
                f"got {hue}")
        if shard is not None:
            shard_index, shard_count = shard
            if not (0 <= shard_index < shard_count):
                raise ValueError(
                    f"shard must be (index, count) with 0 <= index < count, got {shard}")
            if shuffle and seed is None:
                raise ValueError(
                    "shard with shuffle=True requires a seed (hosts must draw "
                    "the same epoch permutation to keep shards disjoint)")
            if self.dataset_size < shard_count:
                raise DataError(
                    f"shard count {shard_count} exceeds the dataset size "
                    f"{self.dataset_size}: some hosts would have no data")
            shuffle_rng = np.random.default_rng(seed)
            rng = np.random.default_rng(None if seed is None else (seed, shard_index))
        else:
            rng = np.random.default_rng(seed)
            shuffle_rng = rng  # byte-identical to BatchGenerator's stream

        # a Python list (not ndarray) so shuffle_rng consumes exactly the
        # draws BatchGenerator's path-list shuffle does — the equivalence
        # guarantee depends on it
        order = list(range(self.dataset_size))

        def local_slice():
            sl = order[shard_index::shard_count]
            epoch_len = -(-len(order) // shard_count)
            return sl + sl[: epoch_len - len(sl)]

        if shuffle:
            shuffle_rng.shuffle(order)
        local = local_slice() if shard is not None else order
        current = 0

        while True:
            if current >= len(local):
                if shuffle:
                    shuffle_rng.shuffle(order)
                local = local_slice() if shard is not None else order
                current = 0

            images, gt_images = [], []
            for idx in local[current : current + batch_size]:
                image = np.array(self.images[idx])  # memmap -> private copy
                gt_image = (np.array(self.labels[idx])
                            if self.ground_truth else None)
                image, gt_image = apply_augmentations(
                    image, gt_image, rng,
                    random_crop=random_crop, crop=crop, resize=resize,
                    brightness=brightness, contrast=contrast,
                    saturation=saturation, hue=hue, gamma=gamma,
                    flip=flip, translate=translate, scale=scale,
                    gray=gray, void_class_id=void_class_id,
                )
                if pad_to_multiple:
                    image, gt_image = _pad_to_multiple(
                        image, gt_image, pad_to_multiple, void_class_id or 0
                    )
                if convert_to_one_hot:
                    gt_image = convert_ids_to_one_hot(gt_image, self.num_classes)
                images.append(image)
                if self.ground_truth:
                    gt_images.append(gt_image)
            current += batch_size

            if self.ground_truth:
                yield np.array(images), np.array(gt_images)
            else:
                yield np.array(images)
