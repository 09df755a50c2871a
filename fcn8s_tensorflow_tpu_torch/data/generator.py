"""Dataset indexing, pairing, and the online/offline batch generator.

Port of ``fcn8s_tensorflow_tpu/data/generator.py``, itself a
re-implementation of the reference ``BatchGenerator``
(`data_generator/batch_generator.py:16-468`), with the same
public API — ``__init__(image_dirs, ...)``, ``generate(batch_size, ...)``,
``process_all(...)``, ``get_num_files()``, ``class_pixel_counts`` — the
same discovery/pairing rules (recursive ``os.walk``, GT filename =
left-of-separator + suffix + extension, existence/count validation raising
``DataError``), and the same ``numpy.random.Generator`` streams: for one
tree and seed it yields the JAX package's batches byte for byte, with
``workers`` and ``shard`` too. The transforms are ``data/augment.py``'s,
which compute OpenCV's results without OpenCV.

Extras beyond the reference, as in the JAX package:

* ``seed`` makes the whole augmentation stream deterministic (the reference
  mutates global RNG state).
* ``convert_to_one_hot=False`` (with ``num_classes`` set) yields uint8 ID
  maps instead of one-hot: the train step expands them on the card, which
  cuts host->device traffic by num_classes x.
* ``pad_to_multiple`` pads H/W up with void so any source size feeds the
  stride-32 model.

``process_all`` prints a plain ``Processing images: k/N`` progress line
where the JAX package draws a tqdm bar.
"""

from __future__ import annotations

import os
import pathlib
from glob import glob
from math import ceil

import numpy as np
from PIL import Image

from . import augment
# aliased: `convert_ids_to_ids` is also a kwarg name in generate() (API parity
# with the reference), which would shadow the function.
from .conversions import convert_between_ids_and_colors, convert_ids_to_one_hot
from .conversions import convert_ids_to_ids as _remap_ids_lut
from .conversions import convert_ids_to_ids_partial as _remap_ids_dict


class DataError(Exception):
    """Dataset inconsistency (missing GT pair, empty dataset, count mismatch)
    — reference `batch_generator.py:490-494`."""

    def __init__(self, value):
        self.value = value

    def __str__(self):
        return repr(self.value)


def _imread(path: str) -> np.ndarray:
    return np.asarray(Image.open(path))


def _imwrite(path: str, arr: np.ndarray) -> None:
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    Image.fromarray(arr).save(path)


def apply_augmentations(
    image,
    gt_image,
    prng,
    *,
    random_crop=False,
    crop=False,
    resize=False,
    brightness=False,
    contrast=False,
    saturation=False,
    hue=False,
    gamma=False,
    flip=False,
    translate=False,
    scale=False,
    gray=False,
    void_class_id=None,
):
    """The reference's per-image dynamic transform pipeline, in its exact
    order and with its exact random-draw sequence
    (`data_generator/batch_generator.py:268-387`), as one
    shared function: ``BatchGenerator.generate`` and
    ``PackedDataset.generate`` both run THIS code, so a given ``(seed,
    image order)`` produces byte-identical augmented batches from either
    storage backend."""
    if random_crop:
        image, gt_image = augment.random_crop_with_void(
            prng, image, gt_image, random_crop, void_class_id
        )
    if crop:
        image, gt_image = augment.fixed_crop(image, gt_image, crop)
    if resize:
        image, gt_image = augment.resize_pair(image, gt_image, resize)
    if brightness and prng.random() >= (1 - brightness[2]):
        image = augment.brightness_hsv(prng, image, brightness[0], brightness[1])
    # beyond-reference photometric extras (device twins in
    # ops/augment_device.py), applied after brightness
    if contrast and prng.random() >= (1 - contrast[2]):
        image = augment.contrast(prng, image, contrast[0], contrast[1])
    if saturation and prng.random() >= (1 - saturation[2]):
        image = augment.saturation(prng, image, saturation[0], saturation[1])
    if hue and prng.random() >= (1 - hue[1]):
        image = augment.hue_rotate(prng, image, hue[0])
    if gamma and prng.random() >= (1 - gamma[2]):
        image = augment.gamma(prng, image, gamma[0], gamma[1])
    if flip and prng.random() >= (1 - flip):
        image, gt_image = augment.horizontal_flip(image, gt_image)
    if translate and prng.random() >= (1 - translate[2]):
        image, gt_image = augment.translate(
            prng, image, gt_image, translate[0], translate[1], void_class_id
        )
    if scale and prng.random() >= (1 - scale[2]):
        image, gt_image = augment.scale_zoom(
            prng, image, gt_image, scale[0], scale[1], void_class_id
        )
    if gray:
        image = augment.grayscale(image)
    return image, gt_image


class BatchGenerator:
    """See module docstring. Constructor arguments match the reference
    (`batch_generator.py:16-130`)."""

    def __init__(
        self,
        image_dirs,
        image_file_extension="png",
        ground_truth_dirs=None,
        image_name_split_separator=None,
        ground_truth_suffix=None,
        check_existence=True,
        num_classes=None,
        root_dir=None,
        export_dir=None,
    ):
        self.image_dirs = image_dirs
        self.ground_truth_dirs = ground_truth_dirs
        self.root_dir = root_dir
        self.export_dir = export_dir
        self.image_paths = []
        self.ground_truth_paths = {}
        self.num_classes = num_classes
        self.ground_truth = False

        if ground_truth_dirs is not None and len(image_dirs) != len(ground_truth_dirs):
            raise ValueError(
                "`image_dirs` and `ground_truth_dirs` must contain the same number of elements."
            )

        ext = image_file_extension.lower()

        for i, image_dir in enumerate(image_dirs):
            for image_dir_path, _, _ in os.walk(image_dir, topdown=True):
                found = sorted(glob(os.path.join(image_dir_path, "*." + ext)))
                if not found:
                    continue
                self.image_paths += found
                if ground_truth_dirs is None:
                    continue
                # GT lives under <gt_dir>/<basename of current image subdir>/
                gt_subdir = os.path.basename(os.path.normpath(image_dir_path))
                gt_dir_path = os.path.join(ground_truth_dirs[i], gt_subdir)
                for image_path in found:
                    image_name = os.path.basename(image_path)
                    left_part = image_name.split(image_name_split_separator, 1)[0]
                    gt_name = left_part + ground_truth_suffix + "." + ext
                    gt_path = os.path.join(gt_dir_path, gt_name)
                    if check_existence and not os.path.isfile(gt_path):
                        raise DataError(
                            f"Missing ground truth: expected '{gt_path}' to pair with "
                            f"image '{image_path}', but no such file exists."
                        )
                    self.ground_truth_paths[image_name] = gt_path

        self.dataset_size = len(self.image_paths)
        if self.dataset_size == 0:
            raise DataError(
                f"Found zero '*.{ext}' files under the configured image directories."
            )
        if ground_truth_dirs is not None and len(self.ground_truth_paths) != self.dataset_size:
            raise DataError(
                f"Image/ground-truth count mismatch: {self.dataset_size} images but "
                f"{len(self.ground_truth_paths)} ground truth maps were paired."
            )
        if self.ground_truth_paths:
            self.ground_truth = True

    def get_num_files(self) -> int:
        return self.dataset_size

    # ------------------------------------------------------------------
    def class_pixel_counts(self, num_classes=None, *, ids_to_classes=None,
                           ignore_label=None):
        """One pass over the paired ground-truth ID maps -> per-class pixel
        counts, shape ``(num_classes,)`` uint64 (beyond the reference; feeds
        ``ops.losses.median_frequency_class_weights`` for
        ``train(class_weights=...)``).

        ``ids_to_classes``: optional LUT array applied to raw GT ids first
        (e.g. ``labels.IDS_TO_TRAINIDS_ORIGINAL_ARRAY`` to scan labelId maps
        under the 255-ignore trainId scheme). ``ignore_label`` pixels are
        excluded from the counts; any other id outside ``[0, num_classes)``
        raises ``DataError`` naming the offending file — the same
        fail-loud-on-bad-labels stance as the pairing validation above.
        """
        if not self.ground_truth:
            raise DataError("class_pixel_counts requires ground truth maps.")
        num_classes = num_classes if num_classes is not None else self.num_classes
        if num_classes is None:
            raise ValueError("num_classes is required (not set on this generator)")
        lut = None if ids_to_classes is None else np.asarray(ids_to_classes)
        counts = np.zeros(num_classes, np.uint64)
        for gt_path in self.ground_truth_paths.values():
            ids = _imread(gt_path)
            if ids.ndim == 3:  # RGB-saved ID map: all channels equal
                ids = ids[..., 0]
            ids = ids.ravel()
            if lut is not None:
                if ids.max(initial=0) >= len(lut):
                    raise DataError(
                        f"Ground truth '{gt_path}' contains id {int(ids.max())} "
                        f"outside the ids_to_classes LUT (length {len(lut)})."
                    )
                ids = lut[ids]
            per = np.bincount(ids, minlength=int(ids.max(initial=0)) + 1)
            if ignore_label is not None and ignore_label < len(per):
                per[ignore_label] = 0
            if len(per) > num_classes and per[num_classes:].any():
                bad = int(np.nonzero(per[num_classes:])[0][0]) + num_classes
                raise DataError(
                    f"Ground truth '{gt_path}' contains class id {bad} >= "
                    f"num_classes={num_classes} (and != ignore_label)."
                )
            counts[: len(per)] += per[:num_classes].astype(np.uint64)
        return counts

    # ------------------------------------------------------------------
    def generate(
        self,
        batch_size,
        convert_colors_to_ids=False,
        convert_ids_to_ids=False,
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
        to_disk=False,
        shuffle=True,
        seed=None,
        pad_to_multiple=None,
        workers=1,
        shard=None,
    ):
        """Infinite batch iterator with the reference's exact transform
        pipeline and argument semantics (`batch_generator.py:140-417`);
        see the module docstring for the extras.

        Beyond-reference photometric options (applied after ``brightness``,
        images only; device twins in ``ops/augment_device.py``):
        ``contrast`` / ``saturation`` / ``gamma`` take ``(lo, hi, prob)``
        like ``brightness``; ``hue`` takes ``(max_delta, prob)`` — the
        rotation is drawn from U(-max_delta, +max_delta) turns, so there
        is no (lo, hi) pair (a 3-tuple raises).

        ``workers > 1``: run the per-IMAGE pipeline (PNG decode and the
        numpy transforms, which release the GIL for most of their work) on a
        thread pool. Each image gets a child RNG derived in path order from
        the seeded stream, so a given ``seed`` is deterministic and the
        result is independent of the worker count for ANY workers > 1 — but
        the random draws differ from the sequential ``workers=1`` stream.

        ``shard=(index, count)``: multi-host input sharding — host
        ``index`` of ``count`` yields only its disjoint slice of each epoch,
        so a group of processes feeds disjoint data without coordination. Every host shuffles the FULL path list
        with an isolated generator seeded by ``seed`` alone (identical
        permutation on every host, so shards stay disjoint and cover each
        epoch exactly), then walks ``paths[index::count]``; augmentation
        draws come from a per-host generator seeded by ``(seed, index)``.
        ``shuffle=True`` therefore requires a ``seed``: unseeded hosts
        would draw different permutations and the shards would overlap.
        When the dataset size doesn't divide ``count``, short slices pad
        by wrapping within themselves to the common epoch length
        ``ceil(n/count)`` (the torch ``DistributedSampler`` convention) —
        every host wraps and reshuffles at the same iteration, so the
        lockstep permutations survive uneven splits; a host duplicates at
        most one of its own images per epoch and shards stay disjoint."""
        if (convert_to_one_hot or convert_colors_to_ids is not False or convert_ids_to_ids is not False) and not self.ground_truth:
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
            # Isolated shuffle stream (identical across hosts) + per-host
            # augmentation stream: local draw counts differ per host, so
            # sharing one generator would desynchronize the permutations.
            shuffle_rng = np.random.default_rng(seed)
            rng = np.random.default_rng(None if seed is None else (seed, shard_index))
        else:
            rng = np.random.default_rng(seed)
            shuffle_rng = rng  # byte-identical legacy stream
        _pool = []

        def executor():
            if not _pool:
                from concurrent.futures import ThreadPoolExecutor

                _pool.append(ThreadPoolExecutor(max_workers=workers))
            return _pool[0]

        image_paths = list(self.image_paths)
        if shard is not None and len(image_paths) < shard_count:
            raise DataError(
                f"shard count {shard_count} exceeds the dataset size "
                f"{len(image_paths)}: some hosts would have no data")

        def local_slice():
            """This host's slice, padded by wrapping within itself to the
            common per-host epoch length ceil(n/count): ALL hosts then hit
            the epoch boundary (and reshuffle) at the same iteration, so
            the shared shuffle stream stays in lockstep even when the
            dataset size doesn't divide the shard count."""
            sl = image_paths[shard_index::shard_count]
            epoch_len = -(-len(image_paths) // shard_count)
            return sl + sl[: epoch_len - len(sl)]

        if shuffle:
            shuffle_rng.shuffle(image_paths)
        local_paths = local_slice() if shard is not None else image_paths
        current = 0

        # try/finally (not only GeneratorExit): a raising process_one
        # (e.g. unreadable image file) must also shut the worker pool
        # down instead of leaking threads until GC
        try:
            while True:
                images, gt_images = [], []

                if current >= len(local_paths):
                    if shuffle:
                        shuffle_rng.shuffle(image_paths)
                        if shard is not None:
                            local_paths = local_slice()
                    current = 0

                def process_one(image_path, prng):
                    image = _imread(image_path)
                    if image.ndim == 2:
                        image = np.stack([image] * 3, axis=-1)
                    gt_image, gt_path = None, None

                    if self.ground_truth:
                        gt_path = self.ground_truth_paths[os.path.basename(image_path)]
                        gt_image = _imread(gt_path)
                        gt_dtype = gt_image.dtype

                        if convert_colors_to_ids is not False:
                            gt_image = convert_between_ids_and_colors(
                                gt_image, convert_colors_to_ids, gt_dtype=gt_dtype
                            )
                        if convert_ids_to_ids is not False:
                            if isinstance(convert_ids_to_ids, np.ndarray):
                                gt_image = _remap_ids_lut(gt_image, convert_ids_to_ids)
                            elif isinstance(convert_ids_to_ids, dict):
                                gt_image = _remap_ids_dict(gt_image, convert_ids_to_ids)

                    # --- augmentation pipeline, reference order (shared
                    # with PackedDataset.generate — see apply_augmentations)
                    image, gt_image = apply_augmentations(
                        image, gt_image, prng,
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

                    if to_disk:
                        self._save_mirrored(image_path, image)
                        if self.ground_truth:
                            self._save_mirrored(gt_path, gt_image)

                    if convert_to_one_hot:
                        gt_image = convert_ids_to_one_hot(gt_image, self.num_classes)

                    return image, gt_image

                chunk = local_paths[current : current + batch_size]
                if workers > 1:
                    # per-image child RNGs derived in path order: deterministic
                    # for a given seed, independent of the worker count
                    prngs = [np.random.default_rng(rng.integers(2**63)) for _ in chunk]
                    results = list(executor().map(process_one, chunk, prngs))
                else:
                    results = [process_one(path, rng) for path in chunk]
                for image, gt_image in results:
                    images.append(image)
                    if self.ground_truth:
                        gt_images.append(gt_image)

                current += batch_size

                if self.ground_truth:
                    yield np.array(images), np.array(gt_images)
                else:
                    yield np.array(images)
        finally:
            if _pool:
                _pool[0].shutdown(wait=False)

    # ------------------------------------------------------------------
    def process_all(
        self,
        convert_colors_to_ids=False,
        convert_ids_to_ids=False,
        convert_to_one_hot=False,
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
        batch_size=1,
    ):
        """Offline preprocessing: run the whole dataset once through
        ``generate(to_disk=True, shuffle=False)``, mirroring the source tree
        under ``export_dir`` (reference `batch_generator.py:419-468`)."""
        if self.export_dir is None or self.root_dir is None:
            raise ValueError("process_all requires `root_dir` and `export_dir` in the constructor.")
        it = self.generate(
            batch_size=batch_size,
            convert_colors_to_ids=convert_colors_to_ids,
            convert_ids_to_ids=convert_ids_to_ids,
            convert_to_one_hot=convert_to_one_hot,
            void_class_id=void_class_id,
            random_crop=random_crop,
            crop=crop,
            resize=resize,
            brightness=brightness,
            flip=flip,
            translate=translate,
            scale=scale,
            gray=gray,
            contrast=contrast,
            saturation=saturation,
            hue=hue,
            gamma=gamma,
            to_disk=True,
            shuffle=False,
        )
        total = ceil(self.dataset_size / batch_size)
        for done in range(1, total + 1):
            next(it)
            print(f"\rProcessing images: {done}/{total}", end="", flush=True)
        print()

    def _save_mirrored(self, src_path: str, arr: np.ndarray) -> None:
        out_path = os.path.join(self.export_dir, os.path.relpath(src_path, start=self.root_dir))
        pathlib.Path(os.path.dirname(out_path)).mkdir(parents=True, exist_ok=True)
        _imwrite(out_path, arr)


def _pad_to_multiple(image, gt_image, multiple, void_class_id):
    """Pad H/W up to the next multiple (bottom/right), image with black,
    GT with void — makes arbitrary sizes stride-32-safe."""
    h, w = image.shape[:2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return image, gt_image
    image = np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="constant")
    if gt_image is not None:
        gt_image = np.pad(
            gt_image, ((0, ph), (0, pw)), mode="constant", constant_values=void_class_id
        )
    return image, gt_image
