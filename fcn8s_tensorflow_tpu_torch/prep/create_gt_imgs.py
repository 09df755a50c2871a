"""Batch GT-generation entry points. Port of
``fcn8s_tensorflow_tpu/prep/create_gt_imgs.py``, a copy.

The reference's ``cityscapesscripts/preparation/createTrainIdLabelImgs.py``
and ``createTrainIdInstanceImgs.py``: glob all ``*_polygons.json`` under
gtFine/gtCoarse of a Cityscapes root (``CITYSCAPES_DATASET`` by default) and
rasterize ``*_labelTrainIds.png`` / ``*_instanceTrainIds.png`` next to them.

    python -m fcn8s_tensorflow_tpu_torch.prep.create_gt_imgs [labels|instances]
"""

from __future__ import annotations

import glob
import os
import sys

from .rasterize import json_to_instance_img, json_to_label_img


def _find_annotation_files(cityscapes_path: str) -> list[str]:
    search_fine = os.path.join(cityscapes_path, "gtFine", "*", "*", "*_gt*_polygons.json")
    search_coarse = os.path.join(cityscapes_path, "gtCoarse", "*", "*", "*_gt*_polygons.json")
    files = glob.glob(search_fine) + glob.glob(search_coarse)
    files.sort()
    if not files:
        raise RuntimeError(f"Did not find any annotation files under {cityscapes_path}")
    return files


def create_train_id_label_imgs(cityscapes_path: str | None = None, *, quiet: bool = False) -> int:
    """All ``*_polygons.json`` -> ``*_labelTrainIds.png``. Returns count."""
    cityscapes_path = cityscapes_path or os.environ.get("CITYSCAPES_DATASET", ".")
    files = _find_annotation_files(cityscapes_path)
    if not quiet:
        print(f"Processing {len(files)} annotation files")
    for i, f in enumerate(files):
        dst = f.replace("_polygons.json", "_labelTrainIds.png")
        json_to_label_img(f, dst, "trainIds")
        if not quiet:
            print(f"\rProgress: {(i + 1) * 100 / len(files):>4.1f} %", end=" ", flush=True)
    if not quiet:
        print("")
    return len(files)


def create_train_id_instance_imgs(cityscapes_path: str | None = None, *, quiet: bool = False) -> int:
    """All ``*_polygons.json`` -> ``*_instanceTrainIds.png``. Returns count."""
    cityscapes_path = cityscapes_path or os.environ.get("CITYSCAPES_DATASET", ".")
    files = _find_annotation_files(cityscapes_path)
    if not quiet:
        print(f"Processing {len(files)} annotation files")
    for i, f in enumerate(files):
        dst = f.replace("_polygons.json", "_instanceTrainIds.png")
        json_to_instance_img(f, dst, "trainIds")
        if not quiet:
            print(f"\rProgress: {(i + 1) * 100 / len(files):>4.1f} %", end=" ", flush=True)
    if not quiet:
        print("")
    return len(files)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "labels"
    if which == "labels":
        create_train_id_label_imgs()
    elif which == "instances":
        create_train_id_instance_imgs()
    else:
        raise SystemExit("usage: python -m fcn8s_tensorflow_tpu_torch.prep.create_gt_imgs [labels|instances]")
