"""Instance representation and extraction.

Port of ``fcn8s_tensorflow_tpu/evaluation/instance.py``, a copy (pure numpy
and PIL). The reference's ``cityscapesscripts/evaluation/instance.py:6-50``
and `instances2dict.py:14-53`: Cityscapes encodes instances as
``labelId * 1000 + n`` in the instanceIds PNG (ids < 1000 are stuff/group
regions carrying the bare label id).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from ..labels.cityscapes import id2label, labels


class Instance:
    """One ground-truth instance: id, label, pixel count, optional distance
    stats (medDist/distConf default to the no-distance sentinel values)."""

    def __init__(self, img: np.ndarray | None = None, inst_id: int = -1):
        self.instID = 0
        self.labelID = 0
        self.pixelCount = 0
        self.medDist = -1
        self.distConf = 0.0
        if inst_id == -1:
            return
        self.instID = int(inst_id)
        self.labelID = self.get_label_id(inst_id)
        if img is not None:
            self.pixelCount = int(np.count_nonzero(img == inst_id))

    @staticmethod
    def get_label_id(inst_id: int) -> int:
        return int(inst_id) if inst_id < 1000 else int(inst_id // 1000)

    def to_dict(self) -> dict:
        return {
            "instID": self.instID,
            "labelID": self.labelID,
            "pixelCount": self.pixelCount,
            "medDist": self.medDist,
            "distConf": self.distConf,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "Instance":
        inst = cls()
        inst.instID = int(data["instID"])
        inst.labelID = int(data["labelID"])
        inst.pixelCount = int(data["pixelCount"])
        if "medDist" in data:
            inst.medDist = float(data["medDist"]) if data["medDist"] is not None else -1
            inst.distConf = float(data["distConf"])
        return inst

    def __repr__(self):
        return f"({self.instID})"


def instances_to_dict(image_file_list, verbose: bool = False) -> dict:
    """{abs image path: {label name: [instance dicts]}} for each instanceIds
    PNG. Single pass over np.unique per image (the reference re-scans the
    image per unique id; we count all ids at once)."""
    if not isinstance(image_file_list, list):
        image_file_list = [image_file_list]
    out = {}
    for i, file_name in enumerate(image_file_list):
        img = np.array(Image.open(file_name))
        instances = {label.name: [] for label in labels}
        ids, counts = np.unique(img, return_counts=True)
        for inst_id, count in zip(ids.tolist(), counts.tolist()):
            inst = Instance(None, inst_id)
            inst.pixelCount = int(count)
            instances[id2label[inst.labelID].name].append(inst.to_dict())
        out[os.path.abspath(file_name)] = instances
        if verbose:
            print(f"\rImages Processed: {i + 1}", end=" ", flush=True)
    if verbose:
        print("")
    return out
