"""Cityscapes label registry. Port of
``fcn8s_tensorflow_tpu/labels/cityscapes.py``, a copy: the tables are plain
data (the reference's ``cityscapesscripts/helpers/labels.py:15-218``), and
``tests/test_torch_offline_eval.py`` holds every table equal to the JAX
package's. Two trainId schemes are provided:

* ``labels`` — the *modified* scheme the reference trains with: all
  void/ignored classes collapse onto trainId 0 ("background"), the 19
  evaluated classes get trainIds 1..19, giving ``NUM_TRAIN_CLASSES = 20``
  (reference `labels.py:62-99`).
* ``labels_original`` — the upstream Cityscapes scheme with trainId 255 for
  ignored classes and 0..18 for evaluated ones (reference
  `labels_original.py:63-97`), needed by the offline benchmark evaluators.

All lookup tables are plain data; the numpy LUT arrays remap ids in one
vectorized gather on the host.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

# name / id / trainId / category / categoryId / hasInstances / ignoreInEval / color
Label = namedtuple(
    "Label",
    ["name", "id", "trainId", "category", "categoryId", "hasInstances", "ignoreInEval", "color"],
)

# ---------------------------------------------------------------------------
# Modified trainId scheme (what the training framework uses): void -> 0,
# evaluated classes -> 1..19. Mirrors reference labels.py:62-99.
# ---------------------------------------------------------------------------
labels = [
    Label("unlabeled",            0,  0, "void",         0, False, True,  (0, 0, 0)),
    Label("ego vehicle",          1,  0, "void",         0, False, True,  (0, 0, 0)),
    Label("rectification border", 2,  0, "void",         0, False, True,  (0, 0, 0)),
    Label("out of roi",           3,  0, "void",         0, False, True,  (0, 0, 0)),
    Label("static",               4,  0, "void",         0, False, True,  (0, 0, 0)),
    Label("dynamic",              5,  0, "void",         0, False, True,  (111, 74, 0)),
    Label("ground",               6,  0, "void",         0, False, True,  (81, 0, 81)),
    Label("road",                 7,  1, "flat",         1, False, False, (128, 64, 128)),
    Label("sidewalk",             8,  2, "flat",         1, False, False, (244, 35, 232)),
    Label("parking",              9,  0, "flat",         1, False, True,  (250, 170, 160)),
    Label("rail track",          10,  0, "flat",         1, False, True,  (230, 150, 140)),
    Label("building",            11,  3, "construction", 2, False, False, (70, 70, 70)),
    Label("wall",                12,  4, "construction", 2, False, False, (102, 102, 156)),
    Label("fence",               13,  5, "construction", 2, False, False, (190, 153, 153)),
    Label("guard rail",          14,  0, "construction", 2, False, True,  (180, 165, 180)),
    Label("bridge",              15,  0, "construction", 2, False, True,  (150, 100, 100)),
    Label("tunnel",              16,  0, "construction", 2, False, True,  (150, 120, 90)),
    Label("pole",                17,  6, "object",       3, False, False, (153, 153, 153)),
    Label("polegroup",           18,  0, "object",       3, False, True,  (153, 153, 153)),
    Label("traffic light",       19,  7, "object",       3, False, False, (250, 170, 30)),
    Label("traffic sign",        20,  8, "object",       3, False, False, (220, 220, 0)),
    Label("vegetation",          21,  9, "nature",       4, False, False, (107, 142, 35)),
    Label("terrain",             22, 10, "nature",       4, False, False, (152, 251, 152)),
    Label("sky",                 23, 11, "sky",          5, False, False, (70, 130, 180)),
    Label("person",              24, 12, "human",        6, True,  False, (220, 20, 60)),
    Label("rider",               25, 13, "human",        6, True,  False, (255, 0, 0)),
    Label("car",                 26, 14, "vehicle",      7, True,  False, (0, 0, 142)),
    Label("truck",               27, 15, "vehicle",      7, True,  False, (0, 0, 70)),
    Label("bus",                 28, 16, "vehicle",      7, True,  False, (0, 60, 100)),
    Label("caravan",             29,  0, "vehicle",      7, True,  True,  (0, 0, 90)),
    Label("trailer",             30,  0, "vehicle",      7, True,  True,  (0, 0, 110)),
    Label("train",               31, 17, "vehicle",      7, True,  False, (0, 80, 100)),
    Label("motorcycle",          32, 18, "vehicle",      7, True,  False, (0, 0, 230)),
    Label("bicycle",             33, 19, "vehicle",      7, True,  False, (119, 11, 32)),
    Label("license plate",       -1,  0, "vehicle",      7, False, True,  (0, 0, 142)),
]

LABELS = labels

# ---------------------------------------------------------------------------
# Upstream/original trainId scheme (255 = ignore), used by the offline
# benchmark evaluators. Mirrors reference labels_original.py:63-97.
# ---------------------------------------------------------------------------
labels_original = [
    Label("unlabeled",            0, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("ego vehicle",          1, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("rectification border", 2, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("out of roi",           3, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("static",               4, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("dynamic",              5, 255, "void",         0, False, True,  (111, 74, 0)),
    Label("ground",               6, 255, "void",         0, False, True,  (81, 0, 81)),
    Label("road",                 7,   0, "flat",         1, False, False, (128, 64, 128)),
    Label("sidewalk",             8,   1, "flat",         1, False, False, (244, 35, 232)),
    Label("parking",              9, 255, "flat",         1, False, True,  (250, 170, 160)),
    Label("rail track",          10, 255, "flat",         1, False, True,  (230, 150, 140)),
    Label("building",            11,   2, "construction", 2, False, False, (70, 70, 70)),
    Label("wall",                12,   3, "construction", 2, False, False, (102, 102, 156)),
    Label("fence",               13,   4, "construction", 2, False, False, (190, 153, 153)),
    Label("guard rail",          14, 255, "construction", 2, False, True,  (180, 165, 180)),
    Label("bridge",              15, 255, "construction", 2, False, True,  (150, 100, 100)),
    Label("tunnel",              16, 255, "construction", 2, False, True,  (150, 120, 90)),
    Label("pole",                17,   5, "object",       3, False, False, (153, 153, 153)),
    Label("polegroup",           18, 255, "object",       3, False, True,  (153, 153, 153)),
    Label("traffic light",       19,   6, "object",       3, False, False, (250, 170, 30)),
    Label("traffic sign",        20,   7, "object",       3, False, False, (220, 220, 0)),
    Label("vegetation",          21,   8, "nature",       4, False, False, (107, 142, 35)),
    Label("terrain",             22,   9, "nature",       4, False, False, (152, 251, 152)),
    Label("sky",                 23,  10, "sky",          5, False, False, (70, 130, 180)),
    Label("person",              24,  11, "human",        6, True,  False, (220, 20, 60)),
    Label("rider",               25,  12, "human",        6, True,  False, (255, 0, 0)),
    Label("car",                 26,  13, "vehicle",      7, True,  False, (0, 0, 142)),
    Label("truck",               27,  14, "vehicle",      7, True,  False, (0, 0, 70)),
    Label("bus",                 28,  15, "vehicle",      7, True,  False, (0, 60, 100)),
    Label("caravan",             29, 255, "vehicle",      7, True,  True,  (0, 0, 90)),
    Label("trailer",             30, 255, "vehicle",      7, True,  True,  (0, 0, 110)),
    Label("train",               31,  16, "vehicle",      7, True,  False, (0, 80, 100)),
    Label("motorcycle",          32,  17, "vehicle",      7, True,  False, (0, 0, 230)),
    Label("bicycle",             33,  18, "vehicle",      7, True,  False, (119, 11, 32)),
    Label("license plate",       -1,  -1, "vehicle",      7, False, True,  (0, 0, 142)),
]

NUM_TRAIN_CLASSES = 20  # modified scheme: void=0 plus 19 evaluated classes

# ---------------------------------------------------------------------------
# Lookup dictionaries (reference labels.py:110-122)
# ---------------------------------------------------------------------------
name2label = {label.name: label for label in labels}
id2label = {label.id: label for label in labels}
# reversed() so that the *first* label with a given trainId wins, matching the
# reference's dict-comprehension-over-reversed trick (labels.py:116).
trainId2label = {label.trainId: label for label in reversed(labels)}
category2labels = {}
for _label in labels:
    category2labels.setdefault(_label.category, []).append(_label)

# Original-scheme lookups for the benchmark evaluators.
name2label_original = {label.name: label for label in labels_original}
id2label_original = {label.id: label for label in labels_original}
trainId2label_original = {label.trainId: label for label in reversed(labels_original)}
category2labels_original = {}
for _label in labels_original:
    category2labels_original.setdefault(_label.category, []).append(_label)


def assure_single_instance_name(name: str, registry=None) -> str | None:
    """Strip a 'group' suffix from a label name if the single-instance label
    exists and has instances (reference labels.py:136-152)."""
    registry = registry if registry is not None else name2label
    if name in registry:
        return name
    if not name.endswith("group"):
        return None
    name = name[: -len("group")]
    if name not in registry:
        return None
    if not registry[name].hasInstances:
        return None
    return name


# ---------------------------------------------------------------------------
# Vectorized LUT arrays (reference labels.py:181-215)
# ---------------------------------------------------------------------------
ids_to_colors_dict = {label.id: label.color for label in labels}
colors_to_ids_dict = {label.color: label.id for label in labels}
trainIds_to_colors_dict = {label.trainId: label.color for label in labels}
colors_to_trainIds_dict = {label.color: label.trainId for label in labels}
ids_to_trainIds_dict = {label.id: label.trainId for label in labels}
trainIds_to_ids_dict = {label.trainId: label.id for label in labels}
ids_to_categoryIds_dict = {label.id: label.categoryId for label in labels}
categoryIds_to_ids_dict = {label.categoryId: label.id for label in labels}


def _build_lut(mapping: dict, size: int, width: int | None = None) -> np.ndarray:
    shape = (size,) if width is None else (size, width)
    lut = np.zeros(shape, dtype=np.uint8)
    for key, value in mapping.items():
        if 0 <= key < size:
            # negative ids (license plate, id=-1) clamp to 0; the reference
            # relied on uint8 wraparound then overrode slot 0 explicitly.
            lut[key] = max(value, 0) if np.isscalar(value) else value
    return lut


IDS_TO_COLORS_ARRAY = _build_lut(ids_to_colors_dict, 35, 3)
IDS_TO_TRAINIDS_ARRAY = _build_lut(ids_to_trainIds_dict, 35)
TRAINIDS_TO_IDS_ARRAY = _build_lut(trainIds_to_ids_dict, NUM_TRAIN_CLASSES)
# trainId 0 maps back to id 0 ('unlabeled'): the dict assigns the *last* label
# with trainId 0 (license plate, id -1), which the reference overrides to 0
# (labels.py:194-196).
TRAINIDS_TO_IDS_ARRAY[0] = 0
IDS_TO_CATEGORYIDS_ARRAY = _build_lut(ids_to_categoryIds_dict, 35)
CATEGORYIDS_TO_IDS_ARRAY = _build_lut(categoryIds_to_ids_dict, 8)

TRAINIDS_TO_COLORS_ARRAY = np.zeros((NUM_TRAIN_CLASSES, 3), dtype=np.uint8)
for _train_id in range(NUM_TRAIN_CLASSES):
    TRAINIDS_TO_COLORS_ARRAY[_train_id] = trainId2label[_train_id].color

IDS_TO_COLORS_DICT = ids_to_colors_dict
COLORS_TO_IDS_DICT = colors_to_ids_dict
TRAINIDS_TO_COLORS_DICT = trainIds_to_colors_dict
COLORS_TO_TRAINIDS_DICT = colors_to_trainIds_dict
IDS_TO_TRAINIDS_DICT = ids_to_trainIds_dict
TRAINIDS_TO_IDS_DICT = trainIds_to_ids_dict
IDS_TO_CATEGORYIDS_DICT = ids_to_categoryIds_dict
CATEGORYIDS_TO_IDS_DICT = categoryIds_to_ids_dict

# RGBA overlay maps with alpha=127 (reference labels.py:217-218)
IDS_TO_RGBA_DICT = {key: (*value, 127) for key, value in IDS_TO_COLORS_DICT.items()}
TRAINIDS_TO_RGBA_DICT = {key: (*value, 127) for key, value in TRAINIDS_TO_COLORS_DICT.items()}

# ---------------------------------------------------------------------------
# Upstream/original 255-ignore trainId scheme LUTs (``labels_original``;
# reference labels_original.py:63-97). 19 evaluated classes, trainId 255 =
# ignore. Pairs with ``FCN8s(num_classes=19, ignore_label=255)``, which masks
# ignored pixels out of the loss/metrics — the reference could only train the
# modified void-as-class-0 scheme above. The license plate's trainId -1 maps
# to 255 (ignored) like every other non-evaluated label.
# ---------------------------------------------------------------------------
NUM_TRAIN_CLASSES_ORIGINAL = 19
IGNORE_LABEL = 255

IDS_TO_TRAINIDS_ORIGINAL_ARRAY = np.full((35,), IGNORE_LABEL, dtype=np.uint8)
for _label in labels_original:
    if 0 <= _label.id < 35:
        IDS_TO_TRAINIDS_ORIGINAL_ARRAY[_label.id] = _label.trainId % 256

# trainId (0..18) -> labelId, for benchmark-submission export
# (predict_and_save(output_format='ids', id_map=...)); each evaluated
# trainId belongs to exactly one label, so the loop assigns each slot once.
TRAINIDS_ORIGINAL_TO_IDS_ARRAY = np.zeros((NUM_TRAIN_CLASSES_ORIGINAL,), dtype=np.uint8)
TRAINIDS_ORIGINAL_TO_COLORS_ARRAY = np.zeros((NUM_TRAIN_CLASSES_ORIGINAL, 3), dtype=np.uint8)
for _label in labels_original:
    if 0 <= _label.trainId < NUM_TRAIN_CLASSES_ORIGINAL:
        TRAINIDS_ORIGINAL_TO_IDS_ARRAY[_label.trainId] = _label.id
        TRAINIDS_ORIGINAL_TO_COLORS_ARRAY[_label.trainId] = _label.color

TRAINIDS_ORIGINAL_TO_RGBA_DICT = {
    tid: (*TRAINIDS_ORIGINAL_TO_COLORS_ARRAY[tid], 127)
    for tid in range(NUM_TRAIN_CLASSES_ORIGINAL)
}
