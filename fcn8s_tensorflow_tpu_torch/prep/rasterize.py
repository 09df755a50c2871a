"""Polygon -> raster ground truth (label and instance encodings). Port of
``fcn8s_tensorflow_tpu/prep/rasterize.py``, a copy.

The reference's ``cityscapesscripts/preparation/json2labelImg.py`` and
``json2instanceImg.py``:

* ``create_label_image``: PIL polygon fill in 'ids' / 'trainIds' / 'color'
  encodings with 'unlabeled' background and the group-suffix fallback
  (``cargroup`` -> ``car`` when the group label itself is unknown);
* ``create_instance_image``: instances encoded as ``id*1000 + n`` for labels
  with ``hasInstances`` (n counts per label), bare id otherwise;
* ``json_to_label_img`` / ``json_to_instance_img``: file-level wrappers.
"""

from __future__ import annotations

from PIL import Image, ImageDraw

from ..labels.cityscapes import name2label
from .annotation import Annotation


def _resolve_label(label: str):
    """Group-suffix fallback: unknown '<x>group' resolves to '<x>'."""
    if label not in name2label and label.endswith("group"):
        label = label[: -len("group")]
    if label not in name2label:
        raise ValueError(f"Label '{label}' not known.")
    return label, name2label[label]


def create_label_image(annotation: Annotation, encoding: str, outline=None) -> Image.Image:
    """Rasterize polygons into a label image ('ids' | 'trainIds' | 'color')."""
    size = (annotation.imgWidth, annotation.imgHeight)
    bg_label = name2label["unlabeled"]
    if encoding == "ids":
        background = bg_label.id
    elif encoding == "trainIds":
        background = bg_label.trainId
    elif encoding == "color":
        background = bg_label.color
    else:
        raise ValueError(f"Unknown encoding '{encoding}'")

    if encoding == "color":
        label_img = Image.new("RGBA", size, background)
    else:
        label_img = Image.new("L", size, background)
    drawer = ImageDraw.Draw(label_img)

    for obj in annotation.objects:
        if obj.deleted:
            continue
        label, entry = _resolve_label(obj.label)
        if entry.id < 0:  # license plate etc.: not drawn
            continue
        if encoding == "ids":
            val = entry.id
        elif encoding == "trainIds":
            val = entry.trainId
        else:
            val = entry.color
        polygon = [(p.x, p.y) for p in obj.polygon]
        if len(polygon) < 2:
            continue
        if outline is not None:
            drawer.polygon(polygon, fill=val, outline=outline)
        else:
            drawer.polygon(polygon, fill=val)
    return label_img


def create_instance_image(annotation: Annotation, encoding: str) -> Image.Image:
    """Rasterize polygons into an instance image: labels with instances get
    ``id*1000 + n``; stuff labels get their bare id ('ids' | 'trainIds')."""
    size = (annotation.imgWidth, annotation.imgHeight)
    bg_label = name2label["unlabeled"]
    background = bg_label.id if encoding == "ids" else bg_label.trainId
    instance_img = Image.new("I", size, background)
    drawer = ImageDraw.Draw(instance_img)

    nb_instances = {name: 0 for name, entry in name2label.items() if entry.hasInstances}

    for obj in annotation.objects:
        if obj.deleted:
            continue
        label, entry = _resolve_label(obj.label)
        is_group = obj.label not in name2label  # resolved via group fallback
        if entry.id < 0:
            continue
        value = entry.id if encoding == "ids" else int(entry.trainId)
        if entry.hasInstances and not is_group:
            value = value * 1000 + nb_instances[label]
            nb_instances[label] += 1
        polygon = [(p.x, p.y) for p in obj.polygon]
        if len(polygon) < 2:
            continue
        drawer.polygon(polygon, fill=value)
    return instance_img


def json_to_label_img(json_file: str, out_file: str, encoding: str = "trainIds") -> None:
    annotation = Annotation()
    annotation.from_json_file(json_file)
    create_label_image(annotation, encoding).save(out_file)


def json_to_instance_img(json_file: str, out_file: str, encoding: str = "ids") -> None:
    annotation = Annotation()
    annotation.from_json_file(json_file)
    create_instance_image(annotation, encoding).save(out_file)
