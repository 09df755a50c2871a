"""Polygon annotation data model with editing operations. Port of
``fcn8s_tensorflow_tpu/prep/annotation.py``, a copy.

The reference's ``cityscapesscripts/helpers/annotation.py``: ``Point``,
``CsObject`` (label + polygon + metadata with JSON round-trip) and
``Annotation`` (image dims + object list, ``from_json_file``), plus the
*editing* capability of its PyQt4 annotation tool
(``cityscapesLabelTool.py``) as a headless programmatic API: vertex append /
insert / move / delete, object add / remove / soft-delete / restore /
relabel, and draw-order reordering (rasterization paints objects in list
order, so layer order is semantically meaningful, ``prep/rasterize.py``).
Edits stamp the object's ``date`` and round-trip through the Cityscapes
JSON format.
"""

from __future__ import annotations

import json
from collections import namedtuple
from datetime import datetime

Point = namedtuple("Point", ["x", "y"])


class CsObject:
    """One annotated object: label string + polygon + metadata."""

    def __init__(self):
        self.label = ""
        self.polygon: list[Point] = []
        self.id = -1
        self.deleted = 0
        self.verified = 0
        self.date = ""
        self.user = ""
        self.draw = True

    def __str__(self):
        if not self.polygon:
            poly_text = "none"
        elif len(self.polygon) <= 4:
            poly_text = " ".join(f"({p.x},{p.y})" for p in self.polygon)
        else:
            p = self.polygon
            poly_text = (
                f"({p[0].x},{p[0].y}) ({p[1].x},{p[1].y}) ... "
                f"({p[-2].x},{p[-2].y}) ({p[-1].x},{p[-1].y})"
            )
        return f"Object: {self.label} - {poly_text}"

    def from_json_text(self, data: dict, obj_id: int) -> None:
        self.id = obj_id
        self.label = str(data["label"])
        self.polygon = [Point(p[0], p[1]) for p in data["polygon"]]
        self.deleted = data.get("deleted", 0)
        self.verified = data.get("verified", 1)
        self.user = data.get("user", "")
        self.date = data.get("date", "")
        self.draw = not self.deleted

    def to_json_text(self) -> dict:
        return {
            "label": self.label,
            "id": self.id,
            "deleted": self.deleted,
            "verified": self.verified,
            "user": self.user,
            "date": self.date,
            "polygon": [[pt.x, pt.y] for pt in self.polygon],
        }

    def update_date(self) -> None:
        self.date = datetime.now().strftime("%d-%b-%Y %H:%M:%S")

    # -- editing operations (the label tool's polygon edits, headless) -----
    def append_vertex(self, x, y) -> None:
        """Add a vertex at the end of the polygon (the tool's draw mode)."""
        self.polygon.append(Point(x, y))
        self.update_date()

    def insert_vertex(self, index: int, x, y) -> None:
        """Insert a vertex before ``index`` (the tool's midpoint insert)."""
        self.polygon.insert(index, Point(x, y))
        self.update_date()

    def move_vertex(self, index: int, x, y) -> None:
        """Move vertex ``index`` to (x, y) (the tool's vertex drag)."""
        self.polygon[index] = Point(x, y)
        self.update_date()

    def delete_vertex(self, index: int) -> None:
        """Remove vertex ``index``."""
        del self.polygon[index]
        self.update_date()

    def relabel(self, label: str) -> None:
        """Change the object's label (the tool's label-selection edit)."""
        self.label = str(label)
        self.update_date()

    def mark_deleted(self) -> None:
        """Soft-delete: keeps the object in the JSON with ``deleted=1`` (the
        tool's delete preserves history); rasterization skips it."""
        self.deleted = 1
        self.draw = False
        self.update_date()

    def restore(self) -> None:
        """Undo a soft delete."""
        self.deleted = 0
        self.draw = True
        self.update_date()


class Annotation:
    """Whole-image annotation: dimensions + object list."""

    def __init__(self):
        self.imgWidth = 0
        self.imgHeight = 0
        self.objects: list[CsObject] = []

    def entry(self) -> dict:
        return {
            "imgWidth": self.imgWidth,
            "imgHeight": self.imgHeight,
            "objects": [obj.to_json_text() for obj in self.objects],
        }

    def from_json_text(self, json_text: str) -> None:
        data = json.loads(json_text)
        self.imgWidth = int(data["imgWidth"])
        self.imgHeight = int(data["imgHeight"])
        self.objects = []
        for obj_id, obj_data in enumerate(data["objects"]):
            obj = CsObject()
            obj.from_json_text(obj_data, obj_id)
            self.objects.append(obj)

    def to_json(self) -> str:
        return json.dumps(self.entry(), default=str)

    def from_json_file(self, json_file: str) -> None:
        with open(json_file) as f:
            self.from_json_text(f.read())

    def to_json_file(self, json_file: str) -> None:
        """Persist edits back to disk (the tool's save action)."""
        with open(json_file, "w") as f:
            f.write(self.to_json())

    # -- editing operations (object-level) ---------------------------------
    def add_object(self, label: str, polygon, user: str = "") -> CsObject:
        """Create a new object on top of the draw order (the tool's new
        polygon). ``polygon``: iterable of (x, y). Returns the object."""
        obj = CsObject()
        obj.id = max((o.id for o in self.objects), default=-1) + 1
        obj.label = str(label)
        obj.polygon = [Point(x, y) for x, y in polygon]
        obj.user = user
        obj.update_date()
        self.objects.append(obj)
        return obj

    def get_object(self, obj_id: int) -> CsObject:
        for obj in self.objects:
            if obj.id == obj_id:
                return obj
        raise KeyError(f"no object with id {obj_id}")

    def remove_object(self, obj_id: int) -> CsObject:
        """Hard-remove an object from the annotation (vs the soft
        ``CsObject.mark_deleted``). Returns the removed object."""
        obj = self.get_object(obj_id)
        self.objects.remove(obj)
        return obj

    def reorder_object(self, obj_id: int, new_index: int) -> None:
        """Move an object in the draw order (the tool's layer up/down) —
        rasterization paints in list order, so this changes which object
        wins overlapping pixels (`prep/rasterize.py:50`)."""
        obj = self.remove_object(obj_id)
        self.objects.insert(new_index, obj)

    # camelCase aliases matching the reference API names
    fromJsonFile = from_json_file
    toJson = to_json
