"""Correction-layer model: typed review boxes over an annotated image. Port
of ``fcn8s_tensorflow_tpu/prep/corrections.py``, a copy.

The reference label tool's correction mode
(``cityscapesLabelTool.py:149-234``, save path ``:826-885``, filename scheme
``:2743-2768``) lets an annotator mark
rectangular regions of an annotation as TO_CORRECT / TO_REVIEW / RESOLVED /
QUESTION with a free-text note, persisted as a LabelMe-style XML file next
to (or in a ``gtFine_corrections`` mirror of) the polygon GT. This module is
the data model + XML round-trip; ``prep/label_tool.py`` is the browser UI
over it.

Schema (root tag ``correction``, one child ``correction`` node per box):

    <correction>
      <filename>city_000000_000000_leftImg8bit.png</filename>
      <folder>StereoDataset/city</folder>
      <source>
        <sourceImage>Label Cities</sourceImage>
        <sourceAnnotation>mcLabelTool</sourceAnnotation>
      </source>
      <imagesize><nrows>1024</nrows><ncols>2048</ncols></imagesize>
      <correction>
        <type>1</type>
        <annotation>rider mislabeled as pedestrian</annotation>
        <bbox><x>10</x><y>20</y><width>30</width><height>40</height></bbox>
      </correction>
      ...
    </correction>

Divergence from the reference (documented, not replicated): the reference
writes ``ncols`` from ``self.image.height()`` (`cityscapesLabelTool.py:868`,
a copy-paste bug) — we write the actual image width.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

# reference `CorrectionBox.types` (cityscapesLabelTool.py:151)
TO_CORRECT = 1
TO_REVIEW = 2
RESOLVED = 3
QUESTION = 4

TYPE_NAMES = {TO_CORRECT: "to correct", TO_REVIEW: "to review",
              RESOLVED: "resolved", QUESTION: "question"}

# reference `CorrectionBox.get_colour` (cityscapesLabelTool.py:161-169)
TYPE_COLORS = {TO_CORRECT: (255, 0, 0), TO_REVIEW: (255, 255, 0),
               RESOLVED: (0, 255, 0), QUESTION: (0, 0, 255)}


@dataclass
class CorrectionBox:
    """One review rectangle (reference ``CorrectionBox``)."""

    x: int
    y: int
    width: int
    height: int
    type: int = TO_CORRECT
    annotation: str = ""

    def __post_init__(self):
        if self.type not in TYPE_NAMES:
            raise ValueError(
                f"correction type must be one of {sorted(TYPE_NAMES)}, "
                f"got {self.type!r}")
        self.x, self.y = int(round(self.x)), int(round(self.y))
        self.width, self.height = int(round(self.width)), int(round(self.height))

    @classmethod
    def from_xml_node(cls, node: ET.Element) -> "CorrectionBox":
        """Reference ``readFromXMLNode`` (cityscapesLabelTool.py:182-196)."""
        if node.tag != "correction":
            raise ValueError(f"expected a <correction> node, got <{node.tag}>")
        bbox = node.find("bbox")
        if bbox is None:
            raise ValueError("<correction> node without <bbox>")
        ann_node = node.find("annotation")
        return cls(
            x=float(bbox.findtext("x")),
            y=float(bbox.findtext("y")),
            width=float(bbox.findtext("width")),
            height=float(bbox.findtext("height")),
            type=int(node.findtext("type", default=str(TO_CORRECT))),
            annotation=(ann_node.text or "") if ann_node is not None else "",
        )

    def to_xml_node(self, parent: ET.Element) -> ET.Element:
        """Reference ``appendToXMLNode`` (cityscapesLabelTool.py:199-234)."""
        node = ET.SubElement(parent, "correction")
        node.text = node.tail = "\n"
        type_node = ET.SubElement(node, "type")
        type_node.text, type_node.tail = str(int(self.type)), "\n"
        ann_node = ET.SubElement(node, "annotation")
        ann_node.text, ann_node.tail = str(self.annotation), "\n"
        bbox = ET.SubElement(node, "bbox")
        bbox.text = bbox.tail = "\n"
        for tag, value in (("x", self.x), ("y", self.y),
                           ("width", self.width), ("height", self.height)):
            child = ET.SubElement(bbox, tag)
            child.text, child.tail = str(int(round(value))), "\n"
        return node

    def to_payload(self) -> dict:
        return {"x": self.x, "y": self.y, "width": self.width,
                "height": self.height, "type": self.type,
                "annotation": self.annotation}

    @classmethod
    def from_payload(cls, d: dict) -> "CorrectionBox":
        return cls(x=d["x"], y=d["y"], width=d["width"], height=d["height"],
                   type=int(d.get("type", TO_CORRECT)),
                   annotation=str(d.get("annotation", "")))


@dataclass
class CorrectionSheet:
    """All correction boxes for one image + the LabelMe-style header
    (reference save path, cityscapesLabelTool.py:836-875)."""

    filename: str = ""
    folder: str = ""
    nrows: int = 0
    ncols: int = 0
    boxes: list = field(default_factory=list)

    @classmethod
    def from_xml_file(cls, path: str) -> "CorrectionSheet":
        root = ET.parse(path).getroot()
        if root.tag != "correction":
            raise ValueError(
                f"{path}: expected root <correction>, got <{root.tag}>")
        size = root.find("imagesize")
        return cls(
            filename=root.findtext("filename", default="") or "",
            folder=root.findtext("folder", default="") or "",
            nrows=int(size.findtext("nrows", default="0")) if size is not None else 0,
            ncols=int(size.findtext("ncols", default="0")) if size is not None else 0,
            boxes=[CorrectionBox.from_xml_node(n)
                   for n in root.findall("correction")],
        )

    def to_xml_file(self, path: str) -> None:
        root = ET.Element("correction")
        root.text = root.tail = "\n"
        fn = ET.SubElement(root, "filename")
        fn.text, fn.tail = self.filename, "\n"
        folder = ET.SubElement(root, "folder")
        folder.text, folder.tail = self.folder, "\n"
        source = ET.SubElement(root, "source")
        source.text = source.tail = "\n"
        src_img = ET.SubElement(source, "sourceImage")
        src_img.text, src_img.tail = "Label Cities", "\n"
        src_ann = ET.SubElement(source, "sourceAnnotation")
        src_ann.text, src_ann.tail = "mcLabelTool", "\n"
        size = ET.SubElement(root, "imagesize")
        size.text = size.tail = "\n"
        nrows = ET.SubElement(size, "nrows")
        nrows.text, nrows.tail = str(int(self.nrows)), "\n"
        ncols = ET.SubElement(size, "ncols")
        ncols.text, ncols.tail = str(int(self.ncols)), "\n"
        for box in self.boxes:
            box.to_xml_node(root)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        ET.ElementTree(root).write(path)
