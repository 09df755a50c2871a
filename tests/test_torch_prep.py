"""PyTorch port, ``prep/`` against the JAX package's.

Tolerances: none. With ``datetime`` frozen in both ``annotation`` modules,
every annotation edit gives the same JSON text; correction sheets give
byte-identical XML; ``create_label_image`` and ``create_instance_image``
give the same mode and pixels on seeded polygons; ``create_gt_imgs`` writes
the same PNG bytes and counts; both label tools answer the same request
sequence with the same status codes, JSON and PNG bytes and leave the same
files; an annotation saved through the port's tool rasterises to the
trainIds that the port's ``BatchGenerator`` then reads.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from datetime import datetime

import numpy as np
import pytest
from PIL import Image

from fcn8s_tensorflow_tpu.prep import annotation as j_annotation
from fcn8s_tensorflow_tpu.prep import corrections as j_corrections
from fcn8s_tensorflow_tpu.prep import create_gt_imgs as j_create_gt_imgs
from fcn8s_tensorflow_tpu.prep import label_tool as j_label_tool
from fcn8s_tensorflow_tpu.prep import rasterize as j_rasterize
from fcn8s_tensorflow_tpu_torch.data import BatchGenerator
from fcn8s_tensorflow_tpu_torch.labels import name2label
from fcn8s_tensorflow_tpu_torch.prep import (annotation, corrections, create_gt_imgs, label_tool,
                                             rasterize)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
LABELS = ["road", "sidewalk", "building", "sky", "car", "person", "rider", "cargroup",
          "persongroup", "license plate", "ego vehicle", "bicycle", "unlabeled"]


class _Frozen:
    @staticmethod
    def now():
        return datetime(2026, 3, 4, 5, 6, 7)


@pytest.fixture
def frozen(monkeypatch):
    monkeypatch.setattr(j_annotation, "datetime", _Frozen)
    monkeypatch.setattr(annotation, "datetime", _Frozen)


def _polygons(seed, n=14, labels=LABELS):
    """Seeded Cityscapes JSON: random polygons of 0-7 vertices (some off the
    image), some deleted, some without the optional keys."""
    rng = np.random.default_rng(seed)
    objects = []
    for i in range(n):
        k = int(rng.integers(0, 8))
        poly = [[int(x), int(y)] for x, y in zip(rng.integers(-8, W + 8, k),
                                                 rng.integers(-8, H + 8, k))]
        obj = {"label": labels[int(rng.integers(0, len(labels)))], "polygon": poly}
        if i % 4 == 1:
            obj["deleted"] = 1
        if i % 3 == 0:
            obj.update(verified=0, user="u", date="01-Jan-2020 00:00:00")
        objects.append(obj)
    return json.dumps({"imgWidth": W, "imgHeight": H, "objects": objects})


def _both(text):
    j, p = j_annotation.Annotation(), annotation.Annotation()
    j.from_json_text(text)
    p.from_json_text(text)
    return j, p


# ---------------------------------------------------------------------------
# annotation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_annotation_json_round_trip_equals_jax(tmp_path, seed):
    j, p = _both(_polygons(seed))
    assert p.to_json() == j.to_json() and p.entry() == j.entry()
    assert [str(o) for o in p.objects] == [str(o) for o in j.objects]
    assert [o.draw for o in p.objects] == [o.draw for o in j.objects]
    p.to_json_file(str(tmp_path / "p.json"))
    assert p.toJson() == j.toJson()
    j.to_json_file(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    again = annotation.Annotation()
    again.fromJsonFile(str(tmp_path / "j.json"))
    assert again.toJson() == j.to_json()


EDITS = {
    "append_vertex": lambda a: a.objects[0].append_vertex(5, 6),
    "insert_vertex": lambda a: a.objects[2].insert_vertex(1, 7.5, 8),
    "move_vertex": lambda a: a.objects[3].move_vertex(0, 1, 2),
    "delete_vertex": lambda a: a.objects[3].delete_vertex(-1),
    "relabel": lambda a: a.objects[0].relabel("truck"),
    "mark_deleted": lambda a: a.objects[0].mark_deleted(),
    "restore": lambda a: a.objects[1].restore(),
    "add_object": lambda a: a.add_object("car", [(1, 2), (3, 4), (5, 1)], user="x").id,
    "remove_object": lambda a: a.remove_object(4).label,
    "reorder_object": lambda a: a.reorder_object(5, 0),
    "reorder_to_top": lambda a: a.reorder_object(0, len(a.objects) - 1),
}


@pytest.mark.parametrize("edit", list(EDITS))
def test_annotation_edit_equals_jax(frozen, edit):
    j, p = _both(_polygons(3))
    assert EDITS[edit](p) == EDITS[edit](j)
    assert p.to_json() == j.to_json()
    assert [o.draw for o in p.objects] == [o.draw for o in j.objects]


def test_annotation_errors_equal_jax():
    j, p = _both(_polygons(4))
    with pytest.raises(KeyError) as got:
        p.get_object(99)
    with pytest.raises(KeyError) as want:
        j.get_object(99)
    assert str(got.value) == str(want.value)
    for bad in ('{"imgWidth": 3}', "not json"):
        errors = []
        for a in (annotation.Annotation(), j_annotation.Annotation()):
            with pytest.raises(Exception) as e:
                a.from_json_text(bad)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1]


def test_update_date_format_equals_jax(frozen):
    j, p = j_annotation.CsObject(), annotation.CsObject()
    j.update_date()
    p.update_date()
    assert p.date == j.date == "04-Mar-2026 05:06:07"


# ---------------------------------------------------------------------------
# corrections
# ---------------------------------------------------------------------------
def _sheet(mod, n):
    rng = np.random.default_rng(n)
    boxes = [mod.CorrectionBox(x=float(rng.uniform(0, 80)), y=int(rng.integers(0, 60)),
                               width=float(rng.uniform(1, 30)), height=int(rng.integers(1, 20)),
                               type=int(rng.integers(1, 5)),
                               annotation=["", "rider <mislabeled>", "a & b", "ß ü"][i % 4])
             for i in range(n)]
    return mod.CorrectionSheet(filename="city_000000_000000_leftImg8bit.png",
                               folder="StereoDataset/city", nrows=60, ncols=80, boxes=boxes)


@pytest.mark.parametrize("n", [0, 1, 5])
def test_corrections_xml_is_byte_identical(tmp_path, n):
    _sheet(corrections, n).to_xml_file(str(tmp_path / "p" / "s.xml"))
    _sheet(j_corrections, n).to_xml_file(str(tmp_path / "j" / "s.xml"))
    assert (tmp_path / "p" / "s.xml").read_bytes() == (tmp_path / "j" / "s.xml").read_bytes()
    back = corrections.CorrectionSheet.from_xml_file(str(tmp_path / "j" / "s.xml"))
    want = j_corrections.CorrectionSheet.from_xml_file(str(tmp_path / "j" / "s.xml"))
    assert (back.filename, back.folder, back.nrows, back.ncols) == (
        want.filename, want.folder, want.nrows, want.ncols)
    assert [b.to_payload() for b in back.boxes] == [b.to_payload() for b in want.boxes]
    assert [corrections.CorrectionBox.from_payload(b.to_payload()).to_payload()
            for b in back.boxes] == [b.to_payload() for b in want.boxes]


@pytest.mark.parametrize("xml,kind", [
    ("<other/>", "root"),
    ("<correction><correction><type>1</type></correction></correction>", "no bbox"),
    ("<correction><correction><type>9</type><bbox><x>1</x><y>1</y><width>1</width>"
     "<height>1</height></bbox></correction></correction>", "type"),
])
def test_corrections_errors_equal_jax(tmp_path, xml, kind):
    path = tmp_path / "bad.xml"
    path.write_text(xml)
    with pytest.raises(ValueError) as got:
        corrections.CorrectionSheet.from_xml_file(str(path))
    with pytest.raises(ValueError) as want:
        j_corrections.CorrectionSheet.from_xml_file(str(path))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# rasterisers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("encoding,outline", [("ids", None), ("trainIds", None), ("color", None),
                                              ("ids", 7), ("color", (1, 2, 3, 255))])
def test_create_label_image_equals_jax(seed, encoding, outline):
    j, p = _both(_polygons(seed))
    got = rasterize.create_label_image(p, encoding, outline=outline)
    want = j_rasterize.create_label_image(j, encoding, outline=outline)
    assert got.mode == want.mode and got.size == (W, H)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("encoding", ["ids", "trainIds"])
def test_create_instance_image_equals_jax(seed, encoding):
    j, p = _both(_polygons(seed, n=20))
    got = rasterize.create_instance_image(p, encoding)
    want = j_rasterize.create_instance_image(j, encoding)
    assert got.mode == want.mode == "I"
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_group_fallback_and_instances():
    text = json.dumps({"imgWidth": W, "imgHeight": H, "objects": [
        {"label": "road", "polygon": [[0, 20], [63, 20], [63, 47], [0, 47]]},
        {"label": "cargroup", "polygon": [[2, 2], [20, 2], [20, 15], [2, 15]]},
        {"label": "car", "polygon": [[30, 25], [40, 25], [40, 35], [30, 35]]},
        {"label": "car", "polygon": [[45, 25], [55, 25], [55, 35], [45, 35]]},
    ]})
    j, p = _both(text)
    ids = np.asarray(rasterize.create_label_image(p, "ids"))
    assert ids[8, 10] == name2label["car"].id and ids[40, 5] == name2label["road"].id
    inst = np.asarray(rasterize.create_instance_image(p, "ids"))
    car = name2label["car"].id
    assert (inst[8, 10], inst[30, 35], inst[30, 50]) == (car, car * 1000, car * 1000 + 1)
    np.testing.assert_array_equal(inst, np.asarray(j_rasterize.create_instance_image(j, "ids")))


@pytest.mark.parametrize("call", ["label", "instance", "encoding"])
def test_rasterise_errors_equal_jax(call):
    text = json.dumps({"imgWidth": 8, "imgHeight": 8, "objects": [
        {"label": "no-such-label", "polygon": [[0, 0], [4, 0], [4, 4]]}]})
    j, p = _both(text)
    fns = {"label": lambda m, a: m.create_label_image(a, "ids"),
           "instance": lambda m, a: m.create_instance_image(a, "ids"),
           "encoding": lambda m, a: m.create_label_image(a, "rgb")}[call]
    with pytest.raises(ValueError) as got:
        fns(rasterize, p)
    with pytest.raises(ValueError) as want:
        fns(j_rasterize, j)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("which", ["label", "instance"])
def test_json_to_images_write_the_jax_functions_bytes(tmp_path, which):
    src = tmp_path / "a_gtFine_polygons.json"
    src.write_text(_polygons(5))
    fn = "json_to_label_img" if which == "label" else "json_to_instance_img"
    getattr(rasterize, fn)(str(src), str(tmp_path / "p.png"))
    getattr(j_rasterize, fn)(str(src), str(tmp_path / "j.png"))
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()


# ---------------------------------------------------------------------------
# create_gt_imgs
# ---------------------------------------------------------------------------
def _gt_tree(root):
    """gtFine/{train,val}/<city> and gtCoarse/train/<city> polygon files."""
    k = 0
    for gt, split, city, n in (("gtFine", "train", "aachen", 3), ("gtFine", "val", "bonn", 2),
                               ("gtCoarse", "train", "erfurt", 2)):
        d = root / gt / split / city
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"{city}_{i:06d}_000019_{gt}_polygons.json").write_text(_polygons(100 + k))
            k += 1
    (root / "gtFine" / "train" / "aachen" / "notes.json").write_text("{}")  # not matched
    return 7


def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("which", ["labels", "instances"])
def test_create_gt_imgs_writes_the_jax_functions_files(tmp_path, which, capsys):
    n = _gt_tree(tmp_path / "p")
    shutil.copytree(tmp_path / "p", tmp_path / "j")
    fn = ("create_train_id_label_imgs" if which == "labels"
          else "create_train_id_instance_imgs")
    assert getattr(create_gt_imgs, fn)(str(tmp_path / "p")) == n
    port_out = capsys.readouterr().out
    assert getattr(j_create_gt_imgs, fn)(str(tmp_path / "j")) == n
    assert port_out == capsys.readouterr().out
    got, want = _tree_bytes(tmp_path / "p"), _tree_bytes(tmp_path / "j")
    assert got == want and len(got) == 2 * n + 1
    assert getattr(create_gt_imgs, fn)(str(tmp_path / "p"), quiet=True) == n
    assert capsys.readouterr().out == ""


def test_create_gt_imgs_without_annotations_raises_as_jax(tmp_path):
    with pytest.raises(RuntimeError) as got:
        create_gt_imgs.create_train_id_label_imgs(str(tmp_path))
    with pytest.raises(RuntimeError) as want:
        j_create_gt_imgs.create_train_id_label_imgs(str(tmp_path))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arg", ["labels", "instances", "bogus"])
def test_create_gt_imgs_entry_point(tmp_path, arg):
    """``python -m ...prep.create_gt_imgs [labels|instances]`` over
    ``CITYSCAPES_DATASET``; the files equal the library call's."""
    n = _gt_tree(tmp_path / "cli")
    shutil.copytree(tmp_path / "cli", tmp_path / "lib")
    out = subprocess.run([sys.executable, "-m", "fcn8s_tensorflow_tpu_torch.prep.create_gt_imgs",
                          arg], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT,
                              "CITYSCAPES_DATASET": str(tmp_path / "cli")})
    if arg == "bogus":
        assert out.returncode != 0 and "usage: python -m fcn8s_tensorflow_tpu_torch" in out.stderr
        return
    assert out.returncode == 0, out.stderr
    assert f"Processing {n} annotation files" in out.stdout
    fn = {"labels": create_gt_imgs.create_train_id_label_imgs,
          "instances": create_gt_imgs.create_train_id_instance_imgs}[arg]
    fn(str(tmp_path / "lib"), quiet=True)
    assert _tree_bytes(tmp_path / "cli") == _tree_bytes(tmp_path / "lib")


# ---------------------------------------------------------------------------
# the label tool
# ---------------------------------------------------------------------------
def _serve(mod, root):
    img_dir = root / "imgs"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(21)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)).save(
            img_dir / f"city_000000_00000{i}_leftImg8bit.png")
    tool = mod.AnnotationTool(str(img_dir), annotation_dir=str(root / "ann"), user="tester")
    srv = mod.make_server(tool, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://{srv.server_address[0]}:{srv.server_address[1]}"


@pytest.fixture
def tools(tmp_path, frozen):
    servers = [_serve(label_tool, tmp_path / "port"), _serve(j_label_tool, tmp_path / "jax")]
    yield [base for _, base in servers], tmp_path
    for srv, _ in servers:
        srv.shutdown()
        srv.server_close()


def _call(base, method, path, body=None):
    data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, ctype, payload = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        status, ctype, payload = e.code, e.headers["Content-Type"], e.read()
    if ctype == "application/json":
        payload = json.loads(payload)
    return status, ctype, payload


ROAD = [[0, 30], [79, 30], [79, 59], [0, 59]]
REQUESTS = [
    ("GET", "/", None), ("GET", "/index.html?x=1", None), ("GET", "/api/images", None),
    ("GET", "/api/labels", None), ("GET", "/api/image/1", None),
    ("GET", "/api/annotation/0", None), ("GET", "/api/corrections/0", None),
    ("GET", "/api/preview/0", None),
    ("POST", "/api/annotation/0", {"imgWidth": 80, "imgHeight": 60, "objects": [
        {"label": "road", "polygon": ROAD},
        {"label": "cargroup", "polygon": [[10, 5], [30, 5], [30, 20], [10, 20]]},
        {"label": "car", "polygon": [[40, 35], [60, 35], [60, 50], [40, 50.5]]},
        {"label": "person", "polygon": [[5, 35], [9, 35], [9, 55]]}]}),
    ("POST", "/api/annotation/1", {"objects": [{"label": "not-a-label",
                                                "polygon": [[0, 0], [1, 0], [1, 1]]}]}),
    ("POST", "/api/annotation/1", {"objects": [{"label": "car", "polygon": [[0, 0], [1, 0]]}]}),
    ("POST", "/api/annotation/1", b"{not json"),
    ("POST", "/api/annotation/1", {"objects": [{"polygon": ROAD}]}),
    ("GET", "/api/annotation/0", None), ("GET", "/api/images", None),
    ("POST", "/api/corrections/0", {"boxes": [
        {"x": 10, "y": 20, "width": 30, "height": 15, "type": 1, "annotation": "rider?"},
        {"x": 40.4, "y": 5, "width": 12, "height": 8, "type": 4},
        {"x": 2, "y": 2, "width": 5, "height": 5, "type": 3, "annotation": "ok"}]}),
    ("POST", "/api/corrections/1", {"boxes": [{"x": 1, "y": 1, "width": 1, "height": 1,
                                               "type": 7}]}),
    ("POST", "/api/corrections/1", {"boxes": [{"x": 1}]}),
    ("GET", "/api/corrections/0", None), ("GET", "/api/preview/0", None),
    ("GET", "/api/preview/1", None), ("GET", "/api/screenshot/0", None),
    ("GET", "/api/screenshot/1", None), ("GET", "/api/image/9", None),
    ("GET", "/api/annotation/x", None), ("GET", "/nope", None), ("POST", "/nope", {}),
    ("POST", "/api/annotation/1", {"imgWidth": 80, "imgHeight": 60, "objects": [
        {"label": "sky", "polygon": [[0, 0], [79, 0], [79, 20]]}]}),
    ("POST", "/api/corrections/1", {"boxes": []}),
    ("POST", "/api/corrections/0", {"boxes": []}), ("GET", "/api/corrections/0", None),
]


def test_label_tools_answer_the_same_requests_the_same(tools):
    (port, jax), tmp_path = tools
    statuses = []
    for method, path, body in REQUESTS:
        got, want = _call(port, method, path, body), _call(jax, method, path, body)
        assert got == want, (method, path)
        statuses.append(got[0])
    assert sorted(set(statuses)) == [200, 400, 404, 500]
    assert _tree_bytes(tmp_path / "port" / "ann") == _tree_bytes(tmp_path / "jax" / "ann")
    assert sorted(os.listdir(tmp_path / "port" / "ann")) == [
        "city_000000_000000_gtFine_polygons.json", "city_000000_000001_gtFine_polygons.json"]


def test_label_tool_calls_equal_jax(tmp_path, frozen):
    """The tool without HTTP: paths, payloads, previews and screenshots."""
    out = []
    for mod, name in ((label_tool, "p"), (j_label_tool, "j")):
        img_dir = tmp_path / name / "imgs"
        img_dir.mkdir(parents=True)
        Image.fromarray(np.full((30, 40, 3), 90, np.uint8)).save(img_dir / "a_gtCoarse.png")
        Image.fromarray(np.full((30, 40, 3), 30, np.uint8)).save(img_dir / "b.png")
        tool = mod.AnnotationTool(str(img_dir), corrections_dir=str(tmp_path / name / "corr"))
        tool.save_annotation(1, {"objects": [{"label": "road", "polygon": ROAD[:3]}]})
        tool.save_corrections(1, {"boxes": [{"x": 1, "y": 2, "width": 9, "height": 9,
                                             "annotation": "n"}]})
        out.append([os.path.relpath(tool.annotation_path(i), tmp_path / name) for i in (0, 1)]
                   + [os.path.relpath(tool.correction_path(1), tmp_path / name),
                      tool.list_images(), tool.get_annotation(1), tool.get_corrections(1),
                      tool.preview_png(1, alpha=0.3), tool.screenshot_png(1, alpha=0.8),
                      tool.image_size(0)])
    assert out[0] == out[1]
    with pytest.raises(ValueError) as got:
        label_tool.AnnotationTool(str(tmp_path / "p" / "corr"), image_file_extension="jpg")
    with pytest.raises(ValueError) as want:
        j_label_tool.AnnotationTool(str(tmp_path / "p" / "corr"), image_file_extension="jpg")
    assert str(got.value) == str(want.value)


def test_label_tool_main_without_arguments_prints_usage(capsys):
    assert label_tool.main([]) == 1
    assert "python -m fcn8s_tensorflow_tpu_torch.prep.label_tool" in capsys.readouterr().out


def test_label_tool_annotation_rasterises_to_the_trainids_batchgenerator_reads(tmp_path,
                                                                                frozen):
    """Annotate over HTTP -> ``create_gt_imgs`` -> ``BatchGenerator``."""
    root = tmp_path / "cityscapes"
    img_dir = root / "leftImg8bit" / "train" / "c"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(33)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)).save(
            img_dir / f"c_00000{i}_000019_leftImg8bit.png")
    tool = label_tool.AnnotationTool(str(img_dir), annotation_dir=str(root / "gtFine" / "train"
                                                                      / "c"))
    srv = label_tool.make_server(tool, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://{srv.server_address[0]}:{srv.server_address[1]}"
    payloads = [{"objects": [{"label": "road", "polygon": ROAD},
                             {"label": "car", "polygon": [[10, 35], [30, 35], [30, 50]]}]},
                {"objects": [{"label": "sky", "polygon": [[0, 0], [79, 0], [79, 25], [0, 25]]},
                             {"label": "persongroup", "polygon": [[5, 5], [15, 5], [15, 50]]}]}]
    try:
        for i, payload in enumerate(payloads):
            assert _call(base, "POST", f"/api/annotation/{i}", payload)[0] == 200
    finally:
        srv.shutdown()
        srv.server_close()
    assert create_gt_imgs.create_train_id_label_imgs(str(root), quiet=True) == 2
    gen = BatchGenerator(image_dirs=[str(root / "leftImg8bit" / "train")],
                         ground_truth_dirs=[str(root / "gtFine" / "train")],
                         image_name_split_separator="leftImg8bit",
                         ground_truth_suffix="gtFine_labelTrainIds", num_classes=20)
    images, labels = next(gen.generate(batch_size=2, convert_to_one_hot=False, shuffle=False))
    for i in range(2):
        ann = annotation.Annotation()
        ann.from_json_file(tool.annotation_path(i))
        want = np.asarray(rasterize.create_label_image(ann, "trainIds"))
        np.testing.assert_array_equal(labels[i], want)
        np.testing.assert_array_equal(images[i], np.asarray(Image.open(tool.image_paths[i])))
    assert {int(v) for v in np.unique(labels)} >= {name2label["road"].trainId,
                                                   name2label["sky"].trainId,
                                                   name2label["person"].trainId}
    assert labels.dtype == np.uint8
