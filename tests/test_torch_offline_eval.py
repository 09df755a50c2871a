"""PyTorch port, the offline evaluation layer against the JAX package's.

The port keeps its own copies of the label registry, the Cityscapes file
helpers, the native confusion-matrix kernel (built here with g++) and the
pixel- and instance-level scorers. Every comparison is exact: the tables,
the confusion matrices and the scorers' result dicts (compared as their
JSON text, so NaN scores must sit in the same places).
"""

import json
import math
import os
import threading

import numpy as np
import pytest
from PIL import Image

from fcn8s_tensorflow_tpu import labels as j_labels
from fcn8s_tensorflow_tpu.evaluation import confmat as j_confmat
from fcn8s_tensorflow_tpu.evaluation import instance_eval as j_instance_eval
from fcn8s_tensorflow_tpu.evaluation import pixel_eval as j_pixel_eval
from fcn8s_tensorflow_tpu.utils import cs_helpers as j_cs_helpers
from fcn8s_tensorflow_tpu_torch import labels as t_labels
from fcn8s_tensorflow_tpu_torch.evaluation import confmat, instance_eval, pixel_eval
from fcn8s_tensorflow_tpu_torch.utils import cs_helpers

EXPORTS = sorted(name for name in dir(j_labels) if not name.startswith("_")
                 and name not in ("cityscapes",))


def _json(result) -> str:
    return json.dumps(result, sort_keys=True, default=float)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", EXPORTS)
def test_registry_export_equals_the_jax_packages(name):
    want, got = getattr(j_labels, name), getattr(t_labels, name)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif callable(want) and not isinstance(want, type):
        for label in ("car", "cargroup", "persongroup", "polegroup", "nothing", "road"):
            assert got(label) == want(label), label
    elif isinstance(want, type):
        assert got._fields == want._fields
    else:
        assert got == want


def test_registry_exports_the_same_names():
    assert sorted(n for n in dir(t_labels) if not n.startswith("_") and n != "cityscapes") \
        == EXPORTS


@pytest.mark.parametrize("path", [
    "/x/aachen_000001_000019_gtFine_labelIds.png",
    "frankfurt_am_main_000001_000019_leftImg8bit.png",
    "c_000003_000000_pred_extra_part.png",
])
def test_cs_file_info_equals_the_jax_packages(path):
    assert cs_helpers.get_cs_file_info(path) == j_cs_helpers.get_cs_file_info(path)
    assert cs_helpers.get_core_image_file_name(path) == j_cs_helpers.get_core_image_file_name(path)


def test_cs_print_error_raises():
    with pytest.raises(RuntimeError, match="ERROR: boom"):
        cs_helpers.print_error("boom")


# ---------------------------------------------------------------------------
# the native kernel, its twins and the JAX binding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,dim,threads", [((512, 512), 34, None), ((1024, 2048), 34, 4),
                                               ((3, 7), 5, 1), ((1100, 1000), 256, 3)])
def test_native_confusion_matrix_equals_twin_and_jax(rng, shape, dim, threads):
    """Random uint8 pairs, above and below the threaded variant's 2^20
    pixels: the library, its numpy twin and the JAX binding agree exactly."""
    pred = rng.integers(0, dim, shape, dtype=np.uint8)
    gt = rng.integers(0, dim, shape, dtype=np.uint8)
    got, twin, want = (np.zeros((dim, dim), np.uint64) for _ in range(3))
    confmat.accumulate_confusion(pred, gt, got, n_threads=threads)
    confmat.accumulate_confusion_plain(pred, gt, twin)
    j_confmat.accumulate_confusion(pred, gt, want)
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == pred.size
    confmat.accumulate_confusion(pred, gt, got)  # additive
    assert got.sum() == 2 * pred.size


@pytest.mark.parametrize("valid", [range(34), [1, 2, 3], [0, 7, 26, 255]])
def test_find_invalid_label_equals_twin_and_jax(rng, valid):
    gt = rng.integers(0, 34, (64, 96), dtype=np.uint8)
    got = confmat.find_invalid_label(gt, valid)
    assert got == confmat.find_invalid_label_plain(gt, valid)
    assert got == j_confmat.find_invalid_label(gt, valid)


def test_instance_tp_size_equals_twin_and_jax(rng):
    inst = np.zeros((60, 80), np.int32)
    inst[2:30, 5:40] = 26005
    inst[35:, 50:] = 24001
    pred = rng.integers(20, 28, (60, 80), dtype=np.uint8)
    for inst_id, label in ((26005, 26), (24001, 24), (33001, 33)):
        got = confmat.instance_tp_size(pred, inst, inst_id, label)
        assert got == confmat.instance_tp_size_plain(pred, inst, inst_id, label)
        assert got == j_confmat.instance_tp_size(pred, inst, inst_id, label)


@pytest.mark.parametrize("case", ["size", "dtype", "id_past_dim"])
def test_confusion_matrix_argument_checks(case):
    pred, gt = np.zeros((4, 4), np.uint8), np.zeros((4, 4), np.uint8)
    conf = np.zeros((3, 3), np.uint64)
    if case == "size":
        gt = np.zeros((5, 5), np.uint8)
    elif case == "dtype":
        conf = np.zeros((3, 3), np.int64)
    else:
        pred[1, 1] = 3
    for fn in (confmat.accumulate_confusion, confmat.accumulate_confusion_plain):
        with pytest.raises(ValueError):
            fn(pred, gt, conf)


def test_native_build_is_safe_when_built_concurrently(tmp_path, monkeypatch):
    """More concurrent builds than cores (capped at 12) start on an empty directory
    at once, as test workers may: each compiles to a private name and
    renames it into place; all get the same whole library, which loads."""
    monkeypatch.setattr(confmat, "BUILD_DIR", tmp_path / "native")
    paths, errors = [], []

    def run():
        try:
            paths.append(confmat.build())
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(min((os.cpu_count() or 1) + 2, 12))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
        assert not t.is_alive()
    assert not errors and len(paths) == len(threads) and len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "native").iterdir()] == [paths[0].name]
    import ctypes

    lib = ctypes.CDLL(str(paths[0]))
    assert lib.confusion_matrix_u8 is not None


@pytest.mark.parametrize("cxx,match", [("no-such-compiler-xyz", "no-such-compiler-xyz not found"),
                                       ("false", "false failed to build")])
def test_native_build_failure_raises_and_names_the_compiler(tmp_path, monkeypatch, cxx, match):
    """No quiet numpy fallback: a missing or failing compiler raises."""
    monkeypatch.setattr(confmat, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=match):
        confmat.build()
    assert not list((tmp_path / "native").glob("*.so"))


# ---------------------------------------------------------------------------
# the pixel-level scorer on a synthetic Cityscapes directory
# ---------------------------------------------------------------------------
EVAL_IDS = [label.id for label in t_labels.labels if label.id >= 0]


@pytest.fixture
def cityscapes_dir(tmp_path):
    """Two cities x two 48x80 frames: labelId GT over every id (void ones
    included), instanceIds with car and person instances (id > 1000) and
    group regions, and labelId predictions that agree on ~60% of pixels."""
    rng = np.random.default_rng(11)
    ds = tmp_path / "ds"
    preds = tmp_path / "results"
    preds.mkdir()
    gts = []
    for city in ("alpha", "beta"):
        gt_dir = ds / "gtFine" / "val" / city
        gt_dir.mkdir(parents=True)
        for n in range(2):
            gt = rng.choice(EVAL_IDS, size=(48, 80)).astype(np.uint8)
            inst = gt.astype(np.int32)
            for k, (label, box) in enumerate([(26, (0, 20, 0, 30)), (26, (25, 48, 40, 80)),
                                              (24, (5, 30, 45, 70))]):
                y0, y1, x0, x1 = box
                gt[y0:y1, x0:x1] = label
                inst[y0:y1, x0:x1] = label * 1000 + k + n
            gt[40:, :10] = 26  # a car group region: labelId, no instance id
            inst[40:, :10] = 26
            pred = np.where(rng.random(gt.shape) < 0.6, gt,
                            rng.choice(EVAL_IDS, size=gt.shape)).astype(np.uint8)
            name = f"{city}_{n:06d}_000019"
            gt_path = gt_dir / f"{name}_gtFine_labelIds.png"
            Image.fromarray(gt).save(gt_path)
            Image.fromarray(inst.astype(np.uint16)).save(gt_dir / f"{name}_gtFine_instanceIds.png")
            Image.fromarray(pred).save(preds / f"{name}_leftImg8bit.png")
            gts.append(str(gt_path))
    return ds, preds, gts


def _pixel_args(module, preds, export, *, pixel_accuracy, instances=True):
    args = module.EvalArgs()
    args.quiet = True
    args.prediction_path = str(preds)
    args.export_file = str(export)
    args.eval_pixel_accuracy = pixel_accuracy
    args.eval_inst_level_score = instances
    return args


@pytest.mark.parametrize("instances", [True, False])
@pytest.mark.parametrize("pixel_accuracy", [False, True])
def test_pixel_scorer_result_equals_the_jax_scorers(cityscapes_dir, tmp_path, pixel_accuracy,
                                                    instances):
    """The full result dict (confMatrix, priors, class and category IoU and
    iIoU, averages, per-image stats) and its JSON export, exactly."""
    ds, preds, gts = cityscapes_dir
    results = []
    for module, tag in ((j_pixel_eval, "jax"), (pixel_eval, "port")):
        args = _pixel_args(module, preds, tmp_path / tag / "r.json",
                           pixel_accuracy=pixel_accuracy, instances=instances)
        pred_files = [module.get_prediction(args, gt) for gt in gts]
        results.append(module.evaluate_img_lists(pred_files, gts, args))
        with open(args.export_file) as f:
            results.append(f.read())
    want, want_file, got, got_file = results
    assert _json(got) == _json(want)
    assert got_file == want_file
    assert np.asarray(got["confMatrix"]).sum() == 4 * 48 * 80
    assert ("perImageScores" in got) == pixel_accuracy
    assert not math.isnan(got["averageScoreClasses"])
    if instances:
        assert got["classInstScores"]["car"] > 0 and got["classInstScores"]["person"] > 0


def test_pixel_scorer_cli_equals_the_jax_cli(cityscapes_dir, tmp_path, monkeypatch, capsys):
    """``main([])``: the environment's dataset, results and export
    directories, the GT glob and the prediction discovery, the printed report."""
    ds, preds, _ = cityscapes_dir
    monkeypatch.setenv("CITYSCAPES_DATASET", str(ds))
    monkeypatch.setenv("CITYSCAPES_RESULTS", str(preds))
    outs = []
    for module, tag in ((j_pixel_eval, "jax"), (pixel_eval, "port")):
        export = tmp_path / f"export_{tag}"
        export.mkdir()
        monkeypatch.setenv("CITYSCAPES_EXPORT_DIR", str(export))
        result = module.main([])
        outs.append((result, capsys.readouterr().out,
                     (export / "resultPixelLevelSemanticLabeling.json").read_text()))
    (want, want_out, want_file), (got, got_out, got_file) = outs
    assert _json(got) == _json(want) and got_out == want_out and got_file == want_file
    assert "Score Average" in got_out


@pytest.mark.parametrize("case", ["mismatched_size", "unknown_label", "missing_prediction"])
def test_pixel_scorer_errors_equal_the_jax_scorers(cityscapes_dir, tmp_path, case):
    ds, preds, gts = cityscapes_dir
    if case == "mismatched_size":
        bad = tmp_path / "bad_pred.png"
        Image.fromarray(np.zeros((10, 10), np.uint8)).save(bad)
        lists = ([str(bad)], gts[:1])
    elif case == "unknown_label":
        bad = tmp_path / "x_000000_000000_gtFine_labelIds.png"
        Image.fromarray(np.full((48, 80), 200, np.uint8)).save(bad)
        lists = ([str(next(preds.iterdir()))], [str(bad)])
    messages = []
    for module in (j_pixel_eval, pixel_eval):
        args = _pixel_args(module, preds, tmp_path / "r.json", pixel_accuracy=False,
                           instances=False)
        with pytest.raises(RuntimeError) as err:
            if case == "missing_prediction":
                module.get_prediction(args, str(tmp_path / "zzz_000000_000000_gtFine_labelIds.png"))
            else:
                module.evaluate_img_lists(*lists, args)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_default_args_read_the_environment_as_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setenv("CITYSCAPES_DATASET", str(tmp_path))
    monkeypatch.delenv("CITYSCAPES_EXPORT_DIR", raising=False)
    got, want = pixel_eval.default_args(), j_pixel_eval.default_args()
    assert (got.export_file, got.ground_truth_search) == (want.export_file,
                                                           want.ground_truth_search)
    monkeypatch.setenv("CITYSCAPES_EXPORT_DIR", str(tmp_path / "gone"))
    with pytest.raises(ValueError, match="not a directory"):
        pixel_eval.default_args()


# ---------------------------------------------------------------------------
# the instance-level scorer, on the synthetic cases of tests/test_instance_eval.py
# ---------------------------------------------------------------------------
def _instance_case(case):
    """(instanceIds array, [(mask, labelId, confidence)]) per case."""
    inst = np.zeros((100, 100), np.int32)
    if case == "perfect":
        inst[10:40, 10:40] = 26000
        return inst, [(inst == 26000, 26, 0.99)]
    if case == "partial":
        inst[0:30, 0:30] = 26000
        mask = np.zeros((100, 100), bool)
        mask[0:20, 0:30] = True
        return inst, [(mask, 26, 0.9)]
    if case in ("false_positive", "fp_on_void"):
        if case == "false_positive":
            inst[:] = 7
        inst[0:30, 0:30] = 26000
        fp = np.zeros((100, 100), bool)
        fp[60:90, 60:90] = True
        return inst, [(inst == 26000, 26, 0.9), (fp, 26, 0.95)]
    if case == "small_gt":
        inst[0:5, 0:5] = 26000
        return inst, []
    if case == "missed_gt":
        inst[0:30, 0:30] = 26000
        inst[60:90, 60:90] = 26001
        return inst, [(inst == 26000, 26, 0.9)]
    # mixed: two classes, a group region, a wrong-class and a low-confidence mask
    inst[:] = 7
    inst[0:30, 0:40] = 24000
    inst[50:90, 10:60] = 26003
    inst[60:100, 70:100] = 26  # car group: no instance
    wide = np.zeros((100, 100), bool)
    wide[45:95, 5:65] = True
    return inst, [(inst == 24000, 24, 0.8), (wide, 26, 0.7), (inst == 26, 26, 0.6),
                  (inst == 24000, 25, 0.5)]


def _write_instance_case(root, case):
    inst, masks = _instance_case(case)
    base = f"c_{sorted(INSTANCE_CASES).index(case):06d}_000000"
    gt_path = str(root / f"{base}_gtFine_instanceIds.png")
    Image.fromarray(inst.astype(np.uint16)).save(gt_path)
    pred_dir = root / "pred"
    pred_dir.mkdir(exist_ok=True)
    lines = []
    for i, (mask, label, conf) in enumerate(masks):
        name = f"{base}_mask{i}.png"
        Image.fromarray((mask * 255).astype(np.uint8)).save(pred_dir / name)
        lines.append(f"{name} {label} {conf}")
    txt = pred_dir / f"{base}.txt"
    txt.write_text("\n".join(lines) + "\n")
    return str(txt), gt_path


INSTANCE_CASES = ["perfect", "partial", "false_positive", "fp_on_void", "small_gt",
                  "missed_gt", "mixed"]


def _instance_args(module, root, tag, distance=False):
    args = module.InstanceEvalArgs()
    args.quiet, args.colorized, args.json_output = True, False, True
    args.export_file = str(root / tag / "result.json")
    args.gt_instances_file = str(root / tag / "gtInstances.json")
    args.prediction_path = str(root / "pred")
    args.distance_available = distance
    return args


@pytest.mark.parametrize("case", INSTANCE_CASES)
def test_instance_scorer_equals_the_jax_scorer(tmp_path, case):
    pred_txt, gt_path = _write_instance_case(tmp_path, case)
    results = []
    for module, tag in ((j_instance_eval, "jax"), (instance_eval, "port")):
        args = _instance_args(module, tmp_path, tag)
        results.append(module.evaluate_img_lists([pred_txt], [gt_path], args))
        with open(args.gt_instances_file) as f:
            results.append(json.load(f))
    want, want_gt, got, got_gt = results
    assert _json(got) == _json(want)
    assert got_gt == want_gt


def test_instance_scorer_all_cases_with_distances_equal_the_jax_scorer(tmp_path):
    """Every case in one evaluation, with the distance-gated variants on, a
    distance-annotated GT cache, and the CSV report."""
    pairs = [_write_instance_case(tmp_path, case) for case in INSTANCE_CASES]
    preds, gts = [p for p, _ in pairs], [g for _, g in pairs]
    from fcn8s_tensorflow_tpu_torch.evaluation.instance import instances_to_dict

    cache = instances_to_dict(gts)
    for per_image in cache.values():
        for records in per_image.values():
            for rec in records:
                rec["medDist"], rec["distConf"] = 30.0 + rec["instID"] % 7 * 20, 0.9
    results = []
    for module, tag in ((j_instance_eval, "jax"), (instance_eval, "port")):
        args = _instance_args(module, tmp_path, tag, distance=True)
        os.makedirs(os.path.dirname(args.gt_instances_file), exist_ok=True)
        with open(args.gt_instances_file, "w") as f:
            json.dump(cache, f)
        results.append(module.evaluate_img_lists(preds, gts, args))
        args.quiet, args.csv = False, True
        module.print_results(results[-1], args)
    assert _json(results[1]) == _json(results[0])
    assert "allAp50m" in results[1]


def test_instance_scorer_cli_equals_the_jax_cli(tmp_path, monkeypatch, capsys):
    """``main([])`` with the dataset and results in the environment."""
    ds = tmp_path / "ds"
    gt_dir = ds / "gtFine" / "val" / "c"
    gt_dir.mkdir(parents=True)
    pred_txt, gt_path = _write_instance_case(gt_dir, "mixed")
    os.replace(os.path.dirname(pred_txt), tmp_path / "results")
    monkeypatch.setenv("CITYSCAPES_DATASET", str(ds))
    monkeypatch.setenv("CITYSCAPES_RESULTS", str(tmp_path / "results"))
    outs = []
    for module in (j_instance_eval, instance_eval):
        cache = ds / "gtInstances.json"
        if cache.exists():
            cache.unlink()
        outs.append((module.main([]), capsys.readouterr().out))
    assert _json(outs[1][0]) == _json(outs[0][0])
    assert outs[1][1] == outs[0][1]
