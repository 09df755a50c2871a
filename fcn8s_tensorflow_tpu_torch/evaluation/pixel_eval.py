"""Offline pixel-level semantic-labeling evaluation (the Cityscapes
benchmark scorer).

Port of ``fcn8s_tensorflow_tpu/evaluation/pixel_eval.py``, a copy, which
re-implements the reference's ``cityscapesscripts/evaluation/
evalPixelLevelSemanticLabeling.py`` with the same scores and report surface.
Run it as ``python -m fcn8s_tensorflow_tpu_torch.evaluation.pixel_eval``:

* per-class IoU where FP excludes pixels whose GT label is ignored (`:229-255`);
* instance-weighted iIoU using the dataset's average-class-size priors
  (`:148-159, 258-278`);
* per-category IoU / iIoU (`:298-351`);
* env-var configuration (CITYSCAPES_DATASET / CITYSCAPES_RESULTS /
  CITYSCAPES_EXPORT_DIR, `:120-134`), prediction discovery by
  `<city>_<seq>_<frame>*.png` pattern (`:69-106`), colorized terminal report,
  JSON export (`:355-381`), per-pair pixel-count==confMatrix.sum() sanity
  check (`:479-490`).

Differences by design: the confusion matrix accumulates through the
multithreaded C++ kernel (native/confusion_matrix.cpp, ``evaluation/confmat.py``;
no quiet numpy fallback in the port) instead of Cython,
score computation is vectorized NumPy instead of per-label Python loops, and
everything is importable as a library (the CLI `main` is a thin wrapper).
"""

from __future__ import annotations

import fnmatch
import math
import os
import sys
from dataclasses import dataclass, field

import numpy as np
from PIL import Image

from ..labels.cityscapes import category2labels, id2label, labels
from ..utils.cs_helpers import (
    colors,
    get_color_entry,
    get_cs_file_info,
    print_error,
    write_dict_to_json,
)
from . import confmat

# Average instance sizes per class, from the Cityscapes dataset statistics
# (reference `evalPixelLevelSemanticLabeling.py:148-159`) — priors for the
# instance-weighted iIoU score.
AVG_CLASS_SIZE = {
    "bicycle": 4672.3249222261,
    "caravan": 36771.8241758242,
    "motorcycle": 6298.7200839748,
    "rider": 3930.4788056518,
    "bus": 35732.1511111111,
    "train": 67583.7075812274,
    "car": 12794.0202738185,
    "person": 3462.4756337644,
    "truck": 27855.1264367816,
    "trailer": 16926.9763313609,
}


@dataclass
class EvalArgs:
    """Evaluation configuration (the reference's env-var-initialized CArgs
    bag, `:115-164`)."""

    cityscapes_path: str = ""
    export_file: str = ""
    ground_truth_search: str = ""
    eval_inst_level_score: bool = True
    eval_pixel_accuracy: bool = False
    eval_labels: list = field(default_factory=list)
    print_row: int = 5
    normalized: bool = True
    colorized: bool = False
    json_output: bool = True
    quiet: bool = False
    avg_class_size: dict = field(default_factory=lambda: dict(AVG_CLASS_SIZE))
    prediction_path: str | None = None
    prediction_walk: list | None = None

    @property
    def bold(self):
        return colors.BOLD if self.colorized else ""

    @property
    def nocol(self):
        return colors.ENDC if self.colorized else ""


def default_args() -> EvalArgs:
    args = EvalArgs()
    args.cityscapes_path = os.environ.get(
        "CITYSCAPES_DATASET", os.path.join(os.path.dirname(__file__), "..", "..")
    )
    if "CITYSCAPES_EXPORT_DIR" in os.environ:
        export_dir = os.environ["CITYSCAPES_EXPORT_DIR"]
        if not os.path.isdir(export_dir):
            raise ValueError(f"CITYSCAPES_EXPORT_DIR {export_dir} is not a directory")
        args.export_file = os.path.join(export_dir, "resultPixelLevelSemanticLabeling.json")
    else:
        args.export_file = os.path.join(
            args.cityscapes_path, "evaluationResults", "resultPixelLevelSemanticLabeling.json"
        )
    args.ground_truth_search = os.path.join(
        args.cityscapes_path, "gtFine", "val", "*", "*_gtFine_labelIds.png"
    )
    args.colorized = hasattr(sys.stderr, "isatty") and sys.stderr.isatty()
    return args


def get_prediction(args: EvalArgs, ground_truth_file: str) -> str:
    """Find the prediction PNG matching a GT file by
    ``<city>_<seq>_<frame>*.png`` under the results root (reference `:69-106`)."""
    if not args.prediction_path:
        if "CITYSCAPES_RESULTS" in os.environ:
            root_path = os.environ["CITYSCAPES_RESULTS"]
        elif "CITYSCAPES_DATASET" in os.environ:
            root_path = os.path.join(os.environ["CITYSCAPES_DATASET"], "results")
        else:
            root_path = os.path.join(os.path.dirname(__file__), "..", "..", "results")
        if not os.path.isdir(root_path):
            print_error("Could not find a result root folder. Please read the instructions of this method.")
        args.prediction_path = root_path

    if not args.prediction_walk:
        args.prediction_walk = [(root, files) for root, _, files in os.walk(args.prediction_path)]

    cs_file = get_cs_file_info(ground_truth_file)
    pattern = f"{cs_file.city}_{cs_file.sequenceNb}_{cs_file.frameNb}*.png"
    prediction_file = None
    for root, filenames in args.prediction_walk:
        for filename in fnmatch.filter(filenames, pattern):
            if prediction_file is None:
                prediction_file = os.path.join(root, filename)
            else:
                print_error(f"Found multiple predictions for ground truth {ground_truth_file}")
    if prediction_file is None:
        print_error(f"Found no prediction for ground truth {ground_truth_file}")
    return prediction_file


# ---------------------------------------------------------------------------
# score computation (vectorized)
# ---------------------------------------------------------------------------


def generate_matrix(args: EvalArgs) -> np.ndarray:
    args.eval_labels = [label.id for label in labels if label.id >= 0]
    max_id = max(args.eval_labels)
    return np.zeros((max_id + 1, max_id + 1), dtype=np.uint64)


def generate_instance_stats(args: EvalArgs) -> dict:
    stats = {"classes": {}, "categories": {}}
    for label in labels:
        if label.hasInstances and not label.ignoreInEval:
            stats["classes"][label.name] = {"tp": 0.0, "tpWeighted": 0.0, "fn": 0.0, "fnWeighted": 0.0}
    for category, cat_labels in category2labels.items():
        label_ids = []
        if all(l.hasInstances for l in cat_labels if l.id >= 0) and any(
            l.id >= 0 for l in cat_labels
        ):
            label_ids = [l.id for l in cat_labels if l.id >= 0]
            stats["categories"][category] = {
                "tp": 0.0, "tpWeighted": 0.0, "fn": 0.0, "fnWeighted": 0.0,
                "labelIds": label_ids,
            }
    return stats


def get_iou_score_for_label(label: int, conf_matrix: np.ndarray, args: EvalArgs) -> float:
    """Per-class IoU; FP counted only from non-ignored GT rows (reference `:229-255`)."""
    if id2label[label].ignoreInEval:
        return float("nan")
    conf = conf_matrix.astype(np.int64)
    tp = conf[label, label]
    fn = conf[label, :].sum() - tp
    not_ignored = [l for l in args.eval_labels if not id2label[l].ignoreInEval and l != label]
    fp = conf[not_ignored, label].sum()
    denom = tp + fp + fn
    return float(tp) / denom if denom else float("nan")


def get_instance_iou_score_for_label(label, conf_matrix, inst_stats, args) -> float:
    if id2label[label].ignoreInEval:
        return float("nan")
    name = id2label[label].name
    if name not in inst_stats["classes"]:
        return float("nan")
    conf = conf_matrix.astype(np.int64)
    tp = inst_stats["classes"][name]["tpWeighted"]
    fn = inst_stats["classes"][name]["fnWeighted"]
    not_ignored = [l for l in args.eval_labels if not id2label[l].ignoreInEval and l != label]
    fp = conf[not_ignored, label].sum()
    denom = tp + fp + fn
    return float(tp) / denom if denom else float("nan")


def get_iou_score_for_category(category, conf_matrix, args) -> float:
    cat_labels = category2labels[category]
    label_ids = [l.id for l in cat_labels if not l.ignoreInEval and l.id in args.eval_labels]
    if not label_ids:
        return float("nan")
    conf = conf_matrix.astype(np.int64)
    tp = conf[np.ix_(label_ids, label_ids)].sum()
    fn = conf[label_ids, :].sum() - tp
    outside = [
        l for l in args.eval_labels
        if not id2label[l].ignoreInEval and id2label[l].category != category
    ]
    fp = conf[np.ix_(outside, label_ids)].sum()
    denom = tp + fp + fn
    return float(tp) / denom if denom else float("nan")


def get_instance_iou_score_for_category(category, conf_matrix, inst_stats, args) -> float:
    if category not in inst_stats["categories"]:
        return float("nan")
    conf = conf_matrix.astype(np.int64)
    entry = inst_stats["categories"][category]
    tp, fn = entry["tpWeighted"], entry["fnWeighted"]
    outside = [
        l for l in args.eval_labels
        if not id2label[l].ignoreInEval and id2label[l].category != category
    ]
    fp = conf[np.ix_(outside, entry["labelIds"])].sum()
    denom = tp + fp + fn
    return float(tp) / denom if denom else float("nan")


def get_prior(label: int, conf_matrix: np.ndarray) -> float:
    total = conf_matrix.sum()
    return float(conf_matrix[label, :].sum()) / total if total else float("nan")


def get_score_average(score_dict: dict, args: EvalArgs) -> float:
    valid = [v for v in score_dict.values() if not math.isnan(v)]
    return sum(valid) / len(valid) if valid else float("nan")


# ---------------------------------------------------------------------------
# per-pair evaluation
# ---------------------------------------------------------------------------


def evaluate_pair(prediction_file, ground_truth_file, conf_matrix, inst_stats,
                  per_image_stats, args: EvalArgs) -> int:
    """Accumulate one prediction/GT pair (reference `evaluatePair`, `:550-645`)."""
    try:
        prediction = np.array(Image.open(prediction_file))
    except Exception:
        print_error("Unable to load " + prediction_file)
    try:
        ground_truth = np.array(Image.open(ground_truth_file))
    except Exception:
        print_error("Unable to load " + ground_truth_file)

    if prediction.shape[:2] != ground_truth.shape[:2]:
        print_error(
            f"Image sizes of {prediction_file} and {ground_truth_file} are not equal."
        )
    if prediction.ndim != 2:
        print_error("Predicted image has multiple channels.")

    bad = confmat.find_invalid_label(ground_truth, args.eval_labels)
    if bad >= 0:
        print_error(f"Unknown label with id {ground_truth.reshape(-1)[bad]}")

    confmat.accumulate_confusion(prediction, ground_truth, conf_matrix)

    if args.eval_inst_level_score:
        instance_file = ground_truth_file.replace("labelIds", "instanceIds")
        try:
            instance_map = np.array(Image.open(instance_file)).astype(np.int32)
        except Exception:
            print_error("Unable to load " + instance_file)
        _accumulate_instance_stats(prediction, instance_map, inst_stats, args)

    if args.eval_pixel_accuracy:
        not_ignored = [l for l in args.eval_labels if not id2label[l].ignoreInEval]
        lut = np.zeros(256, dtype=bool)
        lut[not_ignored] = True
        not_ignored_px = lut[ground_truth]
        erroneous = not_ignored_px & (prediction != ground_truth)
        n_not_ignored = int(np.count_nonzero(not_ignored_px))
        # Divergence from the reference (documented in README): the
        # reference stores the ERRONEOUS count under "nbCorrectPixels"
        # (`evalPixelLevelSemanticLabeling.py:637-643`, compounding its
        # inverted-mask bug). We store actual correct pixels.
        per_image_stats[prediction_file] = {
            "nbNotIgnoredPixels": n_not_ignored,
            "nbCorrectPixels": n_not_ignored - int(np.count_nonzero(erroneous)),
        }

    return prediction.shape[0] * prediction.shape[1]


def _accumulate_instance_stats(prediction, instance_map, inst_stats, args) -> None:
    """Instance-weighted tp/fn with avgClassSize priors (reference `:595-635`)."""
    category_masks = {
        category: np.isin(prediction, entry["labelIds"])
        for category, entry in inst_stats["categories"].items()
    }
    for inst_id in np.unique(instance_map[instance_map > 1000]):
        label_id = int(inst_id // 1000)
        label = id2label[label_id]
        if label.ignoreInEval:
            continue
        tp, inst_size = confmat.instance_tp_size(prediction, instance_map, int(inst_id), label_id)
        fn = inst_size - tp
        weight = args.avg_class_size[label.name] / float(inst_size)
        cls = inst_stats["classes"][label.name]
        cls["tp"] += tp
        cls["fn"] += fn
        cls["tpWeighted"] += tp * weight
        cls["fnWeighted"] += fn * weight

        category = label.category
        if category in inst_stats["categories"]:
            mask = instance_map == inst_id
            cat_tp = int(np.count_nonzero(mask & category_masks[category]))
            cat_fn = inst_size - cat_tp
            cat = inst_stats["categories"][category]
            cat["tp"] += cat_tp
            cat["fn"] += cat_fn
            cat["tpWeighted"] += cat_tp * weight
            cat["fnWeighted"] += cat_fn * weight


# ---------------------------------------------------------------------------
# report printing
# ---------------------------------------------------------------------------


def print_conf_matrix(conf_matrix, args: EvalArgs) -> None:
    """Colorized normalized confusion matrix (reference `:384-429`)."""
    header = " ".join(f"{id2label[l].name[0]:^{args.print_row}}" for l in args.eval_labels)
    print(f"{'':>13} | {header} | Prior")
    total = conf_matrix.sum()
    for x in args.eval_labels:
        row_sum = conf_matrix[x].sum()
        if total == 0 or row_sum == 0:
            continue
        prior = float(row_sum) / total
        cells = []
        for y in args.eval_labels:
            val = float(conf_matrix[x, y]) / row_sum if args.normalized else float(conf_matrix[x, y])
            cells.append(
                get_color_entry(val, args) + f"{val:>{args.print_row}.2f}" + args.nocol
            )
        name = id2label[x].name[:13]
        print(f"{name:>13} | " + " ".join(cells) + f" | {prior:>6.4f}")


def print_class_scores(score_dict, inst_score_dict, args: EvalArgs) -> None:
    if args.quiet:
        return
    print(args.bold + "classes          IoU      nIoU" + args.nocol)
    print("--------------------------------")
    for label in args.eval_labels:
        if id2label[label].ignoreInEval:
            continue
        name = id2label[label].name
        iou = get_color_entry(score_dict[name], args) + f"{score_dict[name]:>5.3f}" + args.nocol
        niou = get_color_entry(inst_score_dict[name], args) + f"{inst_score_dict[name]:>5.3f}" + args.nocol
        print(f"{name:<14}: {iou}    {niou}")


def print_category_scores(score_dict, inst_score_dict, args: EvalArgs) -> None:
    if args.quiet:
        return
    print(args.bold + "categories       IoU      nIoU" + args.nocol)
    print("--------------------------------")
    for category in score_dict:
        if all(l.ignoreInEval for l in category2labels[category]):
            continue
        iou = get_color_entry(score_dict[category], args) + f"{score_dict[category]:>5.3f}" + args.nocol
        niou = get_color_entry(inst_score_dict[category], args) + f"{inst_score_dict[category]:>5.3f}" + args.nocol
        print(f"{category:<14}: {iou}    {niou}")


def create_result_dict(conf_matrix, class_scores, class_inst_scores, category_scores,
                       category_inst_scores, per_image_stats, args: EvalArgs) -> dict:
    """JSON-exportable result structure (reference `createResultDict`, `:355-376`)."""
    data = {
        "confMatrix": conf_matrix.tolist(),
        "priors": {id2label[l].name: get_prior(l, conf_matrix) for l in args.eval_labels},
        "labels": {id2label[l].name: l for l in args.eval_labels},
        "classScores": class_scores,
        "classInstScores": class_inst_scores,
        "categoryScores": category_scores,
        "categoryInstScores": category_inst_scores,
        "averageScoreClasses": get_score_average(class_scores, args),
        "averageScoreInstClasses": get_score_average(class_inst_scores, args),
        "averageScoreCategories": get_score_average(category_scores, args),
        "averageScoreInstCategories": get_score_average(category_inst_scores, args),
    }
    if per_image_stats:
        data["perImageScores"] = per_image_stats
    return data


# ---------------------------------------------------------------------------
# top-level entry points
# ---------------------------------------------------------------------------


def evaluate_img_lists(prediction_list, ground_truth_list, args: EvalArgs) -> dict:
    """Evaluate aligned prediction/GT file lists (reference `:460-546`)."""
    if len(prediction_list) != len(ground_truth_list):
        print_error("List of images for prediction and groundtruth are not of equal size.")
    conf_matrix = generate_matrix(args)
    inst_stats = generate_instance_stats(args)
    per_image_stats = {}
    nb_pixels = 0

    if not args.quiet:
        print(f"Evaluating {len(prediction_list)} pairs of images...")

    for i, (pred_file, gt_file) in enumerate(zip(prediction_list, ground_truth_list)):
        nb_pixels += evaluate_pair(pred_file, gt_file, conf_matrix, inst_stats, per_image_stats, args)
        if conf_matrix.sum() != nb_pixels:
            print_error(
                "Number of analyzed pixels and entries in confusion matrix disagree: "
                f"confMatrix {conf_matrix.sum()}, pixels {nb_pixels}"
            )
        if not args.quiet:
            print(f"\rImages Processed: {i + 1}", end=" ")
            sys.stdout.flush()
    if not args.quiet:
        print("\n")
        print_conf_matrix(conf_matrix, args)

    class_scores = {
        id2label[l].name: get_iou_score_for_label(l, conf_matrix, args) for l in args.eval_labels
    }
    class_inst_scores = {
        id2label[l].name: get_instance_iou_score_for_label(l, conf_matrix, inst_stats, args)
        for l in args.eval_labels
    }
    if not args.quiet:
        print("\n")
        print_class_scores(class_scores, class_inst_scores, args)
        avg = get_score_average(class_scores, args)
        navg = get_score_average(class_inst_scores, args)
        print("--------------------------------")
        print(f"Score Average : {avg:5.3f}    {navg:5.3f}")
        print("--------------------------------\n")

    category_scores = {
        c: get_iou_score_for_category(c, conf_matrix, args) for c in category2labels
    }
    category_inst_scores = {
        c: get_instance_iou_score_for_category(c, conf_matrix, inst_stats, args)
        for c in category2labels
    }
    if not args.quiet:
        print_category_scores(category_scores, category_inst_scores, args)
        avg = get_score_average(category_scores, args)
        navg = get_score_average(category_inst_scores, args)
        print("--------------------------------")
        print(f"Score Average : {avg:5.3f}    {navg:5.3f}")
        print("--------------------------------\n")

    results = create_result_dict(
        conf_matrix, class_scores, class_inst_scores, category_scores,
        category_inst_scores, per_image_stats, args,
    )
    if args.json_output and args.export_file:
        write_dict_to_json(results, args.export_file)
    return results


def main(argv=None) -> dict:
    """CLI (reference `:648-674`): with file arguments, split them into
    gt/pred lists by substring; with none, glob the GT search path and
    discover predictions."""
    import glob as globmod

    argv = argv if argv is not None else sys.argv[1:]
    args = default_args()
    prediction_list, ground_truth_list = [], []
    if len(argv) > 3:
        for arg in argv:
            if "gt" in arg or "groundtruth" in arg:
                ground_truth_list.append(arg)
            elif "pred" in arg:
                prediction_list.append(arg)
    elif len(argv) == 0:
        ground_truth_list = globmod.glob(args.ground_truth_search)
        if not ground_truth_list:
            print_error(
                "Cannot find any ground truth images to use for evaluation. "
                f"Searched for: {args.ground_truth_search}"
            )
        prediction_list = [get_prediction(args, gt) for gt in ground_truth_list]
    return evaluate_img_lists(prediction_list, ground_truth_list, args)


if __name__ == "__main__":
    main()
