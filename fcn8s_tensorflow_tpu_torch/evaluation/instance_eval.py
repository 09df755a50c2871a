"""Offline instance-level semantic-labeling evaluation (AP / AP50%).

Port of ``fcn8s_tensorflow_tpu/evaluation/instance_eval.py``, a copy (pure
numpy and PIL), which re-implements the reference's
``cityscapesscripts/evaluation/evalInstanceLevelSemanticLabeling.py``. Run it
as ``python -m fcn8s_tensorflow_tpu_torch.evaluation.instance_eval``. As
there:

* predictions are given as per-image text files — lines of
  ``relPathToMask labelID confidence`` (`readPredInfo`, `:160-185`);
* GT instances come from ``*_instanceIds.png`` (id = labelId*1000+n), cached
  to ``gtInstances.json`` (`:191-208`);
* greedy overlap matching of predictions to GT instances (`:218-351`);
* AP per class x overlap in {0.5, 0.55, ..., 0.95}, min region 100px, with
  the reference's exact ignore rules (void intersection, group regions,
  too-small GT) and step-wise precision-recall integration (`:352-548`);
* averages: AP (mean over overlaps) and AP50% (`computeAverages`, `:549-576`);
* env-var config, colorized report, JSON export.

The distance-gated variants (minRegionSizes/distanceThs beyond the first
entry) follow the reference's ``distanceAvailable`` switch: with the default
``distance_available=False`` only the first entry is evaluated; setting it
True evaluates all three gates and adds the AP_50m / AP_100m / AP_50%50m
columns (reference `:560-564`, exercised end-to-end in
``tests/test_instance_eval.py::test_distance_gated_variants_end_to_end``).
"""

from __future__ import annotations

import fnmatch
import os
import sys
from copy import deepcopy
from dataclasses import dataclass, field

import numpy as np
from PIL import Image

from ..labels.cityscapes import id2label, labels
from ..utils.cs_helpers import get_color_entry, get_cs_file_info, print_error, write_dict_to_json
from .instance import instances_to_dict


@dataclass
class InstanceEvalArgs:
    cityscapes_path: str = ""
    export_file: str = ""
    ground_truth_search: str = ""
    overlaps: np.ndarray = field(default_factory=lambda: np.arange(0.5, 1.0, 0.05))
    min_region_sizes: np.ndarray = field(default_factory=lambda: np.array([100, 1000, 1000]))
    distance_ths: np.ndarray = field(default_factory=lambda: np.array([float("inf"), 100, 50]))
    distance_confs: np.ndarray = field(default_factory=lambda: np.array([-float("inf"), 0.5, 0.5]))
    gt_instances_file: str = "gtInstances.json"
    distance_available: bool = False
    json_output: bool = True
    quiet: bool = False
    csv: bool = False
    colorized: bool = True
    inst_labels: list = field(default_factory=list)
    prediction_path: str | None = None
    prediction_walk: list | None = None

    @property
    def bold(self):
        from ..utils.cs_helpers import colors

        return colors.BOLD if self.colorized else ""

    @property
    def nocol(self):
        from ..utils.cs_helpers import colors

        return colors.ENDC if self.colorized else ""


def default_args() -> InstanceEvalArgs:
    args = InstanceEvalArgs()
    args.cityscapes_path = os.environ.get(
        "CITYSCAPES_DATASET", os.path.join(os.path.dirname(__file__), "..", "..")
    )
    args.export_file = os.path.join(
        args.cityscapes_path, "evaluationResults", "resultInstanceLevelSemanticLabeling.json"
    )
    args.ground_truth_search = os.path.join(
        args.cityscapes_path, "gtFine", "val", "*", "*_gtFine_instanceIds.png"
    )
    args.gt_instances_file = os.path.join(args.cityscapes_path, "gtInstances.json")
    return args


def set_inst_labels(args: InstanceEvalArgs) -> None:
    """Evaluated labels: hasInstances and not ignoreInEval (reference
    `setInstanceLabels`)."""
    args.inst_labels = sorted(
        label.name for label in labels if label.hasInstances and not label.ignoreInEval
    )


def get_prediction(args: InstanceEvalArgs, ground_truth_file: str) -> str:
    """Find the `.txt` prediction info file matching a GT instance file
    (reference `:60-103`)."""
    if not args.prediction_path:
        if "CITYSCAPES_RESULTS" in os.environ:
            root = os.environ["CITYSCAPES_RESULTS"]
        elif "CITYSCAPES_DATASET" in os.environ:
            root = os.path.join(os.environ["CITYSCAPES_DATASET"], "results")
        else:
            print_error("Could not find a result root folder.")
        if not os.path.isdir(root):
            print_error("Could not find a result root folder.")
        args.prediction_path = root
    if not args.prediction_walk:
        args.prediction_walk = [(r, files) for r, _, files in os.walk(args.prediction_path)]
    cs = get_cs_file_info(ground_truth_file)
    pattern = f"{cs.city}_{cs.sequenceNb}_{cs.frameNb}*.txt"
    found = None
    for root, files in args.prediction_walk:
        for f in fnmatch.filter(files, pattern):
            if found is None:
                found = os.path.join(root, f)
            else:
                print_error(f"Found multiple predictions for ground truth {ground_truth_file}")
    if found is None:
        print_error(f"Found no prediction for ground truth {ground_truth_file}")
    return found


def read_pred_info(pred_info_file: str, args: InstanceEvalArgs) -> dict:
    """Parse ``relPath labelID confidence`` lines (reference `:160-185`)."""
    pred_info = {}
    if not os.path.isfile(pred_info_file):
        print_error(f"Infofile '{pred_info_file}' for the predictions not found.")
    with open(pred_info_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 3:
                print_error(
                    "Invalid prediction file. Expected content: "
                    "relPathPrediction1 labelIDPrediction1 confidencePrediction1"
                )
            if os.path.isabs(parts[0]):
                print_error("Invalid prediction file. First entry in each line must be a relative path.")
            filename = os.path.abspath(os.path.join(os.path.dirname(pred_info_file), parts[0]))
            if args.prediction_path and os.path.commonprefix(
                [filename, args.prediction_path]
            ) != args.prediction_path:
                print_error(
                    f"Predicted mask {filename} in prediction text file {pred_info_file} "
                    "points outside of prediction path."
                )
            pred_info[filename] = {"labelID": int(float(parts[1])), "conf": float(parts[2])}
    return pred_info


def get_gt_instances(ground_truth_list, args: InstanceEvalArgs) -> dict:
    """Load or build (and cache) the GT instance dictionary (reference `:191-208`)."""
    import json

    if os.path.isfile(args.gt_instances_file):
        if not args.quiet:
            print("Loading ground truth instances from JSON.")
        with open(args.gt_instances_file) as f:
            return json.load(f)
    if not args.quiet:
        print("Creating ground truth instances from png files.")
    gt_instances = instances_to_dict(ground_truth_list, not args.quiet)
    write_dict_to_json(gt_instances, args.gt_instances_file)
    return gt_instances


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------


def assign_gt_to_preds(gt_instances_orig, gt_image, pred_info, args):
    """Intersect every prediction mask with every same-label GT instance
    (reference `assignGt2Preds`, `:252-351`)."""
    pred_instances = {label: [] for label in args.inst_labels}
    pred_count = 0

    gt_instances = deepcopy(gt_instances_orig)
    for label in gt_instances:
        for gt in gt_instances[label]:
            gt["matchedPred"] = []

    gt_np = np.array(gt_image)
    void_ids = [label.id for label in labels if label.ignoreInEval]
    bool_void = np.isin(gt_np, void_ids)

    for pred_file, info in pred_info.items():
        label_id = info["labelID"]
        label_name = id2label[int(label_id)].name
        if label_name not in args.inst_labels:
            continue
        pred_np = np.array(Image.open(pred_file).convert("L"))
        bool_pred = pred_np != 0
        pixel_count = int(np.count_nonzero(bool_pred))
        if not pixel_count:
            continue

        pred_instance = {
            "imgName": pred_file,
            "predID": pred_count,
            "labelID": int(label_id),
            "pixelCount": pixel_count,
            "confidence": info["conf"],
            "voidIntersection": int(np.count_nonzero(bool_void & bool_pred)),
        }

        matched_gt = []
        for gt_num, gt_instance in enumerate(gt_instances_orig.get(label_name, [])):
            intersection = int(np.count_nonzero((gt_np == gt_instance["instID"]) & bool_pred))
            if intersection > 0:
                gt_copy = dict(gt_instance)
                pred_copy = dict(pred_instance)
                gt_copy["intersection"] = intersection
                pred_copy["intersection"] = intersection
                matched_gt.append(gt_copy)
                gt_instances[label_name][gt_num]["matchedPred"].append(pred_copy)

        pred_instance["matchedGt"] = matched_gt
        pred_count += 1
        pred_instances[label_name].append(pred_instance)

    return gt_instances, pred_instances


def match_gt_with_preds(prediction_list, ground_truth_list, gt_instances, args):
    """(reference `matchGtWithPreds`, `:218-249`)"""
    matches = {}
    if not args.quiet:
        print(f"Matching {len(prediction_list)} pairs of images...")
    for i, (pred, gt) in enumerate(zip(prediction_list, ground_truth_list)):
        key = os.path.abspath(gt)
        gt_image = Image.open(gt)
        pred_info = read_pred_info(pred, args)
        filtered = {
            name: insts for name, insts in gt_instances[key].items() if name in args.inst_labels
        }
        cur_gt, cur_pred = assign_gt_to_preds(filtered, gt_image, pred_info, args)
        matches[key] = {"groundTruth": cur_gt, "prediction": cur_pred}
        if not args.quiet:
            print(f"\rImages Processed: {i + 1}", end=" ", flush=True)
    if not args.quiet:
        print("")
    return matches


# ---------------------------------------------------------------------------
# AP computation
# ---------------------------------------------------------------------------


def evaluate_matches(matches, args: InstanceEvalArgs) -> np.ndarray:
    """AP tensor (distance-variant, class, overlap) with the reference's
    exact FP-ignore rules and step-integrated PR curve (`:352-548`)."""
    overlaps = np.asarray(args.overlaps)
    if not args.distance_available:
        min_region_sizes = [args.min_region_sizes[0]]
        dist_ths = [args.distance_ths[0]]
        dist_confs = [args.distance_confs[0]]
    else:
        min_region_sizes = list(args.min_region_sizes)
        dist_ths = list(args.distance_ths)
        dist_confs = list(args.distance_confs)

    ap = np.zeros((len(dist_ths), len(args.inst_labels), len(overlaps)), float)

    for d_i, (min_region, dist_th, dist_conf) in enumerate(
        zip(min_region_sizes, dist_ths, dist_confs)
    ):
        for o_i, overlap_th in enumerate(overlaps):
            for l_i, label_name in enumerate(args.inst_labels):
                y_true = []
                y_score = []
                hard_fns = 0
                have_gt = False
                have_pred = False

                for img in matches:
                    pred_instances = matches[img]["prediction"][label_name]
                    gt_all = matches[img]["groundTruth"][label_name]
                    gt_instances = [
                        gt for gt in gt_all
                        if gt["instID"] >= 1000
                        and gt["pixelCount"] >= min_region
                        and gt["medDist"] <= dist_th
                        and gt["distConf"] >= dist_conf
                    ]
                    if gt_instances:
                        have_gt = True
                    if pred_instances:
                        have_pred = True

                    cur_true = []
                    cur_score = []
                    # per-GT best match bookkeeping
                    for gt in gt_instances:
                        best_score = None
                        found_match = False
                        for pred in gt["matchedPred"]:
                            overlap = pred["intersection"] / (
                                gt["pixelCount"] + pred["pixelCount"] - pred["intersection"]
                            )
                            if overlap > overlap_th:
                                confidence = pred["confidence"]
                                if best_score is not None:
                                    # second match: the lower-scored one is an FP
                                    lo, hi = sorted([best_score, confidence])
                                    best_score = hi
                                    cur_true.append(0)
                                    cur_score.append(lo)
                                else:
                                    found_match = True
                                    best_score = confidence
                        if best_score is not None:
                            cur_true.append(1)
                            cur_score.append(best_score)
                        if not found_match:
                            hard_fns += 1

                    # unmatched predictions -> FPs unless mostly-ignored
                    for pred in pred_instances:
                        found_gt = any(
                            gt["intersection"]
                            / (gt["pixelCount"] + pred["pixelCount"] - gt["intersection"])
                            > overlap_th
                            for gt in pred["matchedGt"]
                        )
                        if not found_gt:
                            nb_ignore = pred["voidIntersection"]
                            for gt in pred["matchedGt"]:
                                if gt["instID"] < 1000:  # group region
                                    nb_ignore += gt["intersection"]
                                if (
                                    gt["pixelCount"] < min_region
                                    or gt["medDist"] > dist_th
                                    or gt["distConf"] < dist_conf
                                ):
                                    nb_ignore += gt["intersection"]
                            if nb_ignore / pred["pixelCount"] <= overlap_th:
                                cur_true.append(0)
                                cur_score.append(pred["confidence"])

                    y_true.extend(cur_true)
                    y_score.extend(cur_score)

                if have_gt and have_pred:
                    ap[d_i, l_i, o_i] = _average_precision(
                        np.asarray(y_true, float), np.asarray(y_score, float), hard_fns
                    )
                elif have_gt:
                    ap[d_i, l_i, o_i] = 0.0
                else:
                    ap[d_i, l_i, o_i] = float("nan")
    return ap


def _average_precision(y_true: np.ndarray, y_score: np.ndarray, hard_fns: int) -> float:
    """Step-wise-integrated PR curve with the reference's construction
    (`:487-538`): unique-threshold points plus the artificial (r=0, p=1)."""
    order = np.argsort(y_score)
    y_score = y_score[order]
    y_true = y_true[order]
    cumsum = np.cumsum(y_true)
    thresholds, unique_idx = np.unique(y_score, return_index=True)

    nb_examples = len(y_score)
    nb_true = cumsum[-1] if nb_examples else 0
    n_points = len(unique_idx) + 1
    precision = np.zeros(n_points)
    recall = np.zeros(n_points)
    cumsum_ext = np.append(cumsum, 0)  # index -1 reads this 0

    for res_i, score_i in enumerate(unique_idx):
        below = cumsum_ext[score_i - 1]
        tp = nb_true - below
        fp = nb_examples - score_i - tp
        fn = below + hard_fns
        precision[res_i] = tp / (tp + fp) if tp + fp else 0.0
        recall[res_i] = tp / (tp + fn) if tp + fn else 0.0
    precision[-1] = 1.0
    recall[-1] = 0.0

    # zero-order (step) integration via centered-difference step widths
    recall_conv = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(recall_conv, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def compute_averages(aps: np.ndarray, args: InstanceEvalArgs) -> dict:
    """AP / AP50% (+ distance variants when available), per-class breakdown
    (reference `computeAverages`, `:549-576`)."""
    d_inf = int(np.argmax(args.distance_ths))
    if not args.distance_available:
        d_inf = 0
    d50m = np.where(np.isclose(np.asarray(args.distance_ths), 50.0))
    d100m = np.where(np.isclose(np.asarray(args.distance_ths), 100.0))
    o50 = np.where(np.isclose(np.asarray(args.overlaps), 0.5))
    with np.errstate(invalid="ignore"):
        import warnings

        with warnings.catch_warnings():
            # all-NaN class slices (no GT, no predictions) are expected
            warnings.simplefilter("ignore", RuntimeWarning)
            avg = {
                "allAp": float(np.nanmean(aps[d_inf, :, :])),
                "allAp50%": float(np.nanmean(aps[d_inf, :, o50])),
                "classes": {},
            }
            if args.distance_available:
                # distance-gated variants (reference `:560-564`)
                avg["allAp50m"] = float(np.nanmean(aps[d50m, :, :]))
                avg["allAp100m"] = float(np.nanmean(aps[d100m, :, :]))
                avg["allAp50%50m"] = float(np.nanmean(aps[d50m, :, o50]))
            for l_i, label_name in enumerate(args.inst_labels):
                avg["classes"][label_name] = {
                    "ap": float(np.nanmean(aps[d_inf, l_i, :])),
                    "ap50%": float(np.nanmean(aps[d_inf, l_i, o50])),
                }
                if args.distance_available:
                    avg["classes"][label_name].update({
                        "ap50m": float(np.nanmean(aps[d50m, l_i, :])),
                        "ap100m": float(np.nanmean(aps[d100m, l_i, :])),
                        "ap50%50m": float(np.nanmean(aps[d50m, l_i, o50])),
                    })
    return avg


def print_results(avg_dict: dict, args: InstanceEvalArgs) -> None:
    """Results table; ``args.csv`` switches to comma-separated machine output
    with no rule lines (reference ``printResults``, `:578-627`)."""
    if args.quiet:
        return
    cols = ["ap", "ap50%"] + (
        ["ap50m", "ap100m", "ap50%50m"] if args.distance_available else []
    )
    heads = {"ap": "AP", "ap50%": "AP_50%", "ap50m": "AP_50m",
             "ap100m": "AP_100m", "ap50%50m": "AP_50%50m"}
    all_keys = {"ap": "allAp", "ap50%": "allAp50%", "ap50m": "allAp50m",
                "ap100m": "allAp100m", "ap50%50m": "allAp50%50m"}
    if args.csv:
        # CSV mode disables colorization glue so the output parses cleanly
        # (the reference keeps color codes in CSV; we document the divergence
        # in README — comma-separated ANSI cells are unusable downstream).
        print("what," + ",".join(heads[c] for c in cols))
        for name, entry in avg_dict["classes"].items():
            print(name + "," + ",".join(f"{entry[c]:.3f}" for c in cols))
        print("average," + ",".join(f"{avg_dict[all_keys[c]]:.3f}" for c in cols))
        return
    width = 15 + 10 * len(cols)
    print(args.bold + f"{'what':<15}" + "".join(f"{heads[c]:>10}" for c in cols) + args.nocol)
    print("-" * width)
    for name, entry in avg_dict["classes"].items():
        cells = "".join(
            get_color_entry(entry[c], args) + f"{entry[c]:>10.3f}" + args.nocol
            for c in cols
        )
        print(f"{name:<15}{cells}")
    print("-" * width)
    print(f"{'average':<15}" + "".join(f"{avg_dict[all_keys[c]]:>10.3f}" for c in cols))


def evaluate_img_lists(prediction_list, ground_truth_list, args: InstanceEvalArgs) -> dict:
    """Top-level: build GT instances, match, compute APs, report + export
    (reference `:653+`)."""
    set_inst_labels(args)
    gt_instances = get_gt_instances(ground_truth_list, args)
    matches = match_gt_with_preds(prediction_list, ground_truth_list, gt_instances, args)
    aps = evaluate_matches(matches, args)
    avg_dict = compute_averages(aps, args)
    print_results(avg_dict, args)
    if args.json_output and args.export_file:
        write_dict_to_json(avg_dict, args.export_file)
    return avg_dict


def main(argv=None) -> dict:
    import glob as globmod

    argv = argv if argv is not None else sys.argv[1:]
    args = default_args()
    prediction_list, ground_truth_list = [], []
    if argv:
        for arg in argv:
            if "gt" in arg or "groundtruth" in arg:
                ground_truth_list.append(arg)
            elif "pred" in arg:
                prediction_list.append(arg)
    else:
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
