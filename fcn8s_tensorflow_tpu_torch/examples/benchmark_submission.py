"""End-to-end Cityscapes benchmark submission and self-scoring. Port of
``examples/benchmark_submission.py``.

1. load a trained checkpoint (either package's: the format is shared);
2. ``predict_and_save(output_format='ids', id_map=TRAINIDS_TO_IDS_ARRAY)``:
   labelId PNGs named so that the scorer's ``<city>_<seq>_<frame>*.png``
   discovery matches;
3. score them against the local ground truth with ``evaluation.pixel_eval``
   (the benchmark server's math), printing per-class IoU / iIoU / category
   IoU and writing the JSON report.

    python -m fcn8s_tensorflow_tpu_torch.examples.benchmark_submission \
        --checkpoint out/ckpts --dataset /data/cityscapes [--split val] \
        [--results out/results] [--device cuda]
"""

import argparse
import os
from glob import glob

from . import add_device_argument, resolve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dataset", required=True, help="Cityscapes root")
    ap.add_argument("--split", default="val")
    ap.add_argument("--results", default="benchmark_results")
    ap.add_argument("--batch-size", type=int, default=8)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve(args.device)

    from ..engine.model import FCN8s
    from ..evaluation import pixel_eval
    from ..labels import TRAINIDS_TO_IDS_ARRAY

    model = FCN8s(model_load_dir=args.checkpoint, device=device)

    img_root = os.path.join(args.dataset, "leftImg8bit", args.split)
    cities = sorted(os.listdir(img_root)) if os.path.isdir(img_root) else []
    if not cities:
        raise SystemExit(f"no cities under {img_root}")
    for city in cities:
        model.predict_and_save(
            results_dir=args.results,
            images_dir=os.path.join(img_root, city),
            output_format="ids",
            id_map=TRAINIDS_TO_IDS_ARRAY,
            batch_size=args.batch_size,
            overwrite_existing=(city == cities[0]),
        )

    os.environ["CITYSCAPES_DATASET"] = args.dataset
    os.environ["CITYSCAPES_RESULTS"] = args.results
    os.makedirs(os.path.join(args.results, "_report"), exist_ok=True)
    os.environ["CITYSCAPES_EXPORT_DIR"] = os.path.join(args.results, "_report")
    eval_args = pixel_eval.default_args()
    # default_args' GT glob is the val split's; honour --split
    eval_args.ground_truth_search = os.path.join(
        args.dataset, "gtFine", args.split, "*", "*_gtFine_labelIds.png")
    ground_truth_list = glob(eval_args.ground_truth_search)
    if not ground_truth_list:
        raise SystemExit(f"no GT found: {eval_args.ground_truth_search}")
    prediction_list = [pixel_eval.get_prediction(eval_args, g) for g in ground_truth_list]
    results = pixel_eval.evaluate_img_lists(prediction_list, ground_truth_list, eval_args)
    print(f"\nmIoU (classes): {results['averageScoreClasses']:.4f}")
    print(f"report JSON: {os.environ['CITYSCAPES_EXPORT_DIR']}")
    model.close()


if __name__ == "__main__":
    main()
