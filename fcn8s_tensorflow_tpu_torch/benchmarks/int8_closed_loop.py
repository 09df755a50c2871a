"""int8 serving accuracy in the closed loop: train -> score bf16 vs int8.
Port of ``benchmarks/int8_closed_loop.py``.

One trained model runs through the full submission pipeline
(``FCN8s.score_benchmark``: predict every val image -> labelId PNGs ->
the offline pixel scorer) twice: on the bf16 path and with
``quantized=True`` after ``calibrate_quantization`` (the calibrated static
scales serving uses). What is measured is the int8-vs-bf16 mIoU delta on
one model.

Dataset: synthetic Cityscapes-layout scenes in labelId space
(``synth_labelid_scene``, byte-equal to the JAX script's), written as a
``leftImg8bit``/``gtFine`` val split.

Two model sources:

* default: train ``--steps`` steps fresh (20 classes);
* ``--checkpoint DIR``: a 6-class endurance checkpoint written by either
  package, scored on the endurance workload's own eval distribution
  (``tools.synthetic.synth_hard_batch``), mapped into labelId space by
  ``ENDURANCE_LABELID_LUT`` through ``score_benchmark``'s ``id_map``.

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.int8_closed_loop --out FILE \
        [--checkpoint DIR] [--device cuda]

Prints one JSON line on stdout; writes the full report to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from ..examples import add_device_argument, resolve
from . import MODEL, log

# labelId-space scene classes (colour-coded -> learnable from pixels alone)
CLASS_COLORS = {
    7: (128, 64, 128),    # road
    8: (244, 35, 232),    # sidewalk
    11: (70, 70, 70),     # building
    21: (107, 142, 35),   # vegetation
    23: (70, 130, 180),   # sky
    26: (0, 0, 142),      # car
}

# the endurance workload's 6-class space -> Cityscapes labelIds
ENDURANCE_LABELID_LUT = np.array([0, 7, 23, 26, 11, 24], np.uint8)


def synth_labelid_scene(rng, h, w):
    gt = np.zeros((h, w), np.uint8)
    horizon = rng.integers(h // 4, h // 2)
    gt[:horizon] = 23
    gt[horizon:] = 7
    gt[horizon:, : w // 6] = 8
    for cid in (11, 21, 26):
        for _ in range(rng.integers(1, 4)):
            bh = rng.integers(h // 8, h // 3)
            bw = rng.integers(w // 10, w // 4)
            y0 = rng.integers(0, h - bh)
            x0 = rng.integers(0, w - bw)
            gt[y0:y0 + bh, x0:x0 + bw] = cid
    gt[: h // 16] = 0  # a void strip (unlabeled) for the FP-ignore rule
    img = np.zeros((h, w, 3), np.uint8)
    for cid, col in CLASS_COLORS.items():
        img[gt == cid] = col
    img = np.clip(img.astype(np.int16) + rng.integers(-25, 25, img.shape),
                  0, 255).astype(np.uint8)
    return img, gt


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--resolution", type=int, nargs=2, default=[256, 512])
    p.add_argument("--val-images", type=int, default=16)
    p.add_argument("--checkpoint", default=None,
                   help="score this endurance checkpoint (6-class) instead of training a "
                        "fresh 20-class model")
    p.add_argument("--out", required=True, help="the report's JSON file")
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve(args.device)

    from PIL import Image

    from ..engine.model import FCN8s
    from ..engine.schedules import constant
    from ..labels import IDS_TO_TRAINIDS_ARRAY, NUM_TRAIN_CLASSES
    from ..tools.synthetic import synth_hard_batch

    h, w = args.resolution
    rng = np.random.default_rng(0)

    # --- benchmark-layout val split on disk + the model to score ---
    ds = tempfile.mkdtemp(prefix="int8_cl_ds_")
    img_dir = os.path.join(ds, "leftImg8bit", "val", "synth")
    gt_dir = os.path.join(ds, "gtFine", "val", "synth")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    val_rng = np.random.default_rng(999)
    id_map = None

    def write_val_pair(i, img, gt_labelids):
        name = f"synth_000000_{i:06d}"
        Image.fromarray(img).save(os.path.join(img_dir, f"{name}_leftImg8bit.png"))
        Image.fromarray(gt_labelids).save(os.path.join(gt_dir, f"{name}_gtFine_labelIds.png"))
        Image.fromarray(gt_labelids.astype(np.uint16)).save(
            os.path.join(gt_dir, f"{name}_gtFine_instanceIds.png"))

    try:
        if args.checkpoint:
            model = FCN8s(model_load_dir=args.checkpoint, device=dev)
            if model.num_classes != len(ENDURANCE_LABELID_LUT):
                raise ValueError(
                    f"--checkpoint expects the {len(ENDURANCE_LABELID_LUT)}-class endurance "
                    f"model, got num_classes={model.num_classes}")
            imgs_v, gts_v = synth_hard_batch(val_rng, args.val_images, h, w)
            for i in range(args.val_images):
                write_val_pair(i, imgs_v[i], ENDURANCE_LABELID_LUT[gts_v[i]])
            id_map = ENDURANCE_LABELID_LUT
            calib_imgs = synth_hard_batch(rng, args.batch * 2, h, w)[0]
            trained_desc = f"endurance checkpoint {os.path.basename(args.checkpoint)}"
        else:
            for i in range(args.val_images):
                write_val_pair(i, *synth_labelid_scene(val_rng, h, w))

            # --- train (trainId space) ---
            def gen():
                while True:
                    imgs, gts = zip(*(synth_labelid_scene(rng, h, w) for _ in range(args.batch)))
                    yield np.stack(imgs), IDS_TO_TRAINIDS_ARRAY[np.stack(gts)].astype(np.uint8)

            model = FCN8s(num_classes=NUM_TRAIN_CLASSES, device=dev, **MODEL)
            t0 = time.time()
            model.train(gen(), epochs=1, steps_per_epoch=args.steps,
                        learning_rate_schedule=constant(1e-4), keep_prob=0.5,
                        record_summaries=False)
            log(f"trained {args.steps} steps in {time.time() - t0:.0f}s, "
                f"loss {float(model.training_loss):.4f}")
            calib_imgs = np.stack([synth_labelid_scene(rng, h, w)[0]
                                   for _ in range(args.batch * 2)])
            trained_desc = f"fresh {args.steps}-step model"

        # --- the calibrated static scales, as serving uses them ---
        model.calibrate_quantization(calib_imgs, batch_size=args.batch)
        log(f"calibrated int8 activation scales on {len(calib_imgs)} images ({trained_desc})")

        # --- score the SAME model through the full benchmark pipeline twice ---
        results = {}
        for tag, quantized in (("bf16", False), ("int8", True)):
            r = model.score_benchmark(ds, os.path.join(ds, f"results_{tag}"),
                                      quantized=quantized, batch_size=args.batch,
                                      id_map=id_map, instance_level=False)
            results[tag] = {
                "miou": float(r["averageScoreClasses"]),
                "classScores": {k: float(v) for k, v in r["classScores"].items()
                                if not np.isnan(v)},
            }
            log(f"{tag}: mIoU {results[tag]['miou']:.4f}")
        model.close()
    finally:
        shutil.rmtree(ds, ignore_errors=True)

    delta = results["bf16"]["miou"] - results["int8"]["miou"]
    out = {
        "metric": "int8_closed_loop_miou_delta",
        "unit": "mIoU",
        "config": {k: v for k, v in vars(args).items() if k != "device"} | {
            "classes": (sorted(int(x) for x in ENDURANCE_LABELID_LUT[1:])
                        if args.checkpoint else sorted(CLASS_COLORS)),
            "model": trained_desc,
            "calibration_images": int(len(calib_imgs))},
        "bf16_miou": round(results["bf16"]["miou"], 4),
        "int8_miou": round(results["int8"]["miou"], 4),
        "delta": round(delta, 4),
        "bf16_class_scores": results["bf16"]["classScores"],
        "int8_class_scores": results["int8"]["classScores"],
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    line = {k: out[k] for k in ("metric", "bf16_miou", "int8_miou", "delta")}
    print(json.dumps(line))
    return out


if __name__ == "__main__":
    main()
