"""Self-contained quickstart: no dataset required. Port of
``examples/quickstart_synthetic.py``.

Generates a tiny synthetic Cityscapes-style dataset, trains FCN-8s for a few
steps, evaluates, renders overlays and a viewer gallery: a smoke test of the
whole stack on the card (or, with ``--device cpu``, on the host).

    python -m fcn8s_tensorflow_tpu_torch.examples.quickstart_synthetic \
        [--steps 24] [--out DIR] [--device cuda]
"""

import argparse
import os
import tempfile

import numpy as np
from PIL import Image

from . import add_device_argument, resolve


def make_synthetic_dataset(root: str, n: int = 8, hw=(128, 256)) -> None:
    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "leftImg8bit/train/synth")
    gt_dir = os.path.join(root, "gtFine/train/synth")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    h, w = hw
    for i in range(n):
        lbl = np.zeros((h, w), np.uint8)
        lbl[:, : w // 3] = 7       # road
        lbl[:, w // 3 : 2 * w // 3] = 23  # sky
        lbl[:, 2 * w // 3 :] = 26  # car
        img = np.zeros((h, w, 3), int)
        img[:, : w // 3] = [120, 60, 120]
        img[:, w // 3 : 2 * w // 3] = [70, 130, 180]
        img[:, 2 * w // 3 :] = [10, 10, 140]
        img = np.clip(img + rng.integers(-25, 25, img.shape), 0, 255).astype(np.uint8)
        stem = f"synth_{i:06d}_000019"
        Image.fromarray(img).save(f"{img_dir}/{stem}_leftImg8bit.png")
        Image.fromarray(lbl).save(f"{gt_dir}/{stem}_gtFine_labelIds.png")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--out", default=None)
    p.add_argument("--width-mult", type=float, default=None,
                   help="encoder width multiplier; default 1.0 on the card, 1/8 on the CPU "
                        "(a full-width step takes many seconds there)")
    add_device_argument(p)
    args = p.parse_args(argv)
    device = resolve(args.device)
    out = args.out or tempfile.mkdtemp(prefix="fcn8s_quickstart_")

    from .. import FCN8s
    from ..data import BatchGenerator
    from ..engine.schedules import constant
    from ..labels import IDS_TO_TRAINIDS_ARRAY, NUM_TRAIN_CLASSES, TRAINIDS_TO_RGBA_DICT
    from ..viz.viewer import view_cityscapes_split

    on_cpu = device.type == "cpu"
    width_mult = args.width_mult if args.width_mult is not None else (1 / 8 if on_cpu else 1.0)
    model_kwargs = {} if width_mult == 1.0 else dict(
        width_mult=width_mult, fc_channels=max(32, int(4096 * width_mult ** 2)))

    data_root = os.path.join(out, "data")
    make_synthetic_dataset(data_root)

    gen = BatchGenerator(
        image_dirs=[os.path.join(data_root, "leftImg8bit/train")],
        ground_truth_dirs=[os.path.join(data_root, "gtFine/train")],
        image_name_split_separator="leftImg8bit",
        ground_truth_suffix="gtFine_labelIds",
        num_classes=NUM_TRAIN_CLASSES,
    )
    train_it = gen.generate(
        batch_size=4, convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY,
        convert_to_one_hot=False, flip=0.5, void_class_id=0, seed=1,
    )

    model = FCN8s(num_classes=NUM_TRAIN_CLASSES, device=device, **model_kwargs)
    print(model.summary(input_hw=(64, 128), batch=4))  # where FLOPs and memory go
    model.train(
        train_generator=train_it,
        epochs=2,
        steps_per_epoch=args.steps // 2,
        learning_rate_schedule=constant(1e-4),
        keep_prob=0.5,
        metrics={"loss", "mean_iou", "accuracy"},
        eval_dataset="train",
        eval_frequency=2,
        record_summaries=False,
    )

    pred_dir = os.path.join(out, "predictions")
    model.predict_and_save(
        pred_dir, os.path.join(data_root, "leftImg8bit/train/synth"),
        TRAINIDS_TO_RGBA_DICT, include_unprocessed_image=True,
    )

    index = view_cityscapes_split(data_root, "train", os.path.join(out, "viewer"),
                                  max_images=4, gt_type="gtFine")
    print("quickstart complete.")
    print("  predictions:", pred_dir)
    print("  gallery:    ", index)
    model.close()


if __name__ == "__main__":
    main()
