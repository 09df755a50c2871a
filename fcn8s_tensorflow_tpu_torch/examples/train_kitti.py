"""KITTI road-segmentation (2-class) training. Port of
``examples/train_kitti.py``.

Script equivalent of the reference's KITTI path (its
``batch_generator_KITTI.py``): background vs road, the ground truth encoded
by colour in ``gt_image_2`` (background = [255, 0, 0]).

Usage:
    python -m fcn8s_tensorflow_tpu_torch.examples.train_kitti \
        --dataset /data/kitti_road/training [--epochs 30] [--batch-size 4] \
        [--resolution 320 1152] [--device cuda]
"""

import argparse
import os
from math import ceil

from . import add_device_argument, resolve


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True, help="KITTI road 'training' dir")
    p.add_argument("--vgg16-dir")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--resolution", type=int, nargs=2, default=[320, 1152], metavar=("H", "W"))
    p.add_argument("--out", default="runs/kitti")
    add_device_argument(p)
    args = p.parse_args(argv)
    device = resolve(args.device)

    from .. import FCN8s
    from ..data.kitti import batch_generator
    from ..engine.schedules import constant

    image_dir = os.path.join(args.dataset, "image_2")
    gt_dir = os.path.join(args.dataset, "gt_image_2")
    n_images = len([f for f in os.listdir(image_dir) if f.endswith(".png")])

    train_it = batch_generator(
        args.batch_size, image_dir, gt_dir,
        resize=tuple(args.resolution), flip=0.5, seed=0, one_hot=False,
    )

    model = FCN8s(num_classes=2, vgg16_dir=args.vgg16_dir, device=device)
    model.train(
        train_generator=train_it,
        epochs=args.epochs,
        steps_per_epoch=ceil(n_images / args.batch_size),
        learning_rate_schedule=constant(1e-4),
        keep_prob=0.5,
        metrics={"loss", "mean_iou", "accuracy"},
        eval_dataset="train",
        eval_frequency=5,
        save_during_training=True,
        save_dir=os.path.join(args.out, "checkpoints"),
        monitor="loss",
        record_summaries=True,
        summaries_dir=os.path.join(args.out, "tensorboard"),
    )

    road_rgba = {0: (0, 0, 0, 0), 1: (0, 255, 0, 127)}
    model.predict_and_save(
        results_dir=os.path.join(args.out, "predictions"),
        images_dir=image_dir,
        color_map=road_rgba,
        resize=tuple(args.resolution),
        include_unprocessed_image=True,
    )
    model.close()


if __name__ == "__main__":
    main()
