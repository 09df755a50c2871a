"""End-to-end Cityscapes training walkthrough. Port of
``examples/train_cityscapes.py``.

Script equivalent of the reference's ``fcn8s_tutorial.ipynb``, with the
canonical hyperparameters from its cells: batch 4, keep_prob 0.5, L2 0.0,
h-flip 0.5, step LR schedule 1e-4 -> 1e-5 -> 3e-6 -> 1e-6 at 10k/20k/40k
steps, eval every 2 epochs, save-best-only on loss.

Usage:
    python -m fcn8s_tensorflow_tpu_torch.examples.train_cityscapes \
        --dataset /data/cityscapes [--vgg16-dir /ckpt/vgg16] [--epochs 60] \
        [--batch-size 4] [--resolution 256 512] [--device-augment] [--device cuda]

A mesh: launch under ``torchrun --nproc-per-node=N``; every rank makes the
same calls on the same global batch (``parallel/mesh.py``), rank 0 writes
the files. ``--tensor-parallel`` puts fc6/fc7 on a 'model' axis of 2, the
rest of the ranks on 'data'. ``--shard INDEX COUNT`` gives each rank its
disjoint slice of every epoch, as the JAX script does; the port's facade
then trains each rank on its rows of its own slice's batch.

Expects the standard layout (after offline preprocessing or with
``--resolution`` doing the resize online):
    <dataset>/leftImg8bit/{train,val}/<city>/*_leftImg8bit.png
    <dataset>/gtFine/{train,val}/<city>/*_gtFine_labelIds.png
"""

import argparse
import os
from math import ceil

from . import add_device_argument, resolve


def _mesh(device, tensor_parallel: bool):
    """The mesh of a ``torchrun`` launch (None outside one): the process
    group over ``WORLD_SIZE`` ranks, NCCL on the card and gloo on the CPU;
    'model' = 2 with ``tensor_parallel``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return None
    import torch.distributed as dist

    from ..parallel.mesh import create_mesh

    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return create_mesh(model=2 if tensor_parallel else 1,
                       devices=None if device.type == "cuda" else [device] * world)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True)
    p.add_argument("--vgg16-dir",
                   help="pretrained encoder checkpoint (python -m "
                        "fcn8s_tensorflow_tpu_torch.models.import_vgg16)")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--resolution", type=int, nargs=2, default=None, metavar=("H", "W"))
    p.add_argument("--out", default="runs/cityscapes")
    p.add_argument("--device-augment", action="store_true",
                   help="run flip/brightness on-device inside the train step")
    p.add_argument("--tensor-parallel", action="store_true",
                   help="under torchrun: fc6/fc7 sharded over a 'model' axis of 2")
    p.add_argument("--variant", default="fcn8s",
                   choices=["fcn8s", "fcn16s", "fcn32s"],
                   help="FCN family member (the reference ships only fcn8s)")
    p.add_argument("--gradient-accumulation", type=int, default=1,
                   help="microbatches per optimizer step (exact; for "
                        "batch-16 at full resolution on one card)")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint the encoder blocks (activation memory "
                        "for FLOPs: full-resolution training)")
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "adamw", "momentum", "sgd"],
                   help="adam = the reference's TF1-exact Adam")
    p.add_argument("--clip-norm", type=float, default=None,
                   help="global-norm gradient clipping")
    p.add_argument("--early-stopping", type=int, default=None, metavar="PATIENCE",
                   help="stop after PATIENCE observations without "
                        "improvement of the monitored loss")
    p.add_argument("--reduce-lr-on-plateau", type=int, default=None,
                   metavar="PATIENCE",
                   help="scale the LR x0.1 whenever the monitored loss "
                        "stalls PATIENCE observations")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="maintain an EMA of the weights; the script adopts "
                        "them after training, so the final eval/predictions "
                        "report the averaged model")
    p.add_argument("--shard", type=int, nargs=2, default=None,
                   metavar=("INDEX", "COUNT"),
                   help="multi-process input sharding: this rank's disjoint "
                        "slice of every epoch (pair with torchrun)")
    add_device_argument(p)
    args = p.parse_args(argv)
    device = resolve(args.device)

    from .. import FCN8s
    from ..data import BatchGenerator
    from ..engine.schedules import reference_tutorial_schedule
    from ..labels import IDS_TO_TRAINIDS_ARRAY, NUM_TRAIN_CLASSES, TRAINIDS_TO_RGBA_DICT
    from ..viz.overlay import create_video_from_images

    train_gen = BatchGenerator(
        image_dirs=[os.path.join(args.dataset, "leftImg8bit/train")],
        ground_truth_dirs=[os.path.join(args.dataset, "gtFine/train")],
        image_name_split_separator="leftImg8bit",
        ground_truth_suffix="gtFine_labelIds",
        num_classes=NUM_TRAIN_CLASSES,
    )
    val_gen = BatchGenerator(
        image_dirs=[os.path.join(args.dataset, "leftImg8bit/val")],
        ground_truth_dirs=[os.path.join(args.dataset, "gtFine/val")],
        image_name_split_separator="leftImg8bit",
        ground_truth_suffix="gtFine_labelIds",
        num_classes=NUM_TRAIN_CLASSES,
    )
    print(f"train: {train_gen.get_num_files()} images, val: {val_gen.get_num_files()}")

    # host pipeline: trainId remap + optional resize; ID maps (the one-hot
    # expansion happens on the card); flip on the host unless --device-augment
    common = dict(
        convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY,
        convert_to_one_hot=False,
        void_class_id=0,
        resize=tuple(args.resolution) if args.resolution else False,
    )
    train_it = train_gen.generate(
        batch_size=args.batch_size,
        flip=False if args.device_augment else 0.5,
        seed=0,
        shard=tuple(args.shard) if args.shard else None,
        **common,
    )
    val_it = val_gen.generate(batch_size=args.batch_size, shuffle=False, seed=0, **common)

    # sharded input: each rank sees ceil(n / count) images an epoch, so an
    # epoch of steps shrinks to match; only rank 0 owns the output tree
    n_train = train_gen.get_num_files()
    if args.shard:
        n_train = ceil(n_train / args.shard[1])
    mesh = _mesh(device, args.tensor_parallel)
    is_main = mesh is None or mesh.is_writer

    model = FCN8s(
        num_classes=NUM_TRAIN_CLASSES,
        vgg16_dir=args.vgg16_dir,
        mesh=mesh,
        tensor_parallel=args.tensor_parallel,
        variant=args.variant,
        remat=args.remat,
        optimizer=args.optimizer,
        clip_norm=args.clip_norm,
        device=device,
    )

    steps_per_epoch = ceil(n_train / args.batch_size)
    model.train(
        train_generator=train_it,
        epochs=args.epochs,
        steps_per_epoch=steps_per_epoch,
        learning_rate_schedule=reference_tutorial_schedule(),
        keep_prob=0.5,
        l2_regularization=0.0,
        eval_dataset="val",
        eval_frequency=2,
        val_generator=val_it,
        val_steps=ceil(val_gen.get_num_files() / args.batch_size),
        metrics={"loss", "mean_iou", "accuracy"},
        save_during_training=True,
        save_dir=os.path.join(args.out, "checkpoints"),
        save_best_only=True,
        monitor="loss",
        save_frequency=2,
        record_summaries=True,
        summaries_frequency=10,
        summaries_dir=os.path.join(args.out, "tensorboard"),
        summaries_name=args.variant,
        device_augment={"flip": 0.5, "brightness": (0.8, 1.2, 0.5),
                        "translate": ((0, 16), (0, 8), 0.5),
                        "scale": (0.8, 1.2, 0.5)} if args.device_augment else None,
        gradient_accumulation=args.gradient_accumulation,
        early_stopping=args.early_stopping,
        reduce_lr_on_plateau=args.reduce_lr_on_plateau,
        ema_decay=args.ema_decay,
        train_log=os.path.join(args.out, "train_log.jsonl"),
    )
    if args.ema_decay:
        # the averaged weights become the served ones: the final eval, the
        # prediction PNGs and the video below report the EMA model
        model.adopt_ema()

    # final evaluation + qualitative results (tutorial cells 19-26)
    model.evaluate(val_it, ceil(val_gen.get_num_files() / args.batch_size), dataset="val")
    sample_city = sorted(os.listdir(os.path.join(args.dataset, "leftImg8bit/val")))[0]
    model.predict_and_save(
        results_dir=os.path.join(args.out, "predictions"),
        images_dir=os.path.join(args.dataset, "leftImg8bit/val", sample_city),
        color_map=TRAINIDS_TO_RGBA_DICT,
        include_unprocessed_image=True,
        arrangement="vertical",
    )
    if is_main:
        video = create_video_from_images(
            os.path.join(args.out, "predictions_video"),
            os.path.join(args.out, "predictions"),
            frame_rate=15,
        )
        print("video:", video)
    model.close()


if __name__ == "__main__":
    main()
