"""Offline dataset preprocessing. Port of ``examples/offline_preprocessing.py``.

Script equivalent of the reference's ``offline_preprocessing_tutorial.ipynb``:
materialize a downscaled, trainId-remapped copy of Cityscapes on disk
(1024x2048 -> 256x512 by default), mirroring the source directory tree.
Host work only; ``--device`` is checked like every example's.

Usage:
    python -m fcn8s_tensorflow_tpu_torch.examples.offline_preprocessing \
        --dataset /data/cityscapes --export /data/cityscapes_256x512 \
        [--resolution 256 512] [--splits train val] [--device cuda]

``--packed`` writes the decode-once packed format (flat memmap arrays,
``data/packed.py``) instead of a PNG mirror: ``PackedDataset.generate``
reproduces ``BatchGenerator``'s augmentation stream byte for byte for a
given seed, with no decode cost. Train from it with::

    ds = PackedDataset(os.path.join(export, split), num_classes=20)
    model.train(ds.generate(4, convert_to_one_hot=False, flip=0.5, seed=0), ...)
"""

import argparse
import os

from . import add_device_argument, resolve


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True)
    p.add_argument("--export", required=True)
    p.add_argument("--resolution", type=int, nargs=2, default=[256, 512], metavar=("H", "W"))
    p.add_argument("--splits", nargs="+", default=["train", "val"])
    p.add_argument("--keep-ids", action="store_true",
                   help="skip the IDs->trainIds remap (keep original label ids)")
    p.add_argument("--packed", action="store_true",
                   help="write the decode-once packed memmap format "
                        "(data/packed.py) instead of a PNG mirror")
    add_device_argument(p)
    args = p.parse_args(argv)
    resolve(args.device)

    from ..data import BatchGenerator, pack_dataset
    from ..labels import IDS_TO_TRAINIDS_ARRAY, NUM_TRAIN_CLASSES

    for split in args.splits:
        print(f"== processing split '{split}' ==")
        gen = BatchGenerator(
            image_dirs=[os.path.join(args.dataset, "leftImg8bit", split)],
            ground_truth_dirs=[os.path.join(args.dataset, "gtFine", split)],
            image_name_split_separator="leftImg8bit",
            ground_truth_suffix="gtFine_labelIds",
            num_classes=NUM_TRAIN_CLASSES,
            root_dir=args.dataset,
            export_dir=None if args.packed else args.export,
        )
        remap = False if args.keep_ids else IDS_TO_TRAINIDS_ARRAY
        if args.packed:
            pack_dataset(gen, os.path.join(args.export, split),
                         convert_ids_to_ids=remap,
                         resize=tuple(args.resolution))
        else:
            gen.process_all(
                convert_ids_to_ids=remap,
                resize=tuple(args.resolution),
            )
    print("done:", args.export)


if __name__ == "__main__":
    main()
