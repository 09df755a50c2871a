"""Serve an interactive browser viewer over a Cityscapes-style tree. Port of
``examples/serve_results.py``.

Replaces the reference's desktop GUI (``cityscapesViewer.py``) for headless
machines: build per-image overlay layers once, then browse them from any
machine over SSH port forwarding. Host work only; ``--device`` is checked
like every example's.

    python -m fcn8s_tensorflow_tpu_torch.examples.serve_results --root /data/cityscapes \
        [--results out/] [--split val] [--max-images 50] [--port 8008] [--device cuda]

then ``ssh -L 8008:localhost:8008 <host>`` and open
http://localhost:8008/viewer.html: arrow keys navigate, 'g'/'p' toggle the
GT/prediction overlays, the slider sets the overlay alpha, the wheel zooms.
"""

import argparse
import os
import tempfile
from glob import glob

import numpy as np
from PIL import Image

from . import add_device_argument, resolve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="Cityscapes root (leftImg8bit/...)")
    ap.add_argument("--results", default=None, help="predicted id-map PNG dir")
    ap.add_argument("--split", default="val")
    ap.add_argument("--gt-type", default="gtFine")
    ap.add_argument("--max-images", type=int, default=50)
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--out", default=None, help="layer output dir (default: temp)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    resolve(args.device)

    from ..labels import IDS_TO_TRAINIDS_ARRAY
    from ..viz import serve

    image_paths = sorted(glob(os.path.join(
        args.root, "leftImg8bit", args.split, "*", "*_leftImg8bit.png")))
    if not image_paths:
        raise SystemExit(f"no images under {args.root}/leftImg8bit/{args.split}")

    def gt_loader(path):
        base = path.replace("leftImg8bit", args.gt_type, 1).replace("_leftImg8bit.png", "")
        for suffix, remap in ((f"_{args.gt_type}_labelTrainIds.png", False),
                              (f"_{args.gt_type}_labelIds.png", True)):
            p = base + suffix
            if os.path.isfile(p):
                ids = np.asarray(Image.open(p))
                return IDS_TO_TRAINIDS_ARRAY[ids] if remap else ids
        return None

    pred_loader = None
    if args.results:
        from ..viz.viewer import load_prediction

        def pred_loader(path):
            return load_prediction(path, args.results)

    out_dir = args.out or tempfile.mkdtemp(prefix="fcn8s_viewer_")
    serve.build_interactive_viewer(
        out_dir, image_paths, gt_loader, pred_loader,
        max_images=args.max_images,
        title=f"Cityscapes {args.split}",
    )
    serve.serve_viewer(out_dir, port=args.port)


if __name__ == "__main__":
    main()
