"""Convergence check: a full-width FCN learning a synthetic 6-class
segmentation task. Port of ``benchmarks/convergence_synthetic.py``.

A procedurally generated scene (sky band, road band, randomly placed car,
building and person rectangles with class colours and noise:
``tools/synthetic.synth_batch``) that a correct training stack learns to a
high mIoU within a few hundred steps; no dataset needed. Each evaluation's
mIoU, accuracy and loss go into the JSON file ``--out`` names. The run
passes when the last mIoU clears the floor: 0.5 for fcn8s, 0.35 for the
coarser fcn16s and fcn32s (JAX's floors).

    python -m fcn8s_tensorflow_tpu_torch.tools.convergence_synthetic \
        --out convergence.json [--steps 300] [--batch 8] [--variant fcn8s] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .synthetic import NUM_CLASSES, synth_batch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--resolution", type=int, nargs=2, default=[256, 512])
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--variant", default="fcn8s", choices=["fcn8s", "fcn16s", "fcn32s"])
    p.add_argument("--miou-floor", type=float, default=None,
                   help="override the pass threshold (default 0.5 for fcn8s, "
                        "0.35 for the coarser variants)")
    p.add_argument("--out", required=True, help="the results JSON to write")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda raises without a card; pass --device cpu "
                        "to run on the host)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.steps < args.eval_every:
        p.error(f"--steps ({args.steps}) must be >= --eval-every ({args.eval_every})")

    from . import launch_counts, make_deterministic

    make_deterministic()
    import torch

    from ..engine.model import FCN8s
    from ..engine.schedules import constant

    h, w = args.resolution
    rng = np.random.default_rng(0)

    def gen():
        while True:
            yield synth_batch(rng, args.batch, h, w)

    eval_rng = np.random.default_rng(999)
    eval_batches = [synth_batch(eval_rng, args.batch, h, w) for _ in range(4)]

    def eval_gen():
        while True:
            yield from eval_batches

    model = FCN8s(num_classes=NUM_CLASSES, variant=args.variant, device=args.device)
    history = []
    t0 = time.time()
    for _ in range(args.steps // args.eval_every):
        model.train(gen(), epochs=1, steps_per_epoch=args.eval_every,
                    learning_rate_schedule=constant(1e-4), keep_prob=0.5,
                    record_summaries=False)
        values = model.evaluate(eval_gen(), num_batches=4, dataset="val")
        values["step"] = int(model.state.step)
        values["wall_s"] = round(time.time() - t0, 1)
        history.append(values)
        print(f"step {values['step']}: mIoU={values['mean_iou']:.4f} "
              f"acc={values['accuracy']:.4f} loss={values['loss']:.4f}", flush=True)

    device = (torch.cuda.get_device_name(model.device) if model.device.type == "cuda"
              else "cpu")
    model.close()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"config": vars(args), "device": device, "launches": launch_counts(),
                   "history": history}, f, indent=2)
    print("wrote", args.out)
    final = history[-1]
    floor = args.miou_floor if args.miou_floor is not None else (
        0.5 if args.variant == "fcn8s" else 0.35)  # coarser variants segment coarser
    if not final["mean_iou"] > floor:
        print(f"FAIL: convergence regression: final mIoU {final['mean_iou']} <= {floor}")
        return 1
    print(f"PASS: final mIoU {final['mean_iou']:.3f} at step {final['step']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
