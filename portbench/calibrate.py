"""The readings that the limits of ``checks/<cell>.json`` are set from, for
one cell over many seeds in one process (the runs of the benchmark never
run this):

* ``program``: the number the cell's check compares, from the program as
  the configuration states it;
* ``control``: the same number with the program's place taken by the step
  below the configuration's bf16 (training: the plain reference in fp8;
  prediction and serving: the program's own int8 path, ``quantized=True``);
* training only, the faults planted in the plain reference put in the
  program's place: ``half`` leaves half of each batch out and takes the
  mean over the rest; on more than one chip ``exchange`` leaves out the
  gradients' sum across the cards (rank 0's rows over the whole batch's
  pixels, as rank 0 would step alone). A step that returns its state
  unchanged reads 1 by the change's measure and needs no run.

On more than one chip ``--seeds`` runs the program on the cell's mesh, one
process a card as the cell's runs do (this process is rank 0 and starts
the others), and ``--controls`` runs the controls in this process on one
card.

    python3 -m portbench.calibrate --workload <cell> [--seeds 1,2,3] [--controls 1,2,3]

One JSON line a seed on standard output. Besides the numbers the check
compares it gives ``loss_gap``, the worst of the three steps' loss gaps, and
``logit_gap``, the widest answer gap, which are not compared (``PERF.md``
says why). Prediction reads batch 0 of the cell's cycle through
``FCN8s.predict`` (the window's entry, its batch and frame size); serving
predicts batches of 8 of the pool's scenes, as the service's padded batch
does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import harness, ranks, system, weights
from .drivers import train as train_driver
from .reference import compare, fcn
from .traffic import scenes


def _train_numbers(program: dict, reference: dict) -> dict:
    return dict(train_driver.numbers(program, reference),
                loss_gap=compare.loss_gap(program["losses"], reference["losses"]))


def _train_data(ctx: harness.Context) -> list:
    n, (h, w) = ctx.mix("batch"), ctx.mix("image_hw")
    return [scenes.batch(ctx.seed, scenes.TRAIN_STREAM, k, n, h, w) for k in range(3)]


def _program(ctx: harness.Context, data: list, device, mesh=None) -> dict:
    cfg = ctx.cell.config
    model = system.model(cfg, ctx.seed, device, ctx.width, mesh=mesh)
    program = train_driver.program_readings(model, data, cfg,
                                            train_driver.train_kwargs(cfg, ctx.cell.traffic))
    program["delta"] = train_driver.change_norms(model, cfg, ctx.seed, ctx.width)
    del model
    system.free(device)
    return program


def _train(ctx: harness.Context, control: bool) -> dict:
    cell, cfg, seed, device = ctx.cell, ctx.cell.config, ctx.seed, ctx.device
    n = ctx.mix("batch")
    data = _train_data(ctx)
    ref = train_driver.reference_readings(cfg, seed, data, device, ctx.width)
    out = {}
    if cell.chips == 1:
        out["program"] = _train_numbers(_program(ctx, data, device), ref)
    if control:
        faults = [("control", {"precision": "fp8"}), ("half", {"rows": range(n // 2)})]
        if cell.chips > 1:
            faults.append(("exchange", {"rows": range(n // cell.chips), "denominator": n}))
        for label, kw in faults:
            other = train_driver.reference_readings(cfg, seed, data, device, ctx.width, **kw)
            out[label] = _train_numbers(other, ref)
    out["reference"] = train_driver.printable(ref)
    return out


def mesh_program(ctx: harness.Context, seeds: list, rank: int, init: str) -> None:
    """Rank ``rank`` of the cell's data-parallel mesh: the program's first
    three steps on each seed; rank 0 then runs the reference on one card
    and prints the seed's line."""
    import torch.distributed as dist

    with train_driver.mesh_rank(ctx.cell.chips, rank, init, ctx.device == "cuda") as mesh:
        for seed in seeds:
            t = time.perf_counter()
            c = dataclasses.replace(ctx, seed=seed)
            data = _train_data(c)
            with contextlib.redirect_stdout(sys.stderr):
                program = _program(c, data, mesh.device, mesh)
                if rank == 0:
                    ref = train_driver.reference_readings(c.cell.config, seed, data, mesh.device,
                                                          c.width)
            if rank == 0:
                print(json.dumps({"program": _train_numbers(program, ref), "seed": seed,
                                  "seconds": time.perf_counter() - t}), flush=True)
                system.free(mesh.device)
            dist.barrier()


def _forward(cell, seed: int, control: bool, device, kind: str) -> dict:
    cfg = cell.config
    hw = cell.traffic["image_hw"]
    if kind == "predict":
        images, _ = scenes.batch(seed, scenes.PREDICT_STREAM, 0, cell.traffic["batch"], *hw)
    else:
        batch = cell.traffic["max_batch"]
        images = np.concatenate([scenes.batch(seed, scenes.SERVE_STREAM, k, 1, *hw)[0]
                                 for k in range(batch)])
    model = system.model(cfg, seed, device)
    outputs = {"program": model.predict(images, argmax=True).astype(np.uint8)}
    if control:
        outputs["control"] = model.predict(images, argmax=True, quantized=True).astype(np.uint8)
    del model
    system.free(device)
    tree = weights.make_tree(cfg, seed, device)
    pairs = {label: [] for label in outputs}
    with fcn.exact_fp32():
        for row in range(images.shape[0]):
            ref = fcn.logits(tree, images[row], cfg)
            for label, ids in outputs.items():
                pairs[label].append(compare.logit_gaps(ref, ids[row]))
    out = {}  # logit_gap: the widest gap, read here and not compared
    for label, found in pairs.items():
        out[label] = {"logit_gap": max(w for w, _, _ in found),
                      "mean_gap": sum(s for _, s, _ in found) / sum(n for _, _, n in found),
                      "per_image": [w for w, _, _ in found]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--controls", default="")
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--init", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    harness.cache_dirs()
    cell = harness.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.controls.split(",") if s]
    need = cell.chips if seeds else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench.calibrate: {cell.name} needs {need} CUDA cards", file=sys.stderr)
        return 2
    ctx = harness.Context(cell=cell, seed=0, seconds=0.0, trace=False, t0=time.perf_counter())
    if cell.chips > 1 and seeds:
        init = args.init or ranks.init_method()
        procs = [] if args.rank else [
            subprocess.Popen([sys.executable, "-m", "portbench.calibrate", "--workload",
                              cell.name, "--seeds", args.seeds, "--rank", str(r), "--init", init],
                             cwd=str(harness.root()), stdout=sys.stderr.fileno())
            for r in range(1, cell.chips)]
        try:
            mesh_program(ctx, seeds, args.rank, init)
        finally:
            ranks.join(procs)
        if args.rank:
            return 0
        seeds = []
    kind = cell.traffic["kind"]
    for seed in sorted(set(seeds) | set(controls), key=(seeds + controls).index):
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the program's prints
            if kind == "train":
                out = _train(dataclasses.replace(ctx, seed=seed), seed in controls)
            else:
                out = _forward(cell, seed, seed in controls, "cuda",
                               "predict" if kind == "predict_closed" else "serve")
        out.update(seed=seed, seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        system.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
