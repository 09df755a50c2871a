"""SegFormer's training cell: the facade's ``FCN8s.train`` on resident host
batches, with a SegFormer tree in ``FCN8s.from_params``.

As ``drivers/train.py`` drives FCN-8s (its ``feed`` is reused): set-up
makes the cycle of seeded batches and the model on the seed's weights
(``segformer_weights.py``), drives it through its first three steps with
the window's own call and feed, one ``train`` call a step, and reads what
the check compares: the first step's loss, the first gradient as AdamW got
it (its first moment after one step over ``1 - b1``: each leaf's norm, and
the decoder's kernels whole), each leaf's change after the three steps, and
BatchNorm's running statistics after them. Those steps also capture and
warm the compiled train step. The window calls ``train`` in epochs of
``steps_per_call`` steps until ``--seconds`` have passed;
``train_images_per_s`` is every image of every step over the window. The
attention calls the program counted in the window
(``ops.nn.attention.calls``) go to the readers. After the window
the program is dropped and the plain reference (``reference/segformer.py``)
runs the same three steps in fp32 from the same weights, batches and
dropout draws, each batch whole (BatchNorm couples its rows), each block
recomputed in the backward so that it fits.

A program without SegFormer fails at once: this module imports the port's
``ops.nn.attention`` when it is loaded.

    python3 -m portbench.drivers.train_segformer --calibrate --seeds 1,2 [--controls 1]

prints the readings the limits are set from, one JSON line a seed: the
program's numbers, and with ``--controls`` those of the plain reference in
fp8, on half of each batch and with BatchNorm left in eval mode in the
program's place.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch
from fcn8s_tensorflow_tpu_torch import bridge
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
from fcn8s_tensorflow_tpu_torch.ops.nn import attention

from .. import harness, segformer_weights, system, tracing
from ..metrics.arith import segformer as arith
from ..reference import compare
from ..reference import segformer as ref
from ..traffic import scenes
from .train import feed

CHECKS = ("loss1_gap", "grad1_gap", "grad1_vec_gap", "delta3_gap", "var3_gap", "mean3_gap")


def optimizer_kwargs(cfg: dict) -> dict:
    opt = cfg["optimizer"]
    return {k: opt[k] for k in ("b1", "b2", "eps", "weight_decay", "custom_keys")}


def train_kwargs(cfg: dict, traffic: dict) -> dict:
    lr = cfg["optimizer"]["learning_rate"]
    return dict(learning_rate_schedule=lambda step: lr, keep_prob=cfg["keep_prob"],
                l2_regularization=0.0, record_summaries=False, prefetch=traffic["prefetch"])


def build(cfg: dict, seed: int, device) -> FCN8s:
    """``FCN8s.from_params`` on the seed's SegFormer tree, which seeds the
    dropout draws too; the benchmark's tree is dropped after."""
    rates = (cfg["encoder"]["drop_path_rate"], cfg["decoder"]["dropout_ratio"])
    if any(abs(1.0 - cfg["keep_prob"] - r) > 1e-12 for r in rates):
        raise ValueError(f"keep_prob {cfg['keep_prob']} does not give the rates {rates}")
    tree = segformer_weights.make_tree(cfg, seed, device)
    model = FCN8s.from_params(tree, compute_dtype=getattr(torch, cfg["compute_dtype"]),
                              device=device, seed=seed, optimizer=cfg["optimizer"]["name"],
                              optimizer_kwargs=optimizer_kwargs(cfg))
    del tree
    return model


def _head(paths: list) -> list:
    return [p for p in paths if p.startswith("decoder/") and p.endswith("/kernel")]


def program_readings(model, data: list, cfg: dict, kwargs: dict, seed: int,
                     steps: int = 3) -> dict:
    """A fresh model's first ``steps`` steps, one ``train`` call each on
    batches 0, 1, 2 of the cycle, and what the check compares, by the
    leaves' JAX paths."""
    b1 = cfg["optimizer"]["b1"]
    paths = bridge.jax_leaf_paths(model.params)
    out = {"paths": paths, "losses": []}
    for k in range(steps):
        model.train(feed(data, k), epochs=1, steps_per_epoch=1, **kwargs)
        out["losses"].append(float(model.training_loss))
        if k == 0:
            grads = {p: (mu / (1.0 - b1)).detach()
                     for p, mu in zip(paths, model.state.opt_state.inner.mu)}
            out["grad1"] = [float(grads[p].norm()) for p in paths]
            out["grad1_head"] = [bridge.leaf_to_jax(grads[p], p).float().cpu().numpy()
                                 for p in _head(paths)]
            del grads
    start = segformer_weights.make_tree(cfg, seed, model.device)
    out["delta"] = []
    for t, path in zip(bridge.param_leaves(model.params), paths):
        part, name, key = path.split("/")
        out["delta"].append(float((bridge.leaf_to_jax(t.detach(), path)
                                   - start[part][name][key]).norm()))
    del start
    out["stats"] = {k: t.detach().cpu().numpy().copy()  # the window moves the live ones
                    for k, t in model.params["batch_stats"]["linear_fuse_bn"].items()}
    return out


def reference_readings(cfg: dict, seed: int, data: list, device, steps: int = 3,
                       **kwargs) -> dict:
    """The plain reference's readings of the same steps (``kwargs``:
    ``ref.train``'s ``precision``, ``bn``)."""
    tree = segformer_weights.make_tree(cfg, seed, device)
    with ref.exact_fp32():
        out = ref.train(tree, data[:steps], cfg, seed, steps, **kwargs)
    del tree
    return out


def numbers(program: dict, reference: dict) -> dict:
    """The numbers the check compares: the first step's relative loss gap;
    the worst moving leaf's gap of the first gradient's norm; the worst
    decoder kernel's distance of the first gradient as a vector; the worst
    moving leaf's gap of the change's norm after three steps (a leaf moves
    where its reference gradient is at least a thousandth of the median
    leaf's: BatchNorm and the softmax leave the biases before them without
    a gradient, and Adam turns their round-off into full steps); and the
    distances of the running variance's and mean's changes after three
    steps, each as a vector."""
    if program["paths"] != reference["paths"]:
        return {name: float("inf") for name in CHECKS}
    keep = compare.moving_leaves(reference["grad1"])
    var = [program["stats"]["var"] - 1.0], [reference["stats"]["var"] - 1.0]
    return {"loss1_gap": compare.loss_gap(program["losses"][:1], reference["losses"][:1]),
            "grad1_gap": compare.norm_gap(program["grad1"], reference["grad1"], keep),
            "grad1_vec_gap": compare.vector_gap(program["grad1_head"], reference["grad1_head"]),
            "delta3_gap": compare.norm_gap(program["delta"], reference["delta"], keep),
            "var3_gap": compare.vector_gap(*var),
            "mean3_gap": compare.vector_gap([program["stats"]["mean"]],
                                            [reference["stats"]["mean"]])}


def printable(readings: dict) -> dict:
    """Readings without the tensors copied to the host and the paths."""
    out = {k: v for k, v in readings.items() if k not in ("grad1_head", "paths", "stats")}
    if "stats" in readings:
        out["var_change_norm"] = float(np.linalg.norm(readings["stats"]["var"] - 1.0))
    return out


def make_data(ctx) -> list:
    n, (h, w) = ctx.mix("batch"), ctx.mix("image_hw")
    return scenes.batches(ctx.seed, scenes.TRAIN_STREAM, ctx.mix("cycle"), n, h, w)


def _calls(before, after) -> list:
    return [[*shape, count] for shape, count in sorted((after - before).items())]


def run(ctx: harness.Context) -> harness.Result:
    if ctx.cell.chips != 1:
        raise SystemExit(f"{ctx.cell.name}: SegFormer's cell runs on one card")
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    device = ctx.device
    data = make_data(ctx)
    n, hw = ctx.mix("batch"), ctx.mix("image_hw")
    system.reset_peak(device)
    model = build(cfg, ctx.seed, device)
    kwargs = train_kwargs(cfg, traffic)
    program = program_readings(model, data, cfg, kwargs, ctx.seed)
    system.sync(device)

    per_call, index, steps = ctx.mix("steps_per_call"), 3, 0
    counter = attention.calls
    calls_s = []  # each train call's seconds, synchronised: a slow call shows apart
    with tracing.traced(ctx.trace) as trace:
        before = counter.copy()
        start = time.perf_counter()
        with tracing.window():
            while True:
                t_call = time.perf_counter()
                model.train(feed(data, index), epochs=1, steps_per_epoch=per_call, **kwargs)
                system.sync(device)
                calls_s.append(time.perf_counter() - t_call)
                steps += per_call
                index += per_call
                if time.perf_counter() - start >= ctx.seconds:
                    break
        end = time.perf_counter()
        calls = _calls(before, counter)
    summarized = time.perf_counter()
    peak = system.peak_bytes(device)
    del model
    system.free(device)

    reference = reference_readings(cfg, ctx.seed, data, device)
    timings = {"summary_s": summarized - end, "reference_s": time.perf_counter() - summarized,
               "calls_s": calls_s}
    images = steps * n
    return harness.Result(
        setup_s=start - ctx.t0, attempted=steps, failed=0,
        end_to_end={"train_images_per_s": images / (end - start), "setup_s": start - ctx.t0},
        counters={"images": images, "steps": steps, "batch": n, "image_hw": list(hw),
                  "chips": 1, "flops": images * arith.train_flops_per_image(cfg, hw),
                  "attention_calls": calls, "config": cfg, "kind": "train"},
        checks=harness.checks(numbers(program, reference), ctx.cell.limits),
        memory_peak_bytes=peak, device_count=1,
        trace=trace.summary if ctx.trace else None,
        notes={"program": printable(program), "reference": printable(reference), **timings})


def calibrate(cell, seed: int, control: bool, device="cuda") -> dict:
    """One seed's readings: the program's numbers, and with ``control``
    those of the fp8 reference, of half of each batch left out (its first
    n/2 rows alone, BatchNorm's statistics theirs) and of BatchNorm in eval
    mode."""
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                          t0=time.perf_counter(), device=device)
    cfg = cell.config
    data = [scenes.batch(seed, scenes.TRAIN_STREAM, k, ctx.mix("batch"), *ctx.mix("image_hw"))
            for k in range(3)]
    model = build(cfg, seed, device)
    program = program_readings(model, data, cfg, train_kwargs(cfg, cell.traffic), seed)
    del model
    system.free(device)
    want = reference_readings(cfg, seed, data, device)
    out = {"program": numbers(program, want), "reference": printable(want)}
    if control:
        n = ctx.mix("batch")
        for label, kw in (("control", {"precision": "fp8"}),
                          ("half", {"batch_rows": range(n // 2)}), ("bn_eval", {"bn": "eval"})):
            out[label] = numbers(reference_readings(cfg, seed, data, device, **kw), want)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench.drivers.train_segformer")
    parser.add_argument("--calibrate", action="store_true", required=True)
    parser.add_argument("--workload", default="segformer-b5.train.b2")
    parser.add_argument("--seeds", default="")
    parser.add_argument("--controls", default="")
    args = parser.parse_args(argv)
    harness.cache_dirs()
    cell = harness.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.controls.split(",") if s]
    for seed in sorted(set(seeds) | set(controls), key=(seeds + controls).index):
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = calibrate(cell, seed, seed in controls)
        out.update(seed=seed, seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        system.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
