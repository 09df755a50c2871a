"""Training cells: the facade's ``FCN8s.train`` on resident host batches.

Set-up makes a cycle of seeded batches (``traffic/scenes.py``) and the
model on the seed's weights, then drives it through its first three steps
with the window's own call and feed, one ``train`` call a step, reading
what the check compares: each step's loss, the first gradient as the
optimizer got it (Adam's first moment after one step over ``1 - b1``: each
leaf's norm, and the decoder's kernels whole, copied to the host), and
each leaf's change after the three steps. Those steps also capture and warm
the compiled train step. The window then calls ``train`` in epochs of
``steps_per_call`` steps, each from where the last left off in the cycle,
until ``--seconds`` have passed; ``train_images_per_s`` is every image of
every step over the window, from the first call's start to the last call's
end, synchronised. After the window the program is dropped and the plain
reference runs the same three steps in fp32 from the same weights, batches
and dropout draws.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .. import harness, ranks, system, tracing, weights
from ..metrics.arith import flops
from ..reference import compare, fcn
from ..traffic import scenes


def feed(data: list, start: int):
    """The cycle of resident batches from batch ``start`` on, forever."""
    k = start
    while True:
        yield data[k % len(data)]
        k += 1


def train_kwargs(cfg: dict, traffic: dict) -> dict:
    lr = cfg["optimizer"]["learning_rate"]
    return dict(learning_rate_schedule=lambda step: lr, keep_prob=cfg["keep_prob"],
                l2_regularization=cfg["l2_regularization"], record_summaries=False,
                prefetch=traffic["prefetch"])


def program_readings(model, data: list, cfg: dict, kwargs: dict, steps: int = 3) -> dict:
    """Drive a fresh model through its first ``steps`` steps, one ``train``
    call each on batches 0, 1, 2 of the cycle, and read what the check
    compares."""
    b1 = cfg["optimizer"]["b1"]
    out = {"losses": []}
    for k in range(steps):
        model.train(feed(data, k), epochs=1, steps_per_epoch=1, **kwargs)
        out["losses"].append(float(model.training_loss))
        if k == 0:
            mus = model.state.opt_state.inner.mu
            out["grad1"] = [float((mu / (1.0 - b1)).norm()) for mu in mus]
            out["grad1_decoder"] = [g / (1.0 - b1) for g in decoder_kernels(model, mus)]
    return out


def decoder_kernels(model, leaves: list) -> list:
    """The decoder's kernels among ``leaves`` (in the order of the model's
    params), HWIO as the reference makes them, fp32 on the host."""
    out, i = [], 0
    for part, layers in model.params.items():
        for layer in layers.values():
            for key in layer:
                if part == "decoder" and key in ("weight", "kernel"):
                    t = leaves[i].detach().float()
                    out.append((t.permute(2, 3, 1, 0) if key == "weight" else t).cpu().numpy())
                i += 1
    return out


def change_norms(model, cfg: dict, seed: int, width) -> list[float]:
    """Each leaf's change from the seed's weights (made again), in the
    program's layout: convolution weights OIHW, the rest as made."""
    start = weights.make_tree(cfg, seed, model.device, width)
    out = []
    for (part, layers) in model.params.items():
        for name, layer in layers.items():
            for key, t in layer.items():
                t0 = start[part][name]["kernel" if key == "weight" else key]
                if key == "weight":
                    t0 = t0.permute(3, 2, 0, 1)
                out.append(float((t.detach() - t0).norm()))
    del start
    return out


def reference_readings(cfg: dict, seed: int, data: list, device, width, *, steps: int = 3,
                       **kwargs) -> dict:
    """The plain reference's readings of the same three steps (``kwargs``:
    ``fcn.train``'s ``precision``, ``rows``, ``denominator``)."""
    tree = weights.make_tree(cfg, seed, device, width)
    with fcn.exact_fp32():
        out = fcn.train(tree, data[:steps], cfg, seed, steps, **kwargs)
    del tree
    return out


def numbers(program: dict, reference: dict) -> dict:
    """The numbers the check compares: the first step's relative loss gap;
    the worst leaf's gap of the first gradient's norm; the worst decoder
    kernel's distance of the first gradient as a vector, which sees which
    rows made it; and the worst leaf's gap of the change's norm after three
    steps (leaves whose reference gradient is under a thousandth of the
    median leaf's left out)."""
    keep = compare.moving_leaves(reference["grad1"])
    return {"loss1_gap": compare.loss_gap(program["losses"][:1], reference["losses"][:1]),
            "grad1_gap": compare.norm_gap(program["grad1"], reference["grad1"]),
            "grad1_vec_gap": compare.vector_gap(program["grad1_decoder"],
                                                reference["grad1_decoder"]),
            "delta3_gap": compare.norm_gap(program["delta"], reference["delta"], keep)}


def printable(readings: dict) -> dict:
    """Readings without the tensors copied to the host."""
    return {k: v for k, v in readings.items() if k != "grad1_decoder"}


def checks(program: dict, reference: dict, limits: dict) -> list:
    return harness.checks(numbers(program, reference), limits)


def make_data(ctx) -> list:
    """The cycle of resident batches; on a mesh, of the global batch."""
    n, (h, w) = ctx.mix("batch"), ctx.mix("image_hw")
    return scenes.batches(ctx.seed, scenes.TRAIN_STREAM, ctx.mix("cycle"), n, h, w)


def run(ctx: harness.Context) -> harness.Result:
    """One card: this process. More: this process is rank 0 of a
    data-parallel mesh of ``chips`` processes (``portbench/ranks.py``)."""
    if ctx.cell.chips == 1:
        return session(ctx, ctx.device, None)
    init = ranks.init_method()
    procs = ranks.spawn(ctx, init)
    try:
        return run_rank(ctx, 0, init)
    finally:
        ranks.join(procs)


@contextlib.contextmanager
def mesh_rank(world: int, rank: int, init: str, cuda: bool):
    """Rank ``rank`` of the group: NCCL on card ``rank`` (gloo on the CPU)
    and the port's (world, 1) data-parallel mesh over it."""
    import datetime

    import torch.distributed as dist
    from fcn8s_tensorflow_tpu_torch.parallel.mesh import create_mesh

    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=ranks.JOIN_S))
    try:
        yield create_mesh(data=world, model=1,
                          devices=[f"cuda:{r}" if cuda else "cpu" for r in range(world)])
    finally:
        dist.destroy_process_group()


def run_rank(ctx: harness.Context, rank: int, init: str):
    """A rank of the mesh and the session; rank 0 returns the result, the
    others None."""
    with mesh_rank(ctx.cell.chips, rank, init, ctx.device == "cuda") as mesh:
        return session(ctx, mesh.device, mesh)


def _agree(go_on: bool, device, mesh) -> bool:
    """Rank 0's decision, on every rank (each makes the same calls)."""
    if mesh is None:
        return go_on
    import torch.distributed as dist

    flag = torch.tensor([int(go_on)], device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _gather(obj, mesh) -> list:
    if mesh is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def session(ctx: harness.Context, device, mesh):
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    rank = 0 if mesh is None else mesh.rank
    data = make_data(ctx)
    n, hw = ctx.mix("batch"), ctx.mix("image_hw")
    system.reset_peak(device)
    model = system.model(cfg, ctx.seed, device, ctx.width, mesh=mesh)
    kwargs = train_kwargs(cfg, traffic)
    program = program_readings(model, data, cfg, kwargs)
    program["delta"] = change_norms(model, cfg, ctx.seed, ctx.width)
    system.sync(device)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()

    per_call, index, steps = ctx.mix("steps_per_call"), 3, 0
    with tracing.traced(ctx.trace) as trace:
        start = time.perf_counter()
        with tracing.window():
            while True:
                model.train(feed(data, index), epochs=1, steps_per_epoch=per_call, **kwargs)
                system.sync(device)
                steps += per_call
                index += per_call
                if not _agree(time.perf_counter() - start < ctx.seconds, device, mesh):
                    break
        end = time.perf_counter()
    peaks = _gather(system.peak_bytes(device), mesh)
    traces = _gather(trace.summary, mesh)
    del model
    system.free(device)
    if rank != 0:
        return None

    reference = reference_readings(cfg, ctx.seed, data, device, ctx.width)
    widths = weights.scaled(cfg, ctx.width) if ctx.width else None
    images, chips = steps * n, ctx.cell.chips
    return harness.Result(
        setup_s=start - ctx.t0, attempted=steps, failed=0,
        end_to_end={"train_images_per_s": images / (end - start), "setup_s": start - ctx.t0},
        counters={"images": images, "steps": steps, "batch": n // chips, "image_hw": list(hw),
                  "chips": chips, "flops": images * flops.train_flops_per_image(cfg, hw, widths),
                  "config": cfg, "widths": widths, "kind": "train"},
        checks=checks(program, reference, ctx.cell.limits), memory_peak_bytes=max(peaks),
        device_count=chips, trace=tracing.merge(traces) if ctx.trace else None,
        notes={"program": printable(program), "reference": printable(reference)})
