"""Multi-process smoke: ranks of one ``torch.distributed`` group run one full
sharded train step. Port of ``tools/multihost_smoke.py``.

Each rank is one position of a global ('data', 'model') mesh
(``parallel/mesh.py``: one process per position, where JAX runs one
process per host over its devices). The default is 2 ranks on a (1, 2)
mesh with fc6/fc7 tensor-parallel; ``--procs P --devices-per-proc D``
gives P x D ranks on a (P x D / 2, 2) mesh, so JAX's ``--procs 4
--devices-per-proc 2`` matrix point is 8 ranks on (4, 2). Success: every
rank prints the same finite loss.

``--sharded-input`` proves the multi-process INPUT pipeline: every rank is
its own data position (a (ranks, 1) mesh), reads only its
``BatchGenerator.generate(shard=(rank, ranks))`` slice of one shared
dataset and feeds just those rows to ``parallel.steps.train_step``, which
takes each rank's rows and sums the loss normalisers and gradients over
'data' (no exchange of inputs). The parent checks that the shards are
disjoint and cover the epoch, and that every rank computed the same
global loss.

``run(ranks, ..., params=)`` starts every rank from the given JAX-layout
params (by default the port's seed-0 init at the tool's sizes).

    python -m fcn8s_tensorflow_tpu_torch.tools.multihost_smoke [--device cuda]
    python -m fcn8s_tensorflow_tpu_torch.tools.multihost_smoke --procs 4 --devices-per-proc 2
    python -m fcn8s_tensorflow_tpu_torch.tools.multihost_smoke --sharded-input
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile

NUM_PROCESSES = 2
DEVICES_PER_PROCESS = 1  # one process per mesh position
NUM_CLASSES = 20
GLOBAL_BATCH = 8
IMAGE_HW = (64, 64)
GROUP_TIMEOUT_S = 300
N_IMAGES = 8  # --sharded-input's dataset


def make_dataset(root: str, n_images: int, num_classes: int) -> None:
    """A tiny Cityscapes-shaped tree whose image i is the constant pixel
    value ``i*10 + 5``: a rank reports which images its shard consumed by
    reading one pixel back."""
    import numpy as np
    from PIL import Image

    img_dir = os.path.join(root, "img", "aachen")
    gt_dir = os.path.join(root, "gt", "aachen")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    for i in range(n_images):
        stem = f"aachen_{i:06d}_000019"
        Image.fromarray(np.full((64, 64, 3), i * 10 + 5, np.uint8)).save(
            os.path.join(img_dir, stem + "_leftImg8bit.png"))
        Image.fromarray(np.full((64, 64), i % num_classes, np.uint8)).save(
            os.path.join(gt_dir, stem + "_gtFine_labelIds.png"))


def mesh_shape(ranks: int, sharded: bool) -> tuple[int, int]:
    """(data, model): tensor-parallel pairs, or one data position per rank
    for disjoint input."""
    if sharded or ranks == 1:
        return ranks, 1
    if ranks % 2:
        raise ValueError(f"{ranks} ranks do not pair up on a 'model' axis of 2")
    return ranks // 2, 2


def child(rank: int, ranks: int, store: str, params: dict, device: str = "cpu",
          data_dir: str | None = None) -> float:
    """One rank: one fp32 train step of the width-1/16, 20-class model
    ``params`` (a JAX-layout tree) on the global batch (``default_rng(0)``)
    or, with ``data_dir``, on this rank's shard. Prints and returns the
    global loss."""
    from . import make_deterministic

    make_deterministic()
    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import bridge
    from ..kernels import resolve_device
    from ..parallel.mesh import batch_rows, create_mesh
    from ..parallel.steps import create_train_state, make_optimizer, train_step

    dev = resolve_device(device)
    multi_card = dev.type == "cuda" and torch.cuda.device_count() >= ranks
    if multi_card:
        dev = torch.device("cuda", rank)
    elif dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if multi_card else "gloo", init_method=f"file://{store}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    data, model = mesh_shape(ranks, data_dir is not None)
    mesh = create_mesh(data, model, devices=[
        torch.device("cuda", r) if multi_card else dev for r in range(ranks)])
    optimizer = make_optimizer()
    state = create_train_state(bridge.to_port_shards(params, mesh, tensor_parallel=True),
                               optimizer)

    if data_dir is not None:
        # disjoint input: this rank reads ONLY its generate(shard=...) slice
        from ..data import BatchGenerator

        gen = BatchGenerator(
            image_dirs=[os.path.join(data_dir, "img")],
            ground_truth_dirs=[os.path.join(data_dir, "gt")],
            image_name_split_separator="leftImg8bit",
            ground_truth_suffix="gtFine_labelIds",
            num_classes=NUM_CLASSES,
        )
        local_batch = GLOBAL_BATCH // ranks
        imgs, gts = next(gen.generate(batch_size=local_batch, convert_to_one_hot=False,
                                      shuffle=True, seed=7, shard=(rank, ranks)))
        images = np.stack(imgs).astype(np.uint8)
        labels = np.stack(gts).astype(np.uint8)
        mask = np.ones((local_batch,), np.float32)
        consumed = sorted(int(im[0, 0, 0]) // 10 for im in images)
        print(f"process {rank}: consumed={consumed}", flush=True)
    else:
        rng = np.random.default_rng(0)  # the same seed: the same global batch
        images = rng.integers(0, 255, (GLOBAL_BATCH, *IMAGE_HW, 3), np.uint8)
        labels = rng.integers(0, NUM_CLASSES, (GLOBAL_BATCH, *IMAGE_HW), np.uint8)
        mask = np.ones((GLOBAL_BATCH,), np.float32)
        rows = batch_rows(GLOBAL_BATCH, mesh)
        if rows is not None:
            images, labels, mask = images[rows], labels[rows], mask[rows]
    im, lb, mk = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (images, labels, mask))
    state, loss = train_step(state, im, lb, mk, 1, 1e-4, 0.0, 1.0, optimizer=optimizer,
                             num_classes=NUM_CLASSES, compute_dtype=torch.float32, mesh=mesh,
                             tensor_parallel=True)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if state.step != 1:
        raise RuntimeError(f"step {state.step} after one train step")
    print(f"process {rank}: multihost step OK, loss={loss:.6f}", flush=True)
    dist.destroy_process_group()
    return loss


def run(ranks: int, device: str = "cpu", sharded: bool = False, workdir: str | None = None,
        timeout_s: float = 600.0, params: dict | None = None) -> dict:
    """Launch ``ranks`` ranks from ``params`` (default: ``initial_params``
    at width 1/16, fc 64) and check them; returns {'ok', 'losses',
    'consumed', 'rcs', 'mesh', 'output'}."""
    from . import child_env, initial_params, save_tree

    workdir = workdir or tempfile.mkdtemp(prefix="multihost_")
    if params is None:
        params = initial_params(NUM_CLASSES, 1 / 16, 64)
    save_tree(os.path.join(workdir, "params.npz"), params)
    extra = ["--params", os.path.join(workdir, "params.npz")]
    if sharded:
        data_dir = os.path.join(workdir, "data")
        make_dataset(data_dir, n_images=N_IMAGES, num_classes=NUM_CLASSES)
        extra += ["--data-dir", data_dir]
    store = os.path.join(workdir, "store")
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+") for r in range(ranks)]
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--child", str(r),
                               "--ranks", str(ranks), "--store", store, "--device", device]
                              + extra, env=child_env(), stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(ranks)]
    ok, losses, consumed, rcs, output = True, [], {}, [], []
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        logs[r].seek(0)
        out = logs[r].read()
        logs[r].close()
        output.append(f"--- process {r} (rc={p.returncode}) ---\n"
                      + "\n".join(out.strip().splitlines()[-5:]))
        rcs.append(p.returncode)
        ok &= p.returncode == 0
        for line in out.splitlines():
            if "multihost step OK, loss=" in line:
                losses.append(float(line.rsplit("=", 1)[1]))
            if "consumed=" in line:
                consumed[r] = json.loads(line.rsplit("=", 1)[1])
    result = {"ok": False, "losses": losses, "consumed": consumed, "rcs": rcs,
              "mesh": mesh_shape(ranks, sharded), "output": "\n".join(output)}
    if sharded and ok:
        shards = [set(consumed.get(r, ())) for r in range(ranks)]
        union = set().union(*shards)
        if not (sum(len(s) for s in shards) == len(union) == N_IMAGES):
            result["output"] += f"\nshards not disjoint-covering: {consumed}"
            return result
    result["ok"] = ok and len(losses) == ranks and len(set(losses)) == 1
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--procs", type=int, default=NUM_PROCESSES)
    p.add_argument("--devices-per-proc", type=int, default=DEVICES_PER_PROCESS,
                   help="mesh positions per process of the JAX tool; the port runs "
                        "procs x this many ranks")
    p.add_argument("--sharded-input", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the ranks (cuda raises without a card; pass "
                        "--device cpu to run on the host)")
    p.add_argument("--child", type=int, default=None)
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--store", default=None)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--params", default=None)
    args = p.parse_args(argv)
    if args.child is not None:
        from . import load_tree

        child(args.child, args.ranks, args.store, load_tree(args.params), args.device,
              args.data_dir)
        return 0
    from ..kernels import resolve_device

    resolve_device(args.device)
    ranks = args.procs * args.devices_per_proc
    result = run(ranks, args.device, args.sharded_input)
    print(result["output"])
    if args.sharded_input and result["consumed"] and result["ok"]:
        print(f"sharded input OK: disjoint shards "
              f"{sorted(map(sorted, result['consumed'].values()))}")
    if result["ok"]:
        print(f"MULTIHOST SMOKE OK: {ranks} processes agree, loss={result['losses'][0]:.6f}")
        return 0
    print("MULTIHOST SMOKE FAILED")
    return 1


if __name__ == "__main__":
    sys.exit(main())
