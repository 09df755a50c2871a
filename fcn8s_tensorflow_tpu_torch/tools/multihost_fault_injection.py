"""Multi-process fault injection: a rank dies mid-run, the death is
detected, and the run restarted from its last checkpoint reproduces the
uninterrupted run bit for bit. Port of ``tools/multihost_fault_injection.py``.

The checkpoint carries the step, the params, the whole TF1-Adam state and
the EMA average (``engine/checkpoint.py``), and every draw of a step is a
function of the step, so the replayed steps are the same steps. The check
covers the final params AND the EMA (decay 0.9, every step), so a restart
that restored the weights but re-seeded the average fails it.

Scenario, one process per data position of a ``torch.distributed`` group
(gloo on the CPU and when ranks share a card, NCCL when each has its own):

1. **straight**: the group trains ``TOTAL_STEPS`` data-parallel
   ``parallel.steps.train_step``s on batches from ``default_rng(1000 +
   step)``, rank 0 checkpointing after ``CRASH_AFTER`` steps and at the end;
2. **fault**: a fresh group trains, and rank 1 calls ``os._exit(17)``
   before step ``CRASH_AFTER + 1``; rank 0's next collective fails with it
   (gloo raises when the peer closes; NCCL needs the group's timeout, and the
   launcher's watchdog kills a survivor still blocked after 240 s). The
   launcher requires rank 1's 17 and a non-zero code from rank 0;
3. **resume**: a new group restores ``ckpt_step2`` and trains the rest;
4. the final params and EMA of (1) and (3) must be equal byte for byte.

    python -m fcn8s_tensorflow_tpu_torch.tools.multihost_fault_injection [--device cuda]

``run(workdir, params, ...)`` drives the three groups from any initial
params and sizes; the constants below are the JAX tool's.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_PROCESSES = 2
TOTAL_STEPS = 4
CRASH_AFTER = 2  # checkpointed steps before the injected fault
NUM_CLASSES = 5
GLOBAL_BATCH = 4  # the JAX tool's 2 processes x 2 devices
IMAGE_HW = (32, 32)
WIDTH_MULT, FC_CHANNELS = 1 / 16, 64
LEARNING_RATE = 1e-3
KEEP_PROB = 1.0
EMA_DECAY = 0.9
RUN_SEED = 7  # the JAX tool's PRNGKey(7); keep_prob 1 draws nothing from it
FAULT_EXIT = 17
GROUP_TIMEOUT_S = 60  # a collective's timeout (how NCCL learns of a dead peer)
WATCHDOG_S = 240  # the launcher kills a survivor still blocked after this
RUN_TIMEOUT_S = 600


def batch_for(step_i: int, global_batch: int, hw):
    """The global batch of step ``step_i``: a pure function of the step."""
    rng = np.random.default_rng(1000 + step_i)
    images = rng.integers(0, 255, (global_batch, *hw, 3), np.uint8)
    labels = rng.integers(0, NUM_CLASSES, (global_batch, *hw), np.uint8)
    return images, labels, np.ones((global_batch,), np.float32)


def _rank_device(device: str, rank: int):
    """(torch device, backend) of ``rank``: its own card with NCCL where
    there are enough cards, else the shared device over gloo."""
    import torch

    from ..kernels import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    if torch.cuda.device_count() >= NUM_PROCESSES:
        return torch.device("cuda", rank), "nccl"
    return torch.device("cuda", dev.index or 0), "gloo"


def _to(tree: dict, dev, copy: bool = False) -> dict:
    """A port tree's tensors on ``dev`` (detached copies with ``copy``)."""
    return {p: {n: {k: t.detach().to(dev, copy=copy) for k, t in layer.items()}
                for n, layer in layers.items()} for p, layers in tree.items()}


def child(rank: int, mode: str, workdir: str, params: dict, *, device: str = "cpu",
          hw=IMAGE_HW, global_batch: int = GLOBAL_BATCH) -> None:
    """One rank of one group (``mode``: 'straight', 'fault' or 'resume')
    from the JAX-layout ``params``. Rank 0 writes the checkpoints and
    ``final_<mode>_params.npz`` and ``final_<mode>_ema.npz`` (``save_tree``);
    every rank writes ``result_<mode>_rank<r>.json`` (losses, step times,
    launches)."""
    from . import launch_counts, make_deterministic, save_tree

    make_deterministic()
    import torch
    import torch.distributed as dist

    from .. import bridge
    from ..engine import checkpoint as ckpt
    from ..parallel.mesh import batch_rows, create_mesh
    from ..parallel.steps import create_train_state, make_optimizer, train_step

    dev, backend = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(workdir, 'store_' + mode)}",
                            rank=rank, world_size=NUM_PROCESSES,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = create_mesh(devices=[_rank_device(device, r)[0] for r in range(NUM_PROCESSES)])
    optimizer = make_optimizer()
    start_step, ema = 0, None
    if mode == "resume":
        restored = ckpt.load_checkpoint(os.path.join(workdir, f"ckpt_step{CRASH_AFTER}"),
                                        optimizer)
        if restored["ema"] is None:
            raise RuntimeError("the checkpoint must carry the EMA tree")
        start_step = int(restored["step"])
        if start_step != CRASH_AFTER:
            raise RuntimeError(f"restored step {start_step}, expected {CRASH_AFTER}")
        state = create_train_state(_to(restored["params"], dev), optimizer)
        state.step, state.opt_state = start_step, restored["opt_state"].to(dev)
        ema = _to(restored["ema"], dev)
    else:
        state = create_train_state(bridge.to_port(params, device=dev), optimizer)

    losses, step_s = [], []
    for step_i in range(start_step, TOTAL_STEPS):
        if mode == "fault" and rank == 1 and step_i == CRASH_AFTER + 1:
            print(f"process 1: injecting fault before step {step_i}", flush=True)
            os._exit(FAULT_EXIT)  # a lost host: no cleanup, no goodbye
        images, labels, mask = batch_for(step_i, global_batch, hw)
        rows = batch_rows(global_batch, mesh)
        im, lb, mk = (torch.from_numpy(a if rows is None else a[rows]).to(dev)
                      for a in (images, labels, mask))
        t0 = time.perf_counter()
        state, loss = train_step(state, im, lb, mk, RUN_SEED, LEARNING_RATE, 0.0, KEEP_PROB,
                                 optimizer=optimizer, num_classes=NUM_CLASSES,
                                 compute_dtype=torch.float32, mesh=mesh)
        # the EMA rides the run and the checkpoint: seeded at the first step,
        # then ema = 0.9 * ema + 0.1 * params (the JAX tool's order)
        leaves = bridge.param_leaves(state.params)
        with torch.no_grad():
            if ema is None:
                ema = _to(state.params, dev, copy=True)
            else:
                for e, p in zip(bridge.param_leaves(ema), leaves):
                    e.mul_(EMA_DECAY).add_(p * (1.0 - EMA_DECAY))
        loss = float(loss)  # a sync every step, so the crash lands deterministically
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"process {rank}: step {step_i} loss={loss:.6f}", flush=True)
        if step_i + 1 in (CRASH_AFTER, TOTAL_STEPS) and rank == 0:
            ckpt.save_checkpoint(os.path.join(workdir, f"ckpt_step{step_i + 1}"), state,
                                 {"global_step": step_i + 1, "mode": mode}, ema_params=ema)
    if rank == 0:
        for what, tree in (("params", state.params), ("ema", ema)):
            save_tree(os.path.join(workdir, f"final_{mode}_{what}.npz"), bridge.to_numpy(tree))
    with open(os.path.join(workdir, f"result_{mode}_rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "step_s": step_s, "launches": launch_counts(),
                   "backend": backend, "device": str(dev)}, f)
    dist.destroy_process_group()
    print(f"process {rank}: {mode} run complete", flush=True)


def _launch(mode: str, workdir: str, expect_failure: bool = False) -> list:
    """Start the ranks of one group and wait for them; returns
    their exit codes. A rank still running at the deadline (the watchdog's
    240 s in the fault scenario) is killed: its code is then -9."""
    from . import child_env

    logs = [open(os.path.join(workdir, f"{mode}_rank{r}.log"), "w+")
            for r in range(NUM_PROCESSES)]
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--child", str(r), "--mode",
                               mode, "--workdir", workdir], env=child_env(), stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(NUM_PROCESSES)]
    deadline = time.monotonic() + (WATCHDOG_S if expect_failure else RUN_TIMEOUT_S)
    rcs = []
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        logs[r].seek(0)
        tail = "\n".join(logs[r].read().strip().splitlines()[-4:])
        logs[r].close()
        print(f"--- {mode} process {r} (rc={p.returncode}) ---\n{tail}", flush=True)
        rcs.append(p.returncode)
    return rcs


def final_leaves(workdir: str, mode: str) -> dict:
    """{'params/<part>/<layer>/<leaf>' and 'ema/...': array} of rank 0's
    final trees in run ``mode``."""
    from . import load_tree

    return {f"{what}/{p}/{n}/{k}": v
            for what in ("params", "ema")
            for p, layers in load_tree(os.path.join(workdir, f"final_{mode}_{what}.npz")).items()
            for n, layer in layers.items() for k, v in layer.items()}


def run(workdir: str, params: dict, *, device: str = "cpu", hw=IMAGE_HW,
        global_batch: int = GLOBAL_BATCH) -> dict:
    """The three groups from the JAX-layout ``params`` at the given sizes.
    Returns {'ok', 'straight_ok', 'detected', 'fault_rcs', 'resume_ok',
    'bitexact', 'differing_leaves', 'results'} ('results': each mode's
    per-rank result files)."""
    from . import save_tree

    os.makedirs(workdir, exist_ok=True)
    save_tree(os.path.join(workdir, "params.npz"), params)
    with open(os.path.join(workdir, "config.json"), "w") as f:
        json.dump({"device": device, "hw": list(hw), "global_batch": global_batch}, f)
    out = {"ok": False, "straight_ok": False, "detected": False, "fault_rcs": None,
           "resume_ok": False, "bitexact": False, "differing_leaves": None, "results": {}}
    out["straight_ok"] = all(rc == 0 for rc in _launch("straight", workdir))
    if out["straight_ok"]:
        rcs = _launch("fault", workdir, expect_failure=True)
        # detection: the crashed rank's own code and a failed collective,
        # timeout or watchdog kill on the survivor
        out["fault_rcs"] = rcs
        out["detected"] = rcs[1] == FAULT_EXIT and rcs[0] != 0
    if out["detected"]:
        out["resume_ok"] = all(rc == 0 for rc in _launch("resume", workdir))
    if out["resume_ok"]:
        a, b = final_leaves(workdir, "straight"), final_leaves(workdir, "resume")
        differing = sorted(k for k in a if k not in b or a[k].tobytes() != b[k].tobytes())
        out["differing_leaves"] = differing
        out["bitexact"] = a.keys() == b.keys() and not differing
    for mode in ("straight", "fault", "resume"):
        paths = [os.path.join(workdir, f"result_{mode}_rank{r}.json")
                 for r in range(NUM_PROCESSES)]
        out["results"][mode] = [json.load(open(p)) if os.path.isfile(p) else None for p in paths]
    out["ok"] = out["bitexact"]
    return out


def main(argv=None) -> int:
    if argv is None and "--child" in sys.argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--child", type=int)
        ap.add_argument("--mode")
        ap.add_argument("--workdir")
        a = ap.parse_args()
        from . import load_tree

        with open(os.path.join(a.workdir, "config.json")) as f:
            cfg = json.load(f)
        child(a.child, a.mode, a.workdir, load_tree(os.path.join(a.workdir, "params.npz")),
              device=cfg["device"], hw=tuple(cfg["hw"]), global_batch=cfg["global_batch"])
        return 0
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the ranks (cuda raises without a card; pass "
                         "--device cpu to run on the host)")
    args = ap.parse_args(argv)
    from ..kernels import resolve_device

    resolve_device(args.device)
    workdir = tempfile.mkdtemp(prefix="fcn8s_fault_")
    print(f"workdir: {workdir}")
    from . import initial_params

    out = run(workdir, initial_params(NUM_CLASSES, WIDTH_MULT, FC_CHANNELS), device=args.device)
    if not out["straight_ok"]:
        print("FAULT INJECTION FAILED: straight run did not complete")
    elif not out["detected"]:
        print(f"FAULT INJECTION FAILED: injected fault was not detected (rcs {out['fault_rcs']})")
    elif not out["resume_ok"]:
        print("FAULT INJECTION FAILED: resume run did not complete")
    elif not out["bitexact"]:
        print(f"FAULT INJECTION FAILED: differing leaves {out['differing_leaves']}")
    else:
        print("FAULT INJECTION OK: resumed run matches straight run bit-exactly")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
