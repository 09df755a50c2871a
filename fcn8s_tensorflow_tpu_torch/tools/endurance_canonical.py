"""Canonical-scale endurance run: the reference's 13k-step recipe, survived,
with a mid-run SIGKILL and a bit-exact resume. Port of
``benchmarks/endurance_canonical.py``.

* 13,000 steps at effective batch 16 (``gradient_accumulation=2``) at the
  tutorial's 256x512 training resolution, on packed synthetic scenes
  (``tools/synthetic.py``: the learnable 6-class generator, palette-jittered);
* the tutorial LR schedule, an evaluation every 500-step epoch,
  save-best-only checkpoints, the EMA (0.999), reduce-LR-on-plateau and the
  JSONL train log all on;
* the orchestrator SIGKILLs the trainer once mid-epoch (~step 6,500) and
  resumes it through ``FCN8s.resume`` (it also resumes a trainer that dies
  or stalls; every incident is recorded);
* a comparator then restores the pre-kill checkpoint and trains the same
  remaining steps in one process; its fingerprint (sha256 of the step, the
  params, the optimizer state and the EMA) must equal the killed and
  resumed run's bit for bit;
* the epochs that the killed trainer logged after the checkpoint its
  successor restored are replayed by the successor: each replayed train-log
  record (training loss, learning rate, eval metrics) must equal the killed
  trainer's, which ran them without a restart (``replay_check``). State that
  a checkpoint drops (the plateau counters, the schedule's position) shows
  there, where the comparator, restored from the same checkpoint, would
  agree with the resume.

Determinism holds because the batch of a step is a pure function of the
step, the dropout and augmentation draws are functions of (seed, step)
(``parallel/steps.py``), checkpoints carry params, Adam's moments, the EMA
and the plateau counters, and each trainer process runs with the
determinism switches of ``tools.make_deterministic`` (cuDNN's and PyTorch's
deterministic algorithms, no autotuning, a fixed cuBLAS workspace). Every
child writes its kernel launch counts into its result JSON.

    python -m fcn8s_tensorflow_tpu_torch.tools.endurance_canonical [--device cuda]
    python -m fcn8s_tensorflow_tpu_torch.tools.endurance_canonical --smoke --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from .synthetic import (AUGMENT_CONFIGS, LABEL_NOISE, batch_for_step, load_packed,
                        make_eval_batches, prepare_packed)


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, file=sys.stderr, flush=True)


def _leaf_bytes(leaf) -> bytes:
    if hasattr(leaf, "detach"):  # laid out on its device, then one plain copy
        leaf = leaf.detach().contiguous().cpu().numpy()
    return np.asarray(leaf).tobytes()


def fingerprint(model) -> str:
    """sha256 over the step, then every param, optimizer-state and EMA leaf,
    each in the JAX package's leaf order, layout (HWIO kernels) and dtype:
    the leaves a checkpoint holds, so one state hashes the same in both
    packages. A model that has not trained since a restore hashes the
    restored optimizer state."""
    from ..engine import checkpoint as ckpt
    from ..parallel.steps import TrainState

    opt_state = model.state.opt_state
    if opt_state is None:
        opt_state = model._staged_opt_state
    if opt_state is None:
        opt_state = model.optimizer.init(model.params, device="cpu")
    state = TrainState(step=int(model.state.step), params=model.params, opt_state=opt_state)
    payload, _ = ckpt._payload(state, model._ema, copy=False)
    h = hashlib.sha256()
    h.update(str(int(model.state.step)).encode())
    for key in ("params_leaves", "opt_leaves", "ema_leaves"):
        for leaf in payload.get(key, []):
            h.update(_leaf_bytes(leaf))
    return h.hexdigest()


def checkpoint_step(name: str | None) -> int:
    """The global step in a checkpoint directory's name (0: no checkpoint,
    the trainer started afresh)."""
    if name is None:
        return 0
    return int(re.search(r"\(globalstep-(\d+)\)", os.path.basename(name)).group(1))


def replay_check(history: list, events: list) -> dict:
    """The train-log records that a restarted trainer wrote again: every
    step logged more than once must carry the same record each time, apart
    from its wall time and its epoch (counted from each trainer's start),
    and every step that a killed trainer logged after the checkpoint its
    successor restored (``event['ckpt']``) must have been logged again.
    Returns {'replayed_steps', 'mismatched', 'missing', 'match'}."""
    by_step: dict = {}
    for record in history:
        by_step.setdefault(record["global_step"], []).append(
            {k: v for k, v in record.items() if k not in ("epoch", "time")})
    replayed = sorted(step for step, records in by_step.items() if len(records) > 1)
    mismatched = [step for step in replayed
                  if any(r != by_step[step][0] for r in by_step[step][1:])]
    expected = {step for e in events for step in by_step
                if checkpoint_step(e["ckpt"]) < step <= e["at_step"]}
    missing = sorted(expected - set(replayed))
    return {"replayed_steps": replayed, "mismatched": mismatched, "missing": missing,
            "match": not mismatched and not missing}


def run_child(args) -> int:
    t_start = time.perf_counter()
    from . import launch_counts, make_deterministic

    make_deterministic()  # before CUDA initialises
    import torch

    from ..engine.model import FCN8s
    from ..engine.schedules import reference_tutorial_schedule

    images, labels = load_packed(args.packed)
    if args.mode == "fresh":
        model = FCN8s(num_classes=6, seed=0, width_mult=args.width_mult,
                      fc_channels=args.fc_channels, device=args.device)
    elif args.mode == "resume":
        model = FCN8s.resume(args.save_dir, device=args.device)
    elif args.mode == "compare":
        model = FCN8s(model_load_dir=args.from_ckpt, device=args.device)
    else:
        raise ValueError(args.mode)

    t_model = time.perf_counter()
    start = int(model.state.step)
    if start % args.spe != 0:
        raise AssertionError(f"restored step {start} not an epoch boundary (spe={args.spe})")
    remaining_epochs = (args.total_steps - start) // args.spe
    log(f"child mode={args.mode} start_step={start} remaining_epochs={remaining_epochs}")

    # a throttle for short runs, whose steps would otherwise end the run
    # before the orchestrator's kill can land
    throttle = float(os.environ.get("ENDURANCE_THROTTLE_S", "0") or 0)
    # a config that noises labels on the card ships clean ones from the host
    host_noise = "label_noise" not in AUGMENT_CONFIGS[args.augment]

    def gen():
        step = start
        while True:
            if throttle:
                time.sleep(throttle)
            yield batch_for_step(images, labels, step, args.batch, host_noise=host_noise)
            step += 1

    eval_set = make_eval_batches(images.shape[1], images.shape[2], args.batch, n_batches=2)

    def val_gen():
        while True:
            yield from eval_set

    if remaining_epochs > 0:
        model.train(
            train_generator=gen(),
            epochs=remaining_epochs,
            steps_per_epoch=args.spe,
            learning_rate_schedule=reference_tutorial_schedule(),
            keep_prob=0.5,
            l2_regularization=0.0,
            eval_dataset="val",
            eval_frequency=1,
            val_generator=val_gen(),
            val_steps=len(eval_set),
            metrics={"loss", "mean_iou", "accuracy"},
            save_during_training=True,
            save_dir=args.child_save_dir,
            save_best_only=True,
            monitor="loss",
            save_frequency=1,
            record_summaries=False,
            device_augment=AUGMENT_CONFIGS[args.augment],
            gradient_accumulation=args.grad_accum,
            ema_decay=0.999,
            reduce_lr_on_plateau={"patience": 8, "factor": 0.5},
            train_log=args.train_log,
            prefetch=2,
        )
    t_train = time.perf_counter()
    # training_loss is None when a resume landed at total_steps (killed after
    # the last save, before result.json): the run is still whole
    loss = model.training_loss
    result = {"final_step": int(model.state.step),
              "fingerprint": fingerprint(model),
              "training_loss": float(loss) if loss is not None else None,
              "launches": launch_counts(),
              "device": (torch.cuda.get_device_name(model.device)
                         if model.device.type == "cuda" else "cpu")}
    # host clock: build or restore the model, train (the last save joined),
    # hash the state
    result["seconds"] = {"model": t_model - t_start, "train": t_train - t_model,
                         "fingerprint": time.perf_counter() - t_train}
    with open(args.result, "w") as f:
        json.dump(result, f)
    model.close()
    log(f"child done: {result}")
    return 0


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


def _spawn_child(args, mode: str, out_root: str, from_ckpt: str | None = None,
                 save_dir: str | None = None, train_log: str | None = None,
                 result: str | None = None):
    from . import child_env

    cmd = [sys.executable, "-m", __spec__.name, "--child", "--mode", mode,
           "--device", args.device, "--packed", args.packed,
           "--total-steps", str(args.total_steps), "--spe", str(args.spe),
           "--batch", str(args.batch), "--grad-accum", str(args.grad_accum),
           "--width-mult", str(args.width_mult),
           "--fc-channels", str(args.fc_channels),
           "--augment", args.augment,
           "--child-save-dir", save_dir or os.path.join(out_root, "ckpts"),
           "--save-dir", save_dir or os.path.join(out_root, "ckpts"),
           "--train-log", train_log or os.path.join(out_root, "train_log.jsonl"),
           "--result", result or os.path.join(out_root, "result.json")]
    if from_ckpt:
        cmd += ["--from-ckpt", from_ckpt]
    stdout_path = os.path.join(out_root, f"child_{mode}_{time.time_ns()}.log")
    with open(stdout_path, "w") as stdout:
        proc = subprocess.Popen(cmd, stdout=stdout, stderr=subprocess.STDOUT, env=child_env(),
                                start_new_session=True)
    proc.stdout_path = stdout_path
    return proc


def _log_last_step(train_log: str) -> int:
    last = 0
    if os.path.isfile(train_log):
        with open(train_log) as f:
            for line in f:
                try:
                    last = max(last, int(json.loads(line).get("global_step", 0)))
                except (ValueError, KeyError):
                    pass
    return last


def _kill(child) -> None:
    os.kill(child.pid, signal.SIGKILL)
    child.wait()


def orchestrate(args) -> int:
    from ..engine.checkpoint import latest_checkpoint

    t0 = time.time()
    out_root = args.out_root
    os.makedirs(out_root, exist_ok=True)
    args.packed = prepare_packed(args.packed, n=args.dataset_size, h=args.height, w=args.width)
    save_dir = os.path.join(out_root, "ckpts")
    train_log = os.path.join(out_root, "train_log.jsonl")
    result_path = os.path.join(out_root, "result.json")
    for p in (train_log, result_path):
        if os.path.isfile(p):
            os.remove(p)
    if os.path.isdir(save_dir):
        shutil.rmtree(save_dir)

    events = []
    kill_at = args.kill_at_step
    killed = False
    ckpt_a = None
    resumes = 0
    fast_fails = 0

    def respawn():
        # resume from the latest checkpoint, or start afresh if none landed
        # yet; the event that caused it names that checkpoint
        latest = latest_checkpoint(save_dir)
        events[-1]["ckpt"] = os.path.basename(latest) if latest else None
        c = _spawn_child(args, "resume" if latest else "fresh", out_root, save_dir=save_dir,
                         train_log=train_log, result=result_path)
        log(f"trainer relaunched from {latest or 'scratch'} (pid {c.pid})")
        return c, time.time()

    child = _spawn_child(args, "fresh", out_root, save_dir=save_dir, train_log=train_log,
                         result=result_path)
    child_t0 = time.time()
    log(f"trainer launched (pid {child.pid}); will SIGKILL ~step {kill_at}")
    last_progress = (0, time.time())
    # until the log shows a step past the one a child started from, it is
    # still loading and building, and gets the first-progress leash
    child_start_step = 0

    def alive_t(c):
        # the child's stdout log moves every epoch (and on every message)
        try:
            return os.path.getmtime(c.stdout_path)
        except OSError:
            return 0.0

    try:
        while True:
            time.sleep(args.poll_s)
            step_now = _log_last_step(train_log)
            activity = max(alive_t(child), last_progress[1])
            if step_now > last_progress[0] or activity > last_progress[1]:
                last_progress = (max(step_now, last_progress[0]), activity)
                fast_fails = 0

            rc = child.poll()
            if rc is not None:
                if rc == 0 and os.path.isfile(result_path):
                    log(f"trainer finished at step {step_now}")
                    break
                if time.time() - child_t0 < 20:
                    fast_fails += 1
                    if fast_fails >= 2:
                        log(f"trainer died twice within 20s (rc={rc}): a config error, "
                            f"not a flake; giving up (see {child.stdout_path})")
                        return 1
                events.append({"event": "unexpected_exit", "rc": rc, "at_step": step_now,
                               "t": time.time() - t0})
                resumes += 1
                if resumes > args.max_resumes:
                    log("too many resumes; giving up")
                    return 1
                log(f"trainer exited rc={rc}; resuming ({resumes})")
                child, child_t0 = respawn()
                child_start_step = step_now
                last_progress = (step_now, time.time())
                continue

            if not killed and step_now >= kill_at:
                time.sleep(args.kill_delay_s)  # land the SIGKILL mid-epoch
                _kill(child)
                killed = True
                latest = latest_checkpoint(save_dir)
                if latest is not None:
                    ckpt_a = os.path.join(out_root, "ckpt_prekill")
                    if os.path.isdir(ckpt_a):
                        shutil.rmtree(ckpt_a)
                    shutil.copytree(latest, ckpt_a)
                # an asynchronous save the kill cut mid-write stays a .tmp,
                # which no resume reads
                cut = sorted(d for d in os.listdir(save_dir) if d.endswith(".tmp"))
                events.append({"event": "sigkill", "at_step": step_now,
                               "cut_writes": cut, "t": time.time() - t0})
                resumes += 1
                log(f"SIGKILLed trainer at logged step {step_now}; snapshot {latest} -> "
                    f"ckpt_prekill; resuming")
                child, child_t0 = respawn()
                child_start_step = step_now
                last_progress = (step_now, time.time())
                continue

            stall_budget = (args.first_progress_timeout_s
                            if last_progress[0] <= child_start_step else args.stall_timeout_s)
            if time.time() - last_progress[1] > stall_budget:
                events.append({"event": "stall_kill", "at_step": step_now,
                               "t": time.time() - t0})
                resumes += 1
                if resumes > args.max_resumes:
                    log("too many resumes; giving up")
                    return 1
                log(f"no progress for {stall_budget}s; killing + resuming")
                _kill(child)
                child, child_t0 = respawn()
                child_start_step = step_now
                last_progress = (step_now, time.time())
    finally:
        if child.poll() is None:
            _kill(child)

    with open(result_path) as f:
        main_result = json.load(f)
    wall_main = time.time() - t0

    # the comparator: the pre-kill checkpoint (or, if the kill came before
    # the first save, a fresh model) to total_steps, uninterrupted
    log("comparator: training uninterrupted from the pre-kill checkpoint")
    cmp_result_path = os.path.join(out_root, "result_compare.json")
    cmp_save = os.path.join(out_root, "ckpts_compare")
    if os.path.isdir(cmp_save):
        shutil.rmtree(cmp_save)
    cmp_child = _spawn_child(
        args, "compare" if ckpt_a else "fresh", out_root, from_ckpt=ckpt_a, save_dir=cmp_save,
        train_log=os.path.join(out_root, "train_log_compare.jsonl"), result=cmp_result_path)
    try:
        rc = cmp_child.wait()
    finally:
        if cmp_child.poll() is None:
            _kill(cmp_child)
    if rc != 0 or not os.path.isfile(cmp_result_path):
        log(f"comparator failed rc={rc} (see {cmp_child.stdout_path})")
        return 1
    with open(cmp_result_path) as f:
        cmp_result = json.load(f)

    bitmatch = (main_result["fingerprint"] == cmp_result["fingerprint"]
                and main_result["final_step"] == cmp_result["final_step"])

    history = []
    with open(train_log) as f:
        for line in f:
            history.append(json.loads(line))
    finite = all(np.isfinite(r["training_loss"]) for r in history)
    mious = [r["eval_mean_iou"] for r in history if "eval_mean_iou" in r]
    replay = replay_check(history, events)

    report = {
        "config": {
            "total_steps": args.total_steps, "steps_per_epoch": args.spe,
            "effective_batch": args.batch, "grad_accum": args.grad_accum,
            "resolution": [args.height, args.width],
            "dataset": f"packed synthetic x{args.dataset_size}",
            "schedule": "reference_tutorial (1e-4 -> 1e-5@10k -> 3e-6@20k)",
            "ema_decay": 0.999, "plateau": {"patience": 8, "factor": 0.5},
            "width_mult": args.width_mult, "fc_channels": args.fc_channels,
            "device_augment": AUGMENT_CONFIGS[args.augment],
            "label_noise": LABEL_NOISE,
            "label_noise_carrier": ("device_post_augment"
                                    if "label_noise" in AUGMENT_CONFIGS[args.augment]
                                    else "host_pre_augment"),
            "device": main_result.get("device"),
            "throttle_s": float(os.environ.get("ENDURANCE_THROTTLE_S", "0") or 0),
            "kill_at_step": args.kill_at_step,
        },
        "wall_s_train": round(wall_main, 1),
        "wall_s_total": round(time.time() - t0, 1),
        "events": events,
        "resumes": resumes,
        "final": main_result,
        "comparator": cmp_result,
        "bitexact_resume": bitmatch,
        "replay": replay,
        "all_losses_finite": finite,
        "final_miou": mious[-1] if mious else None,
        "history": history,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    log(f"report -> {args.report}")
    log(f"bit-exact resume: {bitmatch}; replayed steps {replay['replayed_steps']} equal: "
        f"{replay['match']}; finite: {finite}; final mIoU: {report['final_miou']}; "
        f"kills: {[e['event'] for e in events]}")
    ok = (bitmatch and replay["match"] and finite
          and main_result["final_step"] == args.total_steps)
    if mious:
        ok = ok and mious[-1] > args.miou_floor
    print(json.dumps({"endurance_ok": ok, "bitexact_resume": bitmatch,
                      "replay_match": replay["match"],
                      "final_step": main_result["final_step"],
                      "final_miou": report["final_miou"],
                      "wall_s": report["wall_s_total"], "resumes": resumes}))
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--child", action="store_true")
    p.add_argument("--mode", default="fresh", choices=["fresh", "resume", "compare"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the trainer (cuda raises without a card; "
                        "pass --device cpu to run on the host)")
    p.add_argument("--packed", default=os.path.join(tmp, "endurance_packed"))
    p.add_argument("--out-root", default=os.path.join(tmp, "endurance_out"))
    p.add_argument("--report", default=None,
                   help="report path (default: <out-root>/endurance_report.json)")
    p.add_argument("--total-steps", type=int, default=13000)
    p.add_argument("--spe", type=int, default=500, help="steps per epoch")
    p.add_argument("--batch", type=int, default=16, help="effective batch")
    p.add_argument("--grad-accum", type=int, default=2)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--dataset-size", type=int, default=2048,
                   help="packed pool size; big enough that 13k steps x16 "
                        "(~100 visits/scene) doesn't memorize the pool")
    p.add_argument("--width-mult", type=float, default=1.0)
    p.add_argument("--fc-channels", type=int, default=4096)
    p.add_argument("--augment", default="flip", choices=sorted(AUGMENT_CONFIGS))
    p.add_argument("--kill-at-step", type=int, default=6500)
    p.add_argument("--kill-delay-s", type=float, default=20.0)
    p.add_argument("--stall-timeout-s", type=float, default=720.0)
    p.add_argument("--first-progress-timeout-s", type=float, default=1500.0)
    p.add_argument("--poll-s", type=float, default=10.0)
    p.add_argument("--max-resumes", type=int, default=8)
    p.add_argument("--miou-floor", type=float, default=0.5)
    p.add_argument("--smoke", action="store_true",
                   help="tiny end-to-end orchestration check")
    # child-only
    p.add_argument("--from-ckpt", default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--child-save-dir", default=None)
    p.add_argument("--train-log", default=None)
    p.add_argument("--result", default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.total_steps, args.spe, args.batch = 20, 5, 4
        args.height = args.width = 64
        args.dataset_size = 16
        args.width_mult, args.fc_channels = 1 / 8, 128
        args.kill_at_step, args.kill_delay_s = 10, 1.0
        args.stall_timeout_s = 600.0
        args.first_progress_timeout_s = 900.0
        args.poll_s = 1.0
        args.miou_floor = 0.0
        args.packed += "_smoke"
        args.out_root += "_smoke"
        os.environ["ENDURANCE_THROTTLE_S"] = "1.0"  # see run_child
    if args.report is None:
        args.report = os.path.join(args.out_root, "endurance_report.json")
    if args.child:
        return run_child(args)
    from ..kernels import resolve_device

    resolve_device(args.device)  # no card: raise here, before any child starts
    return orchestrate(args)


if __name__ == "__main__":
    sys.exit(main())
