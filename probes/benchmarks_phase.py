#!/usr/bin/env python3
"""The port's measurement scripts at their full length on the card, each
run as a user runs it (``python -m``), then the tutorial notebook at its
defaults; or, with ``--phase``, ``chip_smoke.py``'s phase 24 alone (after
the card check, the kernel build and phase 13's step time).

    python3 probes/benchmarks_phase.py [--out-dir DIR]
    python3 probes/benchmarks_phase.py --phase

Each script's printed lines, its exit code and seconds go into
``OUT_DIR/benchmarks_phase.json``; the card's name and power limit head it.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SCRIPTS = ("bench", "pallas_pool_bench", "profile_train_step", "device_augment_bench",
           "ignore_label_bench", "overlay_bench", "int8_wgrad_bench", "int8_closed_loop",
           "e2e_input_bench", "packed_input_bench")
TIMEOUT_S = 900


def run_script(name: str, out_dir: str) -> dict:
    from fcn8s_tensorflow_tpu_torch.tools import child_env

    cmd = [sys.executable, "-m", f"fcn8s_tensorflow_tpu_torch.benchmarks.{name}"]
    if name == "int8_closed_loop":
        cmd += ["--out", os.path.join(out_dir, "int8_closed_loop.json")]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, env=child_env(), capture_output=True, text=True, timeout=TIMEOUT_S,
                         cwd=ROOT)
    seconds = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    print(f"--- {name}: rc {out.returncode}, {seconds:.1f} s", flush=True)
    print("\n".join(lines[-45:]), flush=True)
    if out.returncode:
        print(out.stderr[-3000:], flush=True)
    return {"rc": out.returncode, "seconds": seconds, "stdout": lines,
            "stderr_tail": out.stderr.strip().splitlines()[-12:]}


def run_notebook() -> dict:
    from fcn8s_tensorflow_tpu_torch.examples import run_notebook as run

    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="fcn8s_notebook_")
    t0 = time.perf_counter()
    os.chdir(work)
    try:
        ns = run()
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0, "steps": ns["model"].state.step,
           "metrics": {k: float(v) for k, v in ns["metrics"].items()}}
    print(f"--- notebook: {out}", flush=True)
    return out


def phase_only() -> None:
    """Phase 24 after phase 13's step time on a model trained one step."""
    t0 = time.perf_counter()
    smi = chip_smoke.phase_card()
    chip_smoke.phase_build()
    dev = torch.device("cuda", 0)
    model = chip_smoke.FCN8s(num_classes=chip_smoke.C, device=dev, seed=3)
    rng = np.random.default_rng(6)
    model.train(itertools.repeat(chip_smoke._synthetic(rng, chip_smoke.BATCH)), epochs=1,
                steps_per_epoch=1, learning_rate_schedule=lambda s: 1e-4, keep_prob=0.5,
                record_summaries=False)
    step_ms = chip_smoke.phase_train_times(dev, model, smi)
    model.close()
    del model
    torch.cuda.empty_cache()
    print(chip_smoke.phase_benchmarks(dev, smi, step_ms))
    print(f"probes/benchmarks_phase.py --phase: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build", "benchmarks"))
    ap.add_argument("--phase", action="store_true", help="run chip_smoke.py's phase 24 alone")
    args = ap.parse_args()
    if args.phase:
        phase_only()
        return
    t0 = time.perf_counter()
    smi = chip_smoke.phase_card()
    chip_smoke.phase_build()  # once, before the scripts' processes load it
    os.makedirs(args.out_dir, exist_ok=True)
    report = {"card": smi, "torch": torch.__version__, "scripts": {}}
    for name in SCRIPTS:
        report["scripts"][name] = run_script(name, args.out_dir)
    report["notebook"] = run_notebook()
    report["seconds"] = time.perf_counter() - t0
    path = os.path.join(args.out_dir, "benchmarks_phase.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    failed = [n for n, r in report["scripts"].items() if r["rc"]]
    print(f"probes/benchmarks_phase.py on {smi}: {report['seconds']:.1f} s, report {path}, "
          f"failed {failed}")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
