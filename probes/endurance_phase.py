#!/usr/bin/env python3
"""The survival tools at full length on the card: ``tools.endurance_canonical``
at its defaults (13,000 steps of effective batch 16 at 256x512, full VGG-16
width, a SIGKILL near step 6,500, the comparator) for each ``--augment``
recipe, then ``tools.convergence_synthetic`` for the three variants at the
lengths of the JAX package's committed artifacts (fcn8s 600 steps, fcn16s
and fcn32s 200). Reports go to ``--out-dir`` as ``endurance_torch_<augment>.json``
and ``convergence_torch_<variant>.json``; each run's time is printed beside
the card's name and power limit.

    python3 probes/endurance_phase.py [--augment flip full] [--variants fcn8s fcn16s fcn32s]
        [--total-steps 13000] [--out-dir probes]
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fcn8s_tensorflow_tpu_torch.tools import child_env  # noqa: E402

CONVERGENCE_STEPS = {"fcn8s": 600, "fcn16s": 200, "fcn32s": 200}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--augment", nargs="*", default=["flip", "full"])
    p.add_argument("--variants", nargs="*", default=list(CONVERGENCE_STEPS))
    p.add_argument("--total-steps", type=int, default=13000,
                   help="the endurance run's length (a cut, if below 13,000)")
    p.add_argument("--out-dir", default=os.path.join(ROOT, "probes"))
    args = p.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="fcn8s_endurance_")
    failed = []
    for variant in args.variants:
        out = os.path.join(args.out_dir, f"convergence_torch_{variant}.json")
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, "-m",
                             "fcn8s_tensorflow_tpu_torch.tools.convergence_synthetic",
                             "--variant", variant, "--steps", str(CONVERGENCE_STEPS[variant]),
                             "--out", out], env=child_env()).returncode
        print(f"convergence {variant}: rc {rc}, {time.perf_counter() - t0:.1f} s ({smi})",
              flush=True)
        if rc:
            failed.append(f"convergence {variant}")
    for augment in args.augment:
        report = os.path.join(args.out_dir, f"endurance_torch_{augment}.json")
        cmd = [sys.executable, "-m", "fcn8s_tensorflow_tpu_torch.tools.endurance_canonical",
               "--device", "cuda", "--augment", augment, "--report", report,
               "--packed", os.path.join(work, "packed"),
               "--out-root", os.path.join(work, f"out_{augment}"),
               "--total-steps", str(args.total_steps),
               "--kill-at-step", str(args.total_steps // 2)]
        t0 = time.perf_counter()
        rc = subprocess.run(cmd, env=child_env()).returncode
        print(f"endurance {augment}: rc {rc}, {time.perf_counter() - t0:.1f} s ({smi})",
              flush=True)
        if rc:
            failed.append(f"endurance {augment}")
        shutil.rmtree(os.path.join(work, f"out_{augment}"), ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    print(f"failed: {failed}" if failed else "all runs passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
