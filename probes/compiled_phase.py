#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 25 alone (the compiled steps at full
width: compiled train, multi-train, eval, predict and TTA against eager,
then ``multistep_bench`` at S=4 and 8) after the card check and the kernel
build, and print its launch counts.

    python3 probes/compiled_phase.py
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

t0 = time.perf_counter()
smi = chip_smoke.phase_card()
chip_smoke.phase_build()
print(chip_smoke.phase_compiled(torch.device("cuda", 0), smi)[0])
print(f"probes/compiled_phase.py: {time.perf_counter() - t0:.1f} s")
