#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 23 alone (the endurance kill-and-resume,
fault injection on two gloo ranks and the quickstart, at full width) after
the card check and the kernel build, and print its launch counts.

    python3 probes/survival_phase.py
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
print(chip_smoke.phase_survival(torch.device("cuda", 0), smi))
print(f"probes/survival_phase.py: {time.perf_counter() - t0:.1f} s")
