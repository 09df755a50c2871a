#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 28 alone (``InferenceService`` on a mesh of
two gloo ranks sharing the card, against the single-rank service) after the
card check and the kernel build, and print its launch counts.

    python3 probes/serving_mesh_phase.py
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

t0 = time.perf_counter()
smi = chip_smoke.phase_card()
dev = torch.device("cuda", 0)
chip_smoke.phase_build()
print(chip_smoke.phase_serving_mesh(dev, smi))
print(f"probes/serving_mesh_phase.py: {time.perf_counter() - t0:.1f} s")
