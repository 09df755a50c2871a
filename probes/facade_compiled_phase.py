#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s facade paths on the compiled steps alone after
the card check and the kernel build: the service and ``evaluate`` (phases
5 and 6, their exact launch checks) on a fresh full-width model, then
phase 26 (the facade's ``train``, ``evaluate``, ``predict``, tiled,
``predict_tta`` and ``predict_and_save`` against its eager steps, the
captures, images/s and busy share compiled against eager), and print the
launch counts.

    python3 probes/facade_compiled_phase.py
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
model = chip_smoke.FCN8s(num_classes=chip_smoke.C, device=dev)
chip_smoke.phase_serving(model)
chip_smoke.phase_evaluate(model)
model.close()
del model
torch.cuda.empty_cache()
print(chip_smoke.phase_facade_compiled(dev, smi)[0])
print(f"probes/facade_compiled_phase.py: {time.perf_counter() - t0:.1f} s")
