#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 27 alone (the compiled steps over a mesh of
two gloo ranks sharing the card, their graphs cut at the collectives,
against the eager mesh steps) after the card check and the kernel build,
then phases 21 (a) and 22 (a) (a group of one rank on the card, the
facade's compiled steps with ``mesh=`` and ``spatial_partition``), and
print the launch counts.

    python3 probes/mesh_compiled_phase.py [--only-27]
"""

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

t0 = time.perf_counter()
smi = chip_smoke.phase_card()
dev = torch.device("cuda", 0)
chip_smoke.phase_build()
print(chip_smoke.phase_mesh_compiled(dev, smi))
print(f"phase 27 done at {time.perf_counter() - t0:.1f} s")
if "--only-27" not in sys.argv:
    root = tempfile.mkdtemp(prefix="fcn8s_probe_")
    try:
        tree = chip_smoke._mesh_tree(dev)
        print(chip_smoke.phase_mesh_world1(dev, tree, root, smi)["counts"])
        model = chip_smoke.FCN8s(num_classes=chip_smoke.C, device=dev, seed=chip_smoke.SPATIAL_SEED)
        chip_smoke._redraw_decoder(model, np.random.default_rng(chip_smoke.SPATIAL_SEED))
        tree = chip_smoke.bridge.to_numpy(model.params)
        model.close()
        del model
        torch.cuda.empty_cache()
        os.makedirs(os.path.join(root, "s"))
        print(chip_smoke.phase_spatial_world1(dev, tree, os.path.join(root, "s"), smi))
    finally:
        shutil.rmtree(root, ignore_errors=True)
print(f"probes/mesh_compiled_phase.py: {time.perf_counter() - t0:.1f} s")
