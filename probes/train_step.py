#!/usr/bin/env python3
"""Time the port's full-width train step on one CUDA card, for the port tree
at TREE (default: this checkout).

    python3 probes/train_step.py [TREE]

TREE may be an unpacked older commit of the port (see probes/ce_kernels.py),
so two versions are compared on one card in one call, in turns. The step is
bench.py's main config: batch 8 x 1024x512 x 3 uint8, 20 classes, bf16, TF1
Adam, keep_prob 0.5, random weights (seed 3) and data (seed 9). Prints one
JSON object: the host-clock step time (median and quartiles of 15, after 3
warm-up steps) and the backward alone (``torch.autograd.grad`` of the loss,
CUDA events, median and quartiles of 11).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                       else os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, TREE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.fcn8s import apply_fcn8s, decoder_l2_loss  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import kernels as K  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as S  # noqa: E402


def quartiles(xs) -> list:
    return [float(np.percentile(xs, q)) for q in (25, 50, 75)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe times the card")
    dev = torch.device("cuda", 0)
    model = FCN8s(num_classes=20, device=dev, seed=3)
    rng = np.random.default_rng(9)
    im = torch.from_numpy(rng.integers(0, 256, (8, 1024, 512, 3), dtype=np.uint8)).to(dev)
    lb = torch.from_numpy(rng.integers(0, 20, (8, 1024, 512), dtype=np.uint8)).to(dev)
    mask = torch.ones(8, device=dev)
    opt = model.optimizer
    state = S.create_train_state(model.params, opt)

    def step():
        S.train_step(state, im, lb, mask, 0, 1e-4, 0.0, 0.5, optimizer=opt, num_classes=20)

    for _ in range(3):
        step()
    steps = []
    for _ in range(15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    leaves = bridge.param_leaves(state.params)
    backward = []
    for i in range(12):
        run = bridge.cast_params(state.params, torch.bfloat16)
        logits = apply_fcn8s(run, im, keep_prob=0.5, deterministic=False,
                             generator=S.dropout_generator(dev, 0, state.step),
                             logits_dtype=torch.bfloat16)
        loss = K.softmax_cross_entropy(logits, lb, mask) + 0.0 * decoder_l2_loss(
            state.params["decoder"])
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        torch.autograd.grad(loss, leaves)
        b.record()
        torch.cuda.synchronize()
        if i:  # the first is a warm-up
            backward.append(a.elapsed_time(b))
        del run, logits, loss
    print(json.dumps({"tree": TREE, "device": torch.cuda.get_device_name(0),
                      "step_ms": statistics.median(steps), "step_q": quartiles(steps),
                      "backward_ms": statistics.median(backward),
                      "backward_q": quartiles(backward)}))


if __name__ == "__main__":
    main()
