"""The port's measurement scripts, each runnable with ``python -m``:

* ``bench``: the headline train step (batch 8 x 1024x512, bf16, TF1 Adam)
  and the predict rows (batch-1 p50 and its breakdown, batched, int8,
  overlay), one JSON line;
* ``pallas_pool_bench``: the hand pool pair (K4a + K4b) against
  ``F.max_pool2d`` at pool1's shape, alone and inside the train step;
* ``profile_train_step``: the device-time ranking of a few train steps
  from a ``torch.profiler`` Chrome trace;
* ``device_augment_bench``, ``ignore_label_bench``: the step with device
  augmentation, and with ``ignore_label`` (masked and dense), against the
  plain step;
* ``overlay_bench``: four on-card overlay formulations, bit-identical;
* ``int8_wgrad_bench``: fc6's weight gradient in bf16 and in int8;
* ``int8_closed_loop``: bf16 against int8 mIoU through ``score_benchmark``;
* ``e2e_input_bench``, ``packed_input_bench``: ``FCN8s.train`` through four
  feeders, and the host PNG and packed readers alone.

Ports of the JAX package's ``bench.py`` and ``benchmarks/`` with their
constants, workloads, flags, printed tables and JSON keys, plus
``--device`` (default ``cuda``; without a card a script raises and names
``--device cpu``; ``packed_input_bench`` runs on the host alone). Each
``main(argv)`` also returns what it printed, as a dict.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

# init_fcn8s's width arguments for every script's model: {} is VGG-16's
# full width (the scripts' workload); the CPU tests narrow it
MODEL: dict = {}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def fresh_params(num_classes: int, device) -> dict:
    """Fresh fp32 FCN-8s masters (seed 0, ``MODEL``'s width) on ``device``."""
    from .. import bridge
    from ..models.fcn8s import init_fcn8s

    return bridge.to_port(init_fcn8s(torch.Generator().manual_seed(0), num_classes, **MODEL),
                          device=device)


def fresh_state(num_classes: int, device, optimizer):
    """A step-0 ``TrainState`` over ``fresh_params``."""
    from ..parallel.steps import create_train_state

    return create_train_state(fresh_params(num_classes, device), optimizer)


def to_device(device, *arrays) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    """The card's name, or ``cpu``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def first_element(t: torch.Tensor):
    """One element of ``t`` on the host: a sync that moves no payload."""
    return t.reshape(-1)[:1].cpu()
