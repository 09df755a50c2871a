"""The system under test, as the drivers reach it: the port's public facade
(``FCN8s``) and service (``InferenceService``, ``make_server``), built on
the benchmark's own weights, and the card's memory and synchronisation.
The only module of the harness besides the drivers that imports the port."""

from __future__ import annotations

import gc

import torch

from . import weights


def model(cfg: dict, seed: int, device: str, width: dict | None = None, mesh=None):
    """``FCN8s.from_params`` on the configuration's seeded weights, which
    seed the dropout draws too; the benchmark's tree is dropped after."""
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s

    if mesh is not None:
        device = mesh.device
    tree = weights.make_tree(cfg, seed, device, width)
    built = FCN8s.from_params(tree, compute_dtype=getattr(torch, cfg["compute_dtype"]),
                              device=device, seed=seed, mesh=mesh)
    del tree
    return built


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    device = torch.device(device)
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    """Release what the dropped program held before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

