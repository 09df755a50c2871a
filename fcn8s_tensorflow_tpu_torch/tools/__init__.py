"""Training-survival tools of the port, each runnable with ``python -m``.

Ports of the JAX package's ``benchmarks/endurance_canonical.py``,
``benchmarks/convergence_synthetic.py``, ``tools/multihost_fault_injection.py``
and ``tools/multihost_smoke.py``:

* ``synthetic``: numpy copies of the synthetic workloads (byte-equal);
* ``endurance_canonical``: the 13,000-step recipe with a SIGKILL, a resume,
  an uninterrupted comparator and a sha256 fingerprint of the whole state;
* ``convergence_synthetic``: the three variants learning a 6-class task;
* ``multihost_fault_injection``: a rank of a process group dies, the death
  is detected, the run resumes from its step-2 checkpoint bit-exactly;
* ``multihost_smoke``: process groups with global or sharded input.

Every tool defaults to ``--device cuda`` and raises without a card unless
given ``--device cpu``. The processes that train (the endurance and
fault-injection children, the smoke's ranks, the convergence run) call
``make_deterministic()`` before CUDA initialises; the facade itself never
does, so its defaults and speed stay as they are.
"""

from __future__ import annotations

import os

import torch

# cuBLAS needs a fixed workspace for run-to-run identical bytes
# (https://docs.nvidia.com/cuda/cublas/#results-reproducibility)
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def make_deterministic() -> None:
    """The switches that make two runs of this process's training give the
    same bytes on the card: a fixed cuBLAS workspace (read when CUDA
    initialises, so call this first), deterministic algorithms only (an op
    without one raises), cuDNN's deterministic algorithms and no per-process
    autotuning (``cudnn.benchmark`` may pick another algorithm each run)."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE_CONFIG
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _wrappers() -> dict:
    from ..ops import conv1_core, kernels, pool

    return {"maxpool2x2_nhwc": pool.maxpool2x2_nhwc,
            "maxpool2x2_code_nhwc": pool.maxpool2x2_code_nhwc,
            "maxpool2x2_bwd_nhwc": pool.maxpool2x2_bwd_nhwc,
            "ce_sum_per_sample": kernels.ce_sum_per_sample,
            "ce_sum_weighted": kernels.ce_sum_weighted,
            "ce_grad": kernels.ce_grad,
            "confusion_matrix_accumulate": kernels.confusion_matrix_accumulate,
            "conv1_core": conv1_core.conv1_core}


def launch_counts() -> dict:
    """Each CUDA kernel wrapper's launch count in this process (the plain
    twins that CPU tensors take count nothing)."""
    return {name: int(fn.launches) for name, fn in _wrappers().items()}


def initial_params(num_classes: int, width_mult: float, fc_channels: int) -> dict:
    """The port's fresh FCN-8s params (seed 0) as a JAX-layout numpy tree."""
    from .. import bridge
    from ..models.fcn8s import init_fcn8s

    tree = init_fcn8s(torch.Generator().manual_seed(0), num_classes, width_mult=width_mult,
                      fc_channels=fc_channels)
    return bridge.to_numpy(bridge.to_port(tree))


def save_tree(path: str, tree: dict) -> None:
    """A JAX-layout param tree ({part: {layer: {leaf: array}}}) as an npz."""
    import numpy as np

    np.savez(path, **{f"{p}/{n}/{k}": np.asarray(v) for p, layers in tree.items()
                      for n, layer in layers.items() for k, v in layer.items()})


def load_tree(path: str) -> dict:
    """``save_tree``'s file as a tree of numpy arrays."""
    import numpy as np

    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            part, name, leaf = key.split("/")
            tree.setdefault(part, {}).setdefault(name, {})[leaf] = z[key]
    return tree


def child_env() -> dict:
    """The environment of a tool's child process: this one's, with the
    repository on ``PYTHONPATH`` (children run with ``python -m``) and the
    cuBLAS workspace fixed before their CUDA initialises."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    return dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_WORKSPACE_CONFIG,
                PYTHONPATH=os.pathsep.join([root] + path))
