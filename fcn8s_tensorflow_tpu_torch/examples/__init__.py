"""The port's example scripts, each runnable with ``python -m``:

* ``quickstart_synthetic``: a synthetic dataset, a few train steps, an
  evaluation, overlays and a viewer gallery (no dataset needed);
* ``train_cityscapes``: the tutorial's Cityscapes recipe (``torchrun`` for
  a mesh: ``--tensor-parallel``);
* ``train_kitti``: KITTI road, two classes;
* ``offline_preprocessing``: a downscaled, trainId-remapped PNG mirror of
  Cityscapes, or its packed memmaps (``--packed``);
* ``benchmark_submission``: labelId PNGs from a checkpoint, scored by the
  offline Cityscapes scorer;
* ``serve_results``: the browser viewer over a Cityscapes tree;
* ``fcn8s_tutorial.ipynb``: the tutorial notebook (``run_notebook`` runs
  its code cells without Jupyter).

Ports of the JAX package's ``examples/``, with its flags, defaults, outputs
and printed summaries, plus ``--device`` (default ``cuda``; without a card
a script raises and names ``--device cpu``).
"""

from __future__ import annotations

import os


def add_device_argument(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; pass --device cpu to run on the host)")


def resolve(device: str):
    """The script's torch device; without a card, ``cuda`` raises naming
    ``--device cpu``."""
    from ..kernels import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as exc:
        raise RuntimeError(f"no CUDA device for --device {device}: pass --device cpu to run "
                           "on the host") from exc


NOTEBOOK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fcn8s_tutorial.ipynb")


def run_notebook(path: str = NOTEBOOK, overrides: dict | None = None) -> dict:
    """Run a notebook's code cells in order in one namespace, in this
    process and its working directory, and return the namespace.
    ``overrides`` are assigned into it after the first code cell (the
    settings cell), so that the later cells read them."""
    import json

    with open(path) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    namespace: dict = {"__name__": "__main__"}
    for i, cell in enumerate(cells):
        exec(compile("".join(cell["source"]), f"{path}:cell{i}", "exec"), namespace)
        if i == 0 and overrides:
            namespace.update(overrides)
    return namespace
