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
* ``serve_results``: the browser viewer over a Cityscapes tree.

Ports of the JAX package's ``examples/``, with its flags, defaults, outputs
and printed summaries, plus ``--device`` (default ``cuda``; without a card
a script raises and names ``--device cpu``).
"""

from __future__ import annotations


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
