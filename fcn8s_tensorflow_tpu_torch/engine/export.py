"""Serving artifacts via ``torch.export``.

Port of ``fcn8s_tensorflow_tpu/engine/export.py``. The JAX package
serializes its inference function as a StableHLO module (``jax.export``);
the port serializes ``parallel.steps.predict_step`` as a ``torch.export``
program next to a params-only checkpoint. As in JAX, the params are the
program's inputs, not constants baked into it, so the program file holds
the graph alone and the weights stay in the checkpoint format both
packages read. The batch dimension is exported symbolically: ONE artifact
serves every batch size. H/W are static: resize or tile on the host to the
exported resolution.

Artifact layout::

    <dir>/forward.pt2     torch.export program: f(params, uint8 NHWC images)
    <dir>/params/         params-only checkpoint (engine/checkpoint.py format)
    <dir>/manifest.json   the JAX package's keys, plus "format":
                          "torch.export" and the device it was traced on

The program calls the K4f pool as the registered op
``fcn8s_torch::maxpool2x2_nhwc`` (``ops/pool.py``), so a loader needs the
port's op registrations, not its model code: ``load_serving_artifact``
imports ``ops.pool`` before ``torch.export.load``. The program holds the
tracing device in its constants (the VGG mean), so it runs on that device:
loading it on another raises and names both.

Produce with ``FCN8s.export_serving(dir)`` (or ``export_serving_artifact``),
consume with ``load_serving_artifact(dir).predict(images)``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import bridge
from ..kernels import resolve_device
from ..parallel import collectives
from . import checkpoint as ckpt

ARTIFACT_VERSION = 1
ARTIFACT_FORMAT = "torch.export"
_MANIFEST = "manifest.json"
_PROGRAM = "forward.pt2"
_JAX_PROGRAM = "forward.stablehlo"


class _PredictHead(torch.nn.Module):
    """``predict_step`` with its options fixed, as the module ``torch.export``
    traces; the params tree and the images are its inputs."""

    def __init__(self, argmax: bool, compute_dtype: torch.dtype, id_dtype: torch.dtype):
        super().__init__()
        self.argmax, self.compute_dtype, self.id_dtype = argmax, compute_dtype, id_dtype

    def forward(self, params: dict, images: torch.Tensor) -> torch.Tensor:
        from ..parallel.steps import predict_step

        return predict_step(params, images, argmax=self.argmax,
                            compute_dtype=self.compute_dtype, id_dtype=self.id_dtype)


def _sorted_tree(tree):
    """``tree`` with the keys of every dict in sorted order: the exported
    program matches its inputs' dict order, and a tree read from a
    checkpoint comes in the checkpoint's order."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def export_serving_artifact(model, directory: str, *, input_hw=(1024, 512),
                            argmax: bool = True, use_ema: bool = False) -> str:
    """Serialize ``model``'s inference head for ``input_hw`` inputs into
    ``directory``, traced on the model's device. ``argmax=True`` exports the
    class-id head (uint8 ids for <=255 classes), ``argmax=False`` the full
    softmax head. ``use_ema`` exports the EMA weight average instead of the
    live params. The batch dim is symbolic (traced at batch 2, so that it
    does not specialise to 1): the artifact accepts any N at load time.

    On a mesh every rank calls it: the params are gathered whole (the
    artifact is a single-device program), rank 0 traces and writes, and the
    others wait for it at a barrier."""
    h, w = int(input_hw[0]), int(input_hw[1])
    if h % 32 or w % 32:
        raise ValueError(f"input_hw must be divisible by 32, got {(h, w)}")
    masters = model._gather(model.ema_params if use_ema else model.params)
    if model._tp:
        run_params = bridge.cast_params(masters, model.compute_dtype)
    else:
        run_params = model._resolve_ema(True, False) if use_ema else model._run_params
    if model.mesh.is_writer:
        _write_artifact(model, directory, masters, _sorted_tree(run_params), h, w, argmax,
                        use_ema)
    collectives.barrier(model.mesh)
    return directory


def _write_artifact(model, directory, masters, run_params, h, w, argmax, use_ema) -> None:
    compact = argmax and model.num_classes <= 255
    head = _PredictHead(argmax, model.compute_dtype, torch.uint8 if compact else torch.int32)
    images = torch.zeros((2, h, w, 3), dtype=torch.uint8, device=model.device)
    static = {part: {name: dict.fromkeys(layer) for name, layer in layers.items()}
              for part, layers in run_params.items()}
    with torch.no_grad():
        program = torch.export.export(
            head, (run_params, images),
            dynamic_shapes=(static, {0: torch.export.Dim("batch", min=1)}))

    # the program keeps its example inputs, the params among them, and
    # saves them beside the graph; the params belong in params/ alone
    program.example_inputs = None
    os.makedirs(directory, exist_ok=True)
    torch.export.save(program, os.path.join(directory, _PROGRAM))
    ckpt.save_checkpoint(os.path.join(directory, "params"), masters,
                         {"model_config": model.model_config})
    manifest = {
        "artifact_version": ARTIFACT_VERSION,
        "format": ARTIFACT_FORMAT,
        "device": str(model.device),
        "input_hw": [h, w],
        "argmax": argmax,
        "id_dtype": "uint8" if compact else "int32",
        "num_classes": model.num_classes,
        "compute_dtype": str(model.compute_dtype).removeprefix("torch."),
        "ema": bool(use_ema),
        "model_config": model.model_config,
    }
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, default=str)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Equal devices, a CUDA device without an index being device 0."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class ServingArtifact:
    """A loaded ``torch.export`` serving artifact: ``predict(images)`` with
    the facade's output conventions (int32 argmax ids / float32 softmax)."""

    def __init__(self, directory: str, device="cuda"):
        manifest_path = os.path.join(directory, _MANIFEST)
        if not os.path.isfile(manifest_path):
            raise FileNotFoundError(
                f"'{directory}' is not a serving artifact (missing {_MANIFEST}).")
        with open(manifest_path) as f:
            self.manifest = json.load(f)
        version = self.manifest.get("artifact_version")
        if version != ARTIFACT_VERSION:
            raise ValueError(
                f"serving artifact at '{directory}' has artifact_version "
                f"{version}; this library reads version {ARTIFACT_VERSION}.")
        fmt = self.manifest.get("format")
        if fmt != ARTIFACT_FORMAT:
            found = (f"a jax.export StableHLO program ({_JAX_PROGRAM})"
                     if os.path.isfile(os.path.join(directory, _JAX_PROGRAM))
                     else f"format {fmt!r}")
            raise ValueError(
                f"serving artifact at '{directory}' holds {found}; this package loads "
                f"{ARTIFACT_FORMAT} artifacts ({_PROGRAM}): export one with "
                "fcn8s_tensorflow_tpu_torch's FCN8s.export_serving, or load this one with "
                "the JAX package's load_serving_artifact.")
        traced = torch.device(self.manifest["device"])
        if not _same_device(traced, torch.device(device)):
            raise ValueError(
                f"serving artifact at '{directory}' was traced on {traced} and runs there "
                f"only (its program holds constants on that device); asked for {device}: "
                f"export it on {device} instead.")
        self.device = resolve_device(device)
        from ..ops import pool  # noqa: F401  registers fcn8s_torch::maxpool2x2_nhwc

        self._program = torch.export.load(os.path.join(directory, _PROGRAM))
        self._forward = self._program.module()
        tree, _ = ckpt.load_params_tree(os.path.join(directory, "params"))
        compute_dtype = getattr(torch, self.manifest["compute_dtype"])
        with torch.no_grad():
            self.params = _sorted_tree(bridge.cast_params(
                bridge.to_port(tree, device=self.device), compute_dtype))
        self.input_hw = tuple(self.manifest["input_hw"])
        self.argmax = self.manifest["argmax"]
        self.num_classes = self.manifest["num_classes"]

    @torch.inference_mode()
    def predict(self, images) -> np.ndarray:
        """``images``: (N, H, W, 3) or (H, W, 3) uint8 at the exported
        resolution. Returns int32 class ids (argmax artifact) or float32
        class probabilities (softmax artifact)."""
        images = np.asarray(images, dtype=np.uint8)
        if images.ndim == 3:
            images = images[None]
        h, w = images.shape[1:3]
        if (h, w) != self.input_hw:
            raise ValueError(
                f"artifact was exported for {self.input_hw} inputs, got "
                f"{(h, w)} — resize or tile on the host first.")
        x = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type == "cuda":
            x = x.pin_memory()
        out = self._forward(self.params, x.to(self.device, non_blocking=True)).cpu().numpy()
        return out.astype(np.int32 if self.argmax else np.float32, copy=False)


def load_serving_artifact(directory: str, device="cuda") -> ServingArtifact:
    """Load an artifact of ``export_serving_artifact`` to run on ``device``
    (the card unless the caller asks for the CPU; it must be the device the
    artifact was traced on)."""
    return ServingArtifact(directory, device)
