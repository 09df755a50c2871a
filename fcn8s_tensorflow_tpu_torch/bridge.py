"""Weight bridge between the JAX param tree and the port's params.

The JAX tree (``fcn8s_tensorflow_tpu/models/fcn8s.py::init_fcn8s``) is
``{'encoder', 'decoder'}`` of ``{layer: {'kernel': HWIO, 'bias': (O,)}}``.
The port keeps the same nesting with torch tensors:

* a convolution layer holds ``weight`` (OIHW) and ``bias``;
* a deconv layer keeps its original ``kernel`` (2s, 2s, I, O) and ``bias``:
  the JAX parameter is what training differentiates.

These fp32 tensors are the masters. ``cast_params`` derives what the
forward reads: compute-dtype copies, and for each deconv the subpixel
weight (OIHW, 3x3, s*s*O outputs) and repeated bias. Under autograd the
derivation is part of the graph, as JAX's ``conv2d_transpose_subpixel``
derives its kernel on every call; the facade caches one derivation for
inference and rebuilds it after training.

``to_port`` and ``to_numpy`` round-trip exactly: the conversions are
transposes of fp32 values.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.subpixel import subpixel_weight


def _is_deconv(name: str) -> bool:
    return name.endswith("_deconv")


def to_port(tree: dict, *, device="cpu") -> dict:
    """JAX-layout tree of numpy arrays or tensors -> port params (fp32, on
    ``device``)."""
    out = {}
    for part, layers in tree.items():
        out[part] = {}
        for name, layer in layers.items():
            kernel = torch.from_numpy(np.array(layer["kernel"], dtype=np.float32))
            bias = torch.from_numpy(np.array(layer["bias"], dtype=np.float32))
            if _is_deconv(name):
                entry = {"kernel": kernel, "bias": bias}
            else:
                entry = {"weight": kernel.permute(3, 2, 0, 1).contiguous(), "bias": bias}
            out[part][name] = {k: v.to(device) for k, v in entry.items()}
    return out


def to_numpy(params: dict) -> dict:
    """Port params -> the JAX-layout tree of fp32 numpy arrays."""
    tree = {}
    for part, layers in params.items():
        tree[part] = {}
        for name, layer in layers.items():
            if _is_deconv(name):
                kernel = layer["kernel"]
            else:
                kernel = layer["weight"].permute(2, 3, 1, 0)
            tree[part][name] = {
                "kernel": np.ascontiguousarray(kernel.detach().float().cpu().numpy()),
                "bias": layer["bias"].detach().float().cpu().numpy(),
            }
    return tree


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The master tensors of a port tree, in one fixed order (the order of
    the gradients ``parallel.steps`` computes)."""
    return [t for layers in params.values() for layer in layers.values() for t in layer.values()]


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """The tensors the forward reads, in ``dtype``, with 4-D weights in
    channels_last memory (what cuDNN takes with channels_last activations):
    convolutions' ``weight``/``bias``, deconvs' ``subpixel_weight``/
    ``subpixel_bias`` derived from ``kernel``/``bias``. Differentiable with
    respect to the masters when autograd records it; the forward's own
    casts are then no-ops."""
    out = {}
    for part, layers in params.items():
        out[part] = {}
        for name, layer in layers.items():
            if _is_deconv(name):
                stride = layer["kernel"].shape[0] // 2
                w, b = subpixel_weight(layer["kernel"], layer["bias"], stride)
                derived = {"subpixel_weight": w, "subpixel_bias": b}
            else:
                derived = {"weight": layer["weight"], "bias": layer["bias"]}
            out[part][name] = {}
            for k, t in derived.items():
                t = t.to(dtype)
                out[part][name][k] = (t.contiguous(memory_format=torch.channels_last)
                                      if t.dim() == 4 else t)
    return out
