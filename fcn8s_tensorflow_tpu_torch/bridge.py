"""Weight bridge between the JAX param tree and the port's params.

The JAX tree (``fcn8s_tensorflow_tpu/models/fcn8s.py::init_fcn8s``) is
``{'encoder', 'decoder'}`` of ``{layer: {'kernel': HWIO, 'bias': (O,)}}``.
The port keeps the same nesting with torch tensors:

* a convolution layer holds ``weight`` (OIHW) and ``bias``;
* a deconv layer keeps its original ``kernel`` (2s, 2s, I, O) and ``bias``,
  plus the derived ``subpixel_weight`` (OIHW, 3x3, s*s*O outputs) and
  ``subpixel_bias`` that the forward uses, computed here once.

``to_port`` and ``to_numpy`` round-trip exactly: the conversions are
transposes of fp32 values, and the derived subpixel tensors are dropped on
the way back.
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
                w, b = subpixel_weight(kernel, bias, kernel.shape[0] // 2)
                entry = {"kernel": kernel, "bias": bias, "subpixel_weight": w, "subpixel_bias": b}
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


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """The tensors the forward reads, in ``dtype``, with 4-D weights in
    channels_last memory (what cuDNN takes with channels_last activations).
    Made once per model, so the forward's own casts are no-ops."""
    out = {}
    for part, layers in params.items():
        out[part] = {}
        for name, layer in layers.items():
            keys = ("subpixel_weight", "subpixel_bias") if _is_deconv(name) else ("weight", "bias")
            out[part][name] = {}
            for k in keys:
                t = layer[k].to(dtype)
                out[part][name][k] = (t.contiguous(memory_format=torch.channels_last)
                                      if t.dim() == 4 else t)
    return out
