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
transposes of fp32 values. ``quantized_to_port`` takes the JAX package's
int8 tree (``ops/quantize.py::quantize_fcn8s_params``) the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.subpixel import subpixel_weight


def _is_deconv(name: str) -> bool:
    return name.endswith("_deconv")


def _fp32_copy(x) -> torch.Tensor:
    """A CPU fp32 tensor that owns its memory, from an array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def to_port(tree: dict, *, device="cpu") -> dict:
    """JAX-layout tree of numpy arrays or tensors -> port params (fp32, on
    ``device``, copies of the tree's leaves)."""
    out = {}
    for part, layers in tree.items():
        out[part] = {}
        for name, layer in layers.items():
            kernel = _fp32_copy(layer["kernel"])
            bias = _fp32_copy(layer["bias"])
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


def jax_leaf_paths(params: dict) -> list[str]:
    """The JAX tree path (``'encoder/conv1_1/kernel'``) of each tensor of
    ``param_leaves(params)``, in that order."""
    return [f"{part}/{name}/{'bias' if key == 'bias' else 'kernel'}"
            for part, layers in params.items() for name, layer in layers.items() for key in layer]


def jax_order(params: dict) -> list[int]:
    """Indices into ``param_leaves(params)`` in the JAX package's flatten
    order: keys sorted at every level (``decoder`` before ``encoder``,
    ``bias`` before ``kernel``), which is the order of a checkpoint's
    leaves."""
    paths = jax_leaf_paths(params)
    return sorted(range(len(paths)), key=lambda i: paths[i].split("/"))


def leaf_to_jax(t: torch.Tensor, path: str) -> torch.Tensor:
    """A leaf of the port's tree (or a tensor shaped like it, e.g. an Adam
    moment) in the JAX layout of ``path``: a view, OIHW -> HWIO for a
    convolution's kernel, as it is otherwise."""
    _, name, key = path.split("/")
    return t.permute(2, 3, 1, 0) if key == "kernel" and not _is_deconv(name) else t


def leaf_from_jax(t: torch.Tensor, path: str) -> torch.Tensor:
    """Inverse of ``leaf_to_jax``: a contiguous tensor in the port's layout."""
    _, name, key = path.split("/")
    if key == "kernel" and not _is_deconv(name):
        t = t.permute(3, 2, 0, 1)
    return t.contiguous()


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


def quantized_to_port(qtree: dict, compute_dtype: torch.dtype = torch.bfloat16, *,
                      device="cpu") -> dict:
    """The JAX package's ``quantize_fcn8s_params`` tree (numpy arrays: HWIO
    int8 ``kernel_q``, fp32 ``scale`` and ``bias``, optional ``act_scale``
    per encoder layer; the fp32 decoder) -> the port's quantized tree
    (``ops/quantize.py``) on ``device``, the decoder cast as the forward
    reads it. The int8 values are taken as they are, not requantized."""
    from .ops.quantize import quantized_layer

    encoder = {}
    for name, layer in qtree["encoder_q"].items():
        kernel = torch.from_numpy(np.array(layer["kernel_q"], np.int8)).permute(3, 0, 1, 2)
        act = layer.get("act_scale")
        encoder[name] = quantized_layer(
            kernel.to(device), _fp32_copy(layer["scale"]).to(device),
            _fp32_copy(layer["bias"]).to(device),
            None if act is None else _fp32_copy(act).to(device))
    decoder = cast_params(to_port({"decoder": qtree["decoder"]}, device=device),
                          compute_dtype)["decoder"]
    return {"encoder_q": encoder, "decoder": decoder}
