"""Weight bridge between the JAX param tree and the port's params.

The JAX tree (``fcn8s_tensorflow_tpu/models/fcn8s.py::init_fcn8s``) is
``{'encoder', 'decoder'}`` of ``{layer: {'kernel': HWIO, 'bias': (O,)}}``.
The port keeps the same nesting with torch tensors:

* a convolution layer holds ``weight`` (OIHW) and ``bias``;
* a deconv layer keeps its original ``kernel`` (2s, 2s, I, O) and ``bias``:
  the JAX parameter is what training differentiates;
* SegFormer's other leaves (``models/segformer.py``) keep their JAX key and
  layout: dense ``kernel`` s (``(in, out)``; the attention's query
  ``(C, heads, d)`` and output ``(heads, d, C)``), LayerNorm's and BatchNorm's ``scale``/``bias``, and the part
  ``batch_stats`` (BatchNorm's running ``mean``/``var``), which is state,
  not a parameter: ``param_leaves`` leaves it out and ``state_leaves``
  lists it.

These fp32 tensors are the masters. ``cast_params`` derives what the
forward reads: compute-dtype copies, and for each deconv the subpixel
weight (OIHW, 3x3, s*s*O outputs) and repeated bias. Under autograd the
derivation is part of the graph, as JAX's ``conv2d_transpose_subpixel``
derives its kernel on every call; the facade caches one derivation for
inference and rebuilds it after training.

``to_port`` and ``to_numpy`` round-trip exactly: the conversions are
transposes of fp32 values. ``to_port_shards`` carries a JAX tree onto a
mesh rank: its blocks of the port params. ``quantized_to_port`` takes the JAX package's
int8 tree (``ops/quantize.py::quantize_fcn8s_params``) the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.subpixel import subpixel_weight


STATE_PART = "batch_stats"  # the tree part that holds state, not parameters
_KEY_ORDER = ("kernel", "weight", "scale", "bias", "mean", "var")


def _is_deconv(name: str) -> bool:
    return name.endswith("_deconv")


def _is_conv_kernel(name: str, key: str, t) -> bool:
    """A convolution's HWIO ``kernel`` (OIHW ``weight`` in the port)."""
    return key == "kernel" and len(t.shape) == 4 and not _is_deconv(name)


def _ordered(layer: dict) -> list:
    """A layer's keys, the kernel first and the bias after the scale, as
    the port orders its leaves whatever order the tree came in."""
    return sorted(layer, key=lambda k: _KEY_ORDER.index(k) if k in _KEY_ORDER else len(_KEY_ORDER))


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
            entry = {}
            for key in _ordered(layer):
                t = _fp32_copy(layer[key])
                if _is_conv_kernel(name, key, t):
                    entry["weight"] = t.permute(3, 2, 0, 1).contiguous()
                else:
                    entry[key] = t
            out[part][name] = {k: v.to(device) for k, v in entry.items()}
    return out


def to_port_shards(tree: dict, mesh, *, tensor_parallel: bool = False) -> dict:
    """A JAX-layout tree -> this rank's blocks of the port params on
    ``mesh.device``: ``to_port``, then ``parallel.mesh.shard_params`` (fc6
    and fc7 split over 'model' under ``tensor_parallel``)."""
    from .parallel.mesh import shard_params

    return {part: {name: {k: t.to(mesh.device) for k, t in layer.items()}
                   for name, layer in layers.items()}
            for part, layers in shard_params(to_port(tree), mesh, tensor_parallel).items()}


def to_numpy(params: dict) -> dict:
    """Port params -> the JAX-layout tree of fp32 numpy arrays: copies, so
    a later in-place optimizer step does not move them (``.numpy()`` of a
    CPU tensor shares its memory)."""
    tree = {}
    for part, layers in params.items():
        tree[part] = {}
        for name, layer in layers.items():
            tree[part][name] = {}
            for key, t in layer.items():
                if key == "weight":
                    key, t = "kernel", t.permute(2, 3, 1, 0)
                tree[part][name][key] = np.array(t.detach().float().cpu().numpy(), order="C")
    return tree


def trainable(params: dict) -> dict:
    """The tree without its state part: what the optimizer trains."""
    return {part: layers for part, layers in params.items() if part != STATE_PART}


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The master tensors of a port tree, in one fixed order (the order of
    the gradients ``parallel.steps`` computes); BatchNorm's running
    statistics are not among them (``state_leaves``)."""
    return [t for layers in trainable(params).values() for layer in layers.values()
            for t in layer.values()]


def state_leaves(params: dict) -> list[torch.Tensor]:
    """The tree's state that the train step updates in place without a
    gradient (BatchNorm's running statistics; none in an FCN tree)."""
    return [t for layer in params.get(STATE_PART, {}).values() for t in layer.values()]


def _paths(params: dict) -> list[str]:
    return [f"{part}/{name}/{'kernel' if key == 'weight' else key}"
            for part, layers in params.items() for name, layer in layers.items() for key in layer]


def jax_leaf_paths(params: dict) -> list[str]:
    """The JAX tree path (``'encoder/conv1_1/kernel'``) of each tensor of
    ``param_leaves(params)``, in that order."""
    return _paths(trainable(params))


def state_paths(params: dict) -> list[str]:
    """The JAX tree path of each tensor of ``state_leaves(params)``."""
    return _paths({STATE_PART: params[STATE_PART]}) if STATE_PART in params else []


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
    return t.permute(2, 3, 1, 0) if _is_conv_kernel(name, key, t) else t


def leaf_from_jax(t: torch.Tensor, path: str) -> torch.Tensor:
    """Inverse of ``leaf_to_jax``: a contiguous tensor in the port's layout."""
    _, name, key = path.split("/")
    if _is_conv_kernel(name, key, t):
        t = t.permute(3, 2, 0, 1)
    return t.contiguous()


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """The tensors the forward reads, in ``dtype``, with 4-D weights in
    channels_last memory (what cuDNN takes with channels_last activations):
    convolutions' ``weight``/``bias``, deconvs' ``subpixel_weight``/
    ``subpixel_bias`` derived from ``kernel``/``bias``; SegFormer's dense
    ``kernel`` s too, while its LayerNorm and BatchNorm leaves (those with a
    ``scale``) stay the fp32 masters and its ``batch_stats`` are the
    masters' own tensors, which a training-mode forward updates in place.
    Differentiable with respect to the masters when autograd records it;
    the forward's own casts are then no-ops."""
    out = {}
    for part, layers in params.items():
        if part == STATE_PART:
            out[part] = layers
            continue
        out[part] = {}
        for name, layer in layers.items():
            if _is_deconv(name):
                stride = layer["kernel"].shape[0] // 2
                w, b = subpixel_weight(layer["kernel"], layer["bias"], stride)
                derived = {"subpixel_weight": w, "subpixel_bias": b}
            else:
                derived = layer
            out[part][name] = {}
            for k, t in derived.items():
                t = t.to(torch.float32 if "scale" in layer else dtype)
                out[part][name][k] = (t.contiguous(memory_format=torch.channels_last)
                                      if t.dim() == 4 else t)
    return out


def cast_into(run: dict | None, params: dict) -> bool:
    """Write ``cast_params(params, dtype)`` into the tensors of ``run`` (a
    cast of ``params`` made before, in ``dtype``) in place, as one
    multi-tensor copy, where every leaf's cast is its master in another
    dtype or memory format: no deconv (its subpixel form is derived) and
    ``run`` of ``params``' keys and shapes. Returns False, having written
    nothing, otherwise. Same bits as a new cast (``copy_`` rounds as
    ``to`` does), without allocating one."""
    if run is None or run.keys() != params.keys():
        return False
    dst, src = [], []
    for part, layers in params.items():
        if run[part].keys() != layers.keys():
            return False
        for name, layer in layers.items():
            if _is_deconv(name) or run[part][name].keys() != layer.keys():
                return False
            for key, t in layer.items():
                r = run[part][name][key]
                if r.shape != t.shape:
                    return False
                if r is not t:
                    dst.append(r)
                    src.append(t)
    with torch.inference_mode():  # ``run`` may have been made there
        torch._foreach_copy_(dst, src)
    return True


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
