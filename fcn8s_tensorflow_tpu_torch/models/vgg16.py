"""Convolutionalized VGG-16 encoder. Port of ``fcn8s_tensorflow_tpu/models/vgg16.py``.

13 conv3x3+ReLU layers in 5 blocks, each block closed by a 2x2/s2 max pool
(``ops/pool.py``: K4f, or the K4a/K4b pair under autograd), then fc6 as a
7x7 SAME conv and fc7 as a 1x1 conv, each with ReLU and dropout. Exposes
(pool3, pool4, fc7) at strides 8/16/32. ``remat`` wraps each conv block and
the head in ``torch.utils.checkpoint``, as ``jax.checkpoint`` does.

On a mesh (``parallel/mesh.py``) with tensor parallelism, fc6 and fc7 run
on this rank's shards in the Megatron pairing: fc6 column-parallel behind
``copy_to_model``, fc7 row-parallel, its partial sums reduced over 'model'
in fp32 (``reduce_from_model``) before its bias and the cast, so fc7 keeps
the fp32 accumulation of the whole layer.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.nn import conv2d, dropout, dropout_mask, nchw, nhwc
from ..ops.pool import maxpool2x2
from ..parallel.collectives import copy_to_model, reduce_from_model
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from .initializers import he_normal

# (name, in_ch, out_ch) per conv layer; a pool follows each block's last conv
VGG16_CONV_LAYERS = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
]
_BLOCK_ENDS = {"conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"}

FC6_KERNEL = (7, 7, 512, 4096)
FC7_KERNEL = (1, 1, 4096, 4096)

VGG_MEAN_RGB = (123.68, 116.779, 103.939)


def init_vgg16(gen: torch.Generator, *, width_mult: float = 1.0,
               fc_channels: int | None = None) -> dict:
    """Fresh encoder params in the JAX tree layout (HWIO kernels, zero
    biases, fp32, CPU); ``bridge.to_port`` turns them into port params.
    ``width_mult``/``fc_channels`` scale the widths as in the JAX package."""

    def scale(ch: int) -> int:
        return max(8, int(ch * width_mult)) if width_mult != 1.0 else ch

    fc_ch = fc_channels if fc_channels is not None else scale(FC6_KERNEL[-1])
    params = {}
    for name, in_ch, out_ch in VGG16_CONV_LAYERS:
        in_ch = 3 if in_ch == 3 else scale(in_ch)
        params[name] = {"kernel": he_normal(gen, (3, 3, in_ch, scale(out_ch))),
                        "bias": torch.zeros(scale(out_ch))}
    params["fc6"] = {"kernel": he_normal(gen, (7, 7, scale(FC6_KERNEL[2]), fc_ch)),
                     "bias": torch.zeros(fc_ch)}
    params["fc7"] = {"kernel": he_normal(gen, (1, 1, fc_ch, fc_ch)),
                     "bias": torch.zeros(fc_ch)}
    return params


def _blocks() -> list[list[str]]:
    """The conv layer names grouped into the five pooled blocks."""
    blocks = [[]]
    for name, _, _ in VGG16_CONV_LAYERS:
        blocks[-1].append(name)
        if name in _BLOCK_ENDS:
            blocks.append([])
    return blocks[:-1]


def _run_block(names, x, *weights):
    for i in range(len(names)):
        x = torch.relu_(conv2d(x, weights[2 * i], weights[2 * i + 1]))
    return maxpool2x2(x)


def _run_head(masks, keep_prob, x, w6, b6, w7, b7):
    x = dropout(torch.relu_(conv2d(x, w6, b6)), keep_prob, masks[0])
    return dropout(torch.relu_(conv2d(x, w7, b7)), keep_prob, masks[1])


def _run_head_tp(mesh, masks, keep_prob, x, w6, b6, w7, b7):
    """The head on this rank's shards: fc6's output-channel block, then
    fc7's partial product over that block (a 1x1 conv is a matmul over
    channels), summed over 'model' in fp32, plus the bias, cast once."""
    x = dropout(torch.relu_(conv2d(copy_to_model(x, mesh), w6, b6)), keep_prob, masks[0])
    n, c, h, w = x.shape
    part = nhwc(x).reshape(-1, c).float() @ w7.reshape(w7.shape[0], c).float().t()
    y = (reduce_from_model(part, mesh) + b7.float()).to(x.dtype)
    y = nchw(y.reshape(n, h, w, w7.shape[0]))
    return dropout(torch.relu_(y), keep_prob, masks[1])


def _head_masks(x, c6: int, c7: int, keep_prob: float, generator, mesh, tp: bool):
    """fc6's and fc7's dropout keep-masks, drawn in that order from
    ``generator``. On a mesh the draw covers the whole global batch and
    both whole layers, and the rank keeps its block: its data position's
    rows, and fc6's channel shard under tensor parallelism (``c6`` is the
    local channel count). So every mesh shape applies the masks of the
    single-card step, and the ranks of one 'model' group, which hold the
    same rows, apply the same replicated fc7 mask."""
    n, _, h, w = x.shape
    if mesh is None:
        return (dropout_mask((n, c6, h, w), keep_prob, generator),
                dropout_mask((n, c7, h, w), keep_prob, generator))
    d, i = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    m6, j = (mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]) if tp else (1, 0)
    full6 = dropout_mask((n * d, c6 * m6, h, w), keep_prob, generator)
    full7 = dropout_mask((n * d, c7, h, w), keep_prob, generator)
    return (full6[i * n:(i + 1) * n, j * c6:(j + 1) * c6], full7[i * n:(i + 1) * n])


def apply_vgg16(params: dict, images: torch.Tensor, *, keep_prob: float = 1.0,
                generator: torch.Generator | None = None, deterministic: bool = True,
                compute_dtype=torch.bfloat16, normalize: bool = True, remat: bool = False,
                mesh=None, tensor_parallel: bool = False):
    """Run the encoder on NHWC ``images`` (float or uint8 in [0, 255], H and
    W divisible by 32): mean-RGB subtraction in fp32 (skipped with
    ``normalize=False``), then the cast to ``compute_dtype``. Returns
    ``(pool3, pool4, fc7)`` as NCHW-shaped channels_last tensors (NHWC
    memory) in ``compute_dtype``.

    ``deterministic=False`` applies dropout at ``keep_prob`` after fc6 and
    fc7 with masks drawn from ``generator`` (required then) before the head
    runs, so a recomputed head (``remat=True``) applies the same masks.
    ``remat`` checkpoints each block and the head: the backward recomputes
    their activations instead of keeping them.

    ``mesh``: this rank's position when ``images`` are its rows of a batch
    split over 'data' (``parallel.mesh.batch_rows``), for the dropout draw
    (``_head_masks``); with ``tensor_parallel`` and a >1 'model' axis,
    ``params`` hold this rank's fc6/fc7 shards (``parallel.mesh.shard_params``)
    and the head runs tensor-parallel (``_run_head_tp``). A (1, 1) mesh is
    no mesh."""
    if not deterministic and generator is None:
        raise ValueError("apply_vgg16: a generator is required when deterministic=False")
    if mesh is not None and mesh.size == 1:
        mesh = None
    x = images.float()
    if normalize:
        x = x - torch.tensor(VGG_MEAN_RGB, dtype=torch.float32, device=images.device)
    x = nchw(x.to(compute_dtype).contiguous())

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    pool3 = pool4 = None
    for names in _blocks():
        weights = [t for name in names for t in (params[name]["weight"], params[name]["bias"])]
        x = run(partial(_run_block, names), x, *weights)
        if names[-1] == "conv3_3":
            pool3 = x
        elif names[-1] == "conv4_3":
            pool4 = x
    fc6, fc7 = params["fc6"], params["fc7"]
    tp = mesh is not None and mesh.tensor_parallel(tensor_parallel)
    masks = (None, None)
    if not deterministic and keep_prob < 1.0:
        masks = _head_masks(x, fc6["weight"].shape[0], fc7["weight"].shape[0], keep_prob,
                            generator, mesh, tp)
    head = partial(_run_head_tp, mesh) if tp else _run_head
    x = run(partial(head, masks, keep_prob if not deterministic else 1.0), x,
            fc6["weight"], fc6["bias"], fc7["weight"], fc7["bias"])
    return pool3, pool4, x
