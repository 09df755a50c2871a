"""Seeded weights of a SegFormer configuration, made on the device in one
draw.

The tree is the JAX layout that the port's ``FCN8s.from_params`` takes and
the plain reference (``reference/segformer.py``) reads: ``{'encoder',
'decoder', 'batch_stats'}`` of ``{layer: {key: tensor}}``, convolution
kernels HWIO, dense kernels ``(in, out)`` (the query ``(C, heads, d)``, the
attention's output ``(heads, d, C)``, keys and values one ``(C, 2C)``), all
fp32 (the configuration's master dtype). Every random kernel is a view of
one ``torch.randn`` over their whole count, scaled as the configuration's
``init`` says: dense kernels of std 0.02 (NVlabs' truncated normal, here
untruncated), convolutions of std ``sqrt(2 / fan_out)`` (NVlabs' and mmcv's
for the fuse), the class prediction of std ``sqrt(2 / embed)``, which
spreads the random-weight logits over a unit, so each pixel's loss depends
on its label. LayerNorm and BatchNorm scales are one, every bias zero,
BatchNorm's running mean zero and variance one. The same seed gives the
same bytes on the same device type.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .weights import WEIGHT_STREAM, sub_seed


def layer_specs(cfg: dict) -> list[tuple]:
    """``(part, name, kind, shape, std)`` of every layer in forward order:
    ``kind`` 'dense' or 'conv' (a random ``kernel``, a zero ``bias`` where
    the layer has one), 'norm' (``scale`` one, ``bias`` zero)."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    embed = dec["embed_dim"]
    specs, cin = [], 3

    def conv(part, name, k, ci, co, groups=1, bias=True, std=None):
        std = math.sqrt(2.0 / (k * k * co // groups)) if std is None else std
        specs.append((part, name, "conv" if bias else "conv_nobias", (k, k, ci // groups, co), std))

    for i, (c, h, depth, sr, (k, _)) in enumerate(
            zip(enc["widths"], enc["heads"], enc["depths"], enc["sr_ratios"], enc["patches"]),
            start=1):
        conv("encoder", f"patch_embed{i}", k, cin, c)
        specs.append(("encoder", f"patch_embed{i}_norm", "norm", (c,), None))
        d, hidden = c // h, c * enc["mlp_ratio"]
        for j in range(depth):
            b = f"block{i}_{j}_"
            specs.append(("encoder", b + "norm1", "norm", (c,), None))
            specs.append(("encoder", b + "q", "dense", (c, h, d), 0.02))
            specs.append(("encoder", b + "kv", "dense", (c, 2 * c), 0.02))
            if sr > 1:
                conv("encoder", b + "sr", sr, c, c)
                specs.append(("encoder", b + "sr_norm", "norm", (c,), None))
            specs.append(("encoder", b + "proj", "dense", (h, d, c), 0.02))
            specs.append(("encoder", b + "norm2", "norm", (c,), None))
            specs.append(("encoder", b + "fc1", "dense", (c, hidden), 0.02))
            conv("encoder", b + "dwconv", 3, hidden, hidden, groups=hidden)
            specs.append(("encoder", b + "fc2", "dense", (hidden, c), 0.02))
        specs.append(("encoder", f"norm{i}", "norm", (c,), None))
        cin = c
    for i, c in enumerate(enc["widths"], start=1):
        specs.append(("decoder", f"linear_c{i}", "dense", (c, embed), 0.02))
    conv("decoder", "linear_fuse", 1, len(enc["widths"]) * embed, embed, bias=False)
    specs.append(("decoder", "linear_fuse_bn", "norm", (embed,), None))
    conv("decoder", "linear_pred", 1, embed, cfg["num_classes"], std=math.sqrt(2.0 / embed))
    return specs


def _bias_shape(name: str, shape: tuple) -> tuple:
    """The query's bias is ``(heads, d)``; every other layer's its outputs'."""
    return shape[1:] if name.endswith("_q") else (shape[-1],)


def make_tree(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights from ``seed`` on ``device`` (one draw)."""
    specs = layer_specs(cfg)
    sizes = [int(np.prod(shape)) if kind != "norm" else 0 for _, _, kind, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHT_STREAM))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    f32 = dict(device=device, dtype=torch.float32)
    tree, offset = {"encoder": {}, "decoder": {}}, 0
    for (part, name, kind, shape, std), size in zip(specs, sizes):
        if kind == "norm":
            tree[part][name] = {"scale": torch.ones(shape, **f32),
                                "bias": torch.zeros(shape, **f32)}
            continue
        layer = {"kernel": flat[offset:offset + size].view(shape).mul_(std)}
        offset += size
        if kind != "conv_nobias":
            layer["bias"] = torch.zeros(_bias_shape(name, shape), **f32)
        tree[part][name] = layer
    embed = cfg["decoder"]["embed_dim"]
    tree["batch_stats"] = {"linear_fuse_bn": {"mean": torch.zeros(embed, **f32),
                                              "var": torch.ones(embed, **f32)}}
    return tree
