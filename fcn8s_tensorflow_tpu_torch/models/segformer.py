"""SegFormer: a Mix-Transformer (MiT) encoder and the All-MLP head.

Xie et al., "SegFormer: Simple and Efficient Design for Semantic
Segmentation with Transformers" (arXiv:2105.15203), as NVlabs' code builds
it (``mmseg/models/backbones/mix_transformer.py``,
``mmseg/models/decode_heads/segformer_head.py``). Four stages, each an
overlapping patch embedding (a strided convolution, then LayerNorm), blocks
of ``x + DropPath(Attn(LN(x)))`` and ``x + DropPath(MixFFN(LN(x)))``, and a
closing LayerNorm. The attention is the efficient self-attention: keys and
values come from the tokens reduced by an ``R x R`` stride-``R`` convolution
and a LayerNorm (where ``R > 1``), and run through ``ops.nn.attention``
(``F.scaled_dot_product_attention``). Mix-FFN is ``Linear(C, 4C)``, a 3x3
depthwise convolution on the token grid, exact GELU, ``Linear(4C, C)``. The
head maps each stage's tokens to ``embed`` channels, upsamples stages 2-4 to
stride 4, concatenates ``[c4, c3, c2, c1]``, fuses them with a 1x1
convolution, BatchNorm and ReLU, applies channel dropout, predicts the
classes with a 1x1 convolution and upsamples the logits to the input.

The tree (``init_segformer``, the JAX layout that ``FCN8s.from_params``
takes) is ``{'encoder', 'decoder'}`` of ``{layer: {key: tensor}}``, plus
``'batch_stats'``, BatchNorm's running statistics, which the train step
updates in place and no optimizer touches. Convolution kernels are HWIO;
dense kernels ``(in, out)``, the attention's query as ``(C, heads, d)`` and
its output as ``(heads, d, C)``, so the head count is read from the tree
(keys and values are one ``(C, 2C)`` kernel, keys' columns first);
LayerNorm and BatchNorm hold ``scale``/``bias``. The stage layout is read from the keys and shapes
(``segformer_layout``); the model is told from an FCN tree by its head.

Precision: the residual stream and every normalisation run in fp32; the
linear layers, convolutions, attention, GELU and the resizes run in
``compute_dtype`` on its casts. Dropout (``keep_prob`` < 1) draws two
tensors from the step's generator, in this order: ``(B, 2 * blocks)``
uniforms for DropPath, block after block, the attention's column before the
Mix-FFN's, then ``(B, embed)`` uniforms for the head's channel dropout.
Block ``n`` of ``blocks`` keeps its sample with ``1 - (1 - keep_prob) * n /
(blocks - 1)`` (NVlabs' ``linspace(0, drop_path_rate, blocks)`` with
``drop_path_rate = 1 - keep_prob``), the head a channel with ``keep_prob``;
each kept value is scaled by one over its keep probability, all in fp32.
"""

from __future__ import annotations

import functools
import re
from collections import Counter

import torch

from ..ops.nn import (applies_dropout, attention, batch_norm, conv2d_strided, depthwise_conv3x3,
                      gelu, keep_mask, layer_norm, linear, nchw, nhwc, scale_kept,
                      upsample_bilinear)
from ..utils.profiling import annotate
from .initializers import truncated_normal

# MiT-B5 and its head, as published
B5 = dict(widths=(64, 128, 320, 512), heads=(1, 2, 5, 8), depths=(3, 6, 40, 3),
          sr_ratios=(8, 4, 2, 1), mlp_ratio=4, embed_dim=768)
PATCHES = ((7, 4), (3, 2), (3, 2), (3, 2))  # (kernel, stride) of each patch embedding
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
EMBED_LN_EPS = 1e-5  # the patch embeddings' and the spatial reductions' LayerNorm
BLOCK_LN_EPS = 1e-6  # the blocks' and the stages' closing LayerNorm
BN_EPS, BN_MOMENTUM = 1e-5, 0.1

_BLOCK = re.compile(r"block(\d+)_(\d+)_norm1$")


@functools.lru_cache(maxsize=None)
def imagenet_mean_std(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """ImageNet's mean and std as fp32 tensors on ``device``, made once per
    device (a copy made in a forward could not be captured in a graph)."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def is_segformer(params: dict) -> bool:
    """Whether a tree (JAX or port layout) is SegFormer's: its head."""
    return "linear_fuse" in params.get("decoder", {})


def segformer_layout(params: dict) -> list[dict]:
    """Each stage's ``depth``, ``heads``, ``head_dim``, ``sr`` (the spatial
    reduction ratio, 1 for none), ``kernel``, ``stride`` and ``width``, read
    from a port tree (or its compute-dtype cast)."""
    enc = params["encoder"]
    depths = Counter(int(m.group(1)) for m in map(_BLOCK.match, enc) if m)
    stages = []
    for i in range(1, len(depths) + 1):
        c, _, k, _ = enc[f"patch_embed{i}"]["weight"].shape
        _, heads, d = enc[f"block{i}_0_q"]["kernel"].shape
        sr = enc[f"block{i}_0_sr"]["weight"].shape[2] if f"block{i}_0_sr" in enc else 1
        stages.append(dict(depth=depths[i], heads=heads, head_dim=d, sr=sr, kernel=k,
                           stride=(k + 1) // 2, width=c))
    return stages


def init_segformer(gen: torch.Generator, num_classes: int, *, widths=B5["widths"],
                   heads=B5["heads"], depths=B5["depths"], sr_ratios=B5["sr_ratios"],
                   mlp_ratio: int = B5["mlp_ratio"], embed_dim: int = B5["embed_dim"]) -> dict:
    """Fresh params in the JAX layout (fp32, CPU), drawn from ``gen`` as
    NVlabs initialises them: dense kernels truncated normal of std 0.02,
    convolutions normal of std ``sqrt(2 / fan_out)``, norms one and zero,
    biases zero; the class prediction normal of std 0.01. BatchNorm's
    running statistics start at zero mean and unit variance."""
    def dense(shape):
        return {"kernel": truncated_normal(gen, shape, 0.02),
                "bias": torch.zeros(shape[-1] if len(shape) == 2 else shape[1:])}

    def conv(k, cin, cout, groups=1, bias=True, std=None):
        std = (2.0 / (k * k * cout // groups)) ** 0.5 if std is None else std
        out = {"kernel": torch.randn((k, k, cin // groups, cout), generator=gen) * std}
        if bias:
            out["bias"] = torch.zeros(cout)
        return out

    def norm(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c)}

    enc, cin = {}, 3
    for i, (c, h, depth, sr, (k, _)) in enumerate(
            zip(widths, heads, depths, sr_ratios, PATCHES), start=1):
        enc[f"patch_embed{i}"] = conv(k, cin, c)
        enc[f"patch_embed{i}_norm"] = norm(c)
        d, hidden = c // h, c * mlp_ratio
        for j in range(depth):
            b = f"block{i}_{j}_"
            enc[b + "norm1"] = norm(c)
            enc[b + "q"] = {"kernel": truncated_normal(gen, (c, h, d), 0.02),
                            "bias": torch.zeros(h, d)}
            enc[b + "kv"] = dense((c, 2 * c))
            if sr > 1:
                enc[b + "sr"] = conv(sr, c, c)
                enc[b + "sr_norm"] = norm(c)
            enc[b + "proj"] = {"kernel": truncated_normal(gen, (h, d, c), 0.02),
                               "bias": torch.zeros(c)}
            enc[b + "norm2"] = norm(c)
            enc[b + "fc1"] = dense((c, hidden))
            enc[b + "dwconv"] = conv(3, hidden, hidden, groups=hidden)
            enc[b + "fc2"] = dense((hidden, c))
        enc[f"norm{i}"] = norm(c)
        cin = c
    dec = {f"linear_c{i}": dense((c, embed_dim)) for i, c in enumerate(widths, start=1)}
    dec["linear_fuse"] = conv(1, len(widths) * embed_dim, embed_dim, bias=False)
    dec["linear_fuse_bn"] = norm(embed_dim)
    dec["linear_pred"] = conv(1, embed_dim, num_classes, std=0.01)
    stats = {"linear_fuse_bn": {"mean": torch.zeros(embed_dim), "var": torch.ones(embed_dim)}}
    return {"encoder": enc, "decoder": dec, "batch_stats": stats}


def _attention(p: dict, b: str, x: torch.Tensor, h: int, w: int, stage: dict) -> torch.Tensor:
    """Efficient self-attention of compute-dtype tokens ``x`` (B, N, C) on
    an ``h`` x ``w`` grid."""
    n_b, n, c = x.shape
    heads, d, sr = stage["heads"], stage["head_dim"], stage["sr"]
    q = linear(x, p[b + "q"]["kernel"].reshape(c, heads * d), p[b + "q"]["bias"].reshape(-1))
    q = q.view(n_b, n, heads, d).transpose(1, 2)
    if sr > 1:
        r = conv2d_strided(nchw(x.view(n_b, h, w, c)), p[b + "sr"]["weight"], p[b + "sr"]["bias"],
                           sr, 0)
        r = nhwc(r).reshape(n_b, -1, c)
        r = layer_norm(r, p[b + "sr_norm"]["scale"], p[b + "sr_norm"]["bias"], EMBED_LN_EPS)
    else:
        r = x
    m = r.shape[1]
    kv = linear(r, p[b + "kv"]["kernel"], p[b + "kv"]["bias"]).view(n_b, m, 2, heads, d)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    o = attention(q, k, v)
    o = o.transpose(1, 2).reshape(n_b, n, heads * d)
    return linear(o, p[b + "proj"]["kernel"].reshape(heads * d, c), p[b + "proj"]["bias"])


def _mix_ffn(p: dict, b: str, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n_b, n, _ = x.shape
    y = linear(x, p[b + "fc1"]["kernel"], p[b + "fc1"]["bias"])
    hidden = y.shape[-1]
    y = depthwise_conv3x3(nchw(y.view(n_b, h, w, hidden)), p[b + "dwconv"]["weight"],
                          p[b + "dwconv"]["bias"])
    y = gelu(nhwc(y).reshape(n_b, n, hidden))
    return linear(y, p[b + "fc2"]["kernel"], p[b + "fc2"]["bias"])


def _pointwise(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """A 1x1 convolution (OIHW ``weight``) on NHWC ``x`` as a linear layer."""
    o, i = layer["weight"].shape[:2]
    return linear(x, layer["weight"].reshape(o, i).t(), layer.get("bias"))


def _draws(n_b: int, blocks: int, embed: int, keep_prob, generator: torch.Generator):
    """The step's dropout masks and scales, in the module's draw order:
    DropPath's ``(B, 2 * blocks)`` and the head's ``(B, embed)``."""
    dev = generator.device
    u_path = torch.rand((n_b, 2 * blocks), generator=generator, device=dev)
    u_head = torch.rand((n_b, embed), generator=generator, device=dev)
    kp = torch.as_tensor(keep_prob, dtype=torch.float32, device=dev)
    fracs = torch.arange(blocks, dtype=torch.float32, device=dev) / max(blocks - 1, 1)
    keeps = (1.0 - (1.0 - kp) * fracs).repeat_interleave(2)
    return keep_mask(u_path, keeps), keep_mask(u_head, kp)


def apply_segformer(params: dict, images: torch.Tensor, *, keep_prob=1.0,
                    generator: torch.Generator | None = None, deterministic: bool = True,
                    compute_dtype=torch.bfloat16, normalize: bool = True,
                    logits_dtype=torch.float32, train_bn: bool = False) -> torch.Tensor:
    """NHWC uint8 (or float) ``images`` -> NHWC logits ``(N, H, W, C)`` in
    ``logits_dtype``, from the compute-dtype cast of a port tree
    (``bridge.cast_params``: LayerNorm and BatchNorm leaves stay fp32, the
    running statistics are the masters' own tensors). ``normalize``:
    ImageNet's mean and std in fp32 first. ``train_bn``: BatchNorm by the
    batch's statistics, its running statistics updated in place; otherwise
    by the running ones. Dropout as the module says, from ``generator``,
    unless ``deterministic`` or ``keep_prob`` >= 1. H and W must be
    multiples of 32. Each stage is the span ``segformer.stage<i>``, the
    head ``segformer.head``."""
    n_b, hh, ww = images.shape[:3]
    if hh % 32 or ww % 32:
        raise ValueError(f"SegFormer input must be a multiple of 32, got {(hh, ww)}")
    enc, dec = params["encoder"], params["decoder"]
    stages = segformer_layout(params)
    blocks = sum(s["depth"] for s in stages)
    embed = dec["linear_fuse"]["weight"].shape[0]
    drops = (not deterministic and generator is not None and applies_dropout(keep_prob))
    if drops:
        (path_mask, path_scale), (head_mask, head_scale) = _draws(
            n_b, blocks, embed, keep_prob, generator)
    x = images.float()
    if normalize:
        mean, std = imagenet_mean_std(x.device)
        x = (x - mean) / std
    x = nchw(x.to(compute_dtype))
    outs, n = [], 0
    for i, stage in enumerate(stages, start=1):
        with annotate(f"segformer.stage{i}"):
            x = conv2d_strided(x, enc[f"patch_embed{i}"]["weight"], enc[f"patch_embed{i}"]["bias"],
                               stage["stride"], stage["kernel"] // 2)
            h, w, c = x.shape[2], x.shape[3], x.shape[1]
            norm = enc[f"patch_embed{i}_norm"]
            x = layer_norm(nhwc(x).reshape(n_b, h * w, c), norm["scale"], norm["bias"],
                           EMBED_LN_EPS, torch.float32)
            for j in range(stage["depth"]):
                b = f"block{i}_{j}_"
                for k, branch in enumerate((_attention, _mix_ffn)):
                    norm = enc[b + ("norm1", "norm2")[k]]
                    y = layer_norm(x, norm["scale"], norm["bias"], BLOCK_LN_EPS, compute_dtype)
                    y = branch(enc, b, y, h, w, stage) if k == 0 else branch(enc, b, y, h, w)
                    if drops:
                        col = 2 * n + k
                        y = scale_kept(y, path_mask[:, col, None, None], path_scale[col])
                    x = x + y
                n += 1
            norm = enc[f"norm{i}"]
            x = layer_norm(x, norm["scale"], norm["bias"], BLOCK_LN_EPS, compute_dtype)
            outs.append((x, h, w))
            x = nchw(x.view(n_b, h, w, c))
    with annotate("segformer.head"):
        h1, w1 = outs[0][1], outs[0][2]
        feats = []
        for i in reversed(range(len(outs))):
            t, h, w = outs[i]
            y = linear(t, dec[f"linear_c{i + 1}"]["kernel"], dec[f"linear_c{i + 1}"]["bias"])
            y = y.view(n_b, h, w, embed)
            if i > 0:
                y = nhwc(upsample_bilinear(nchw(y), (h1, w1)))
            feats.append(y)
        y = _pointwise(torch.cat(feats, dim=-1), dec["linear_fuse"])
        bn, stats = dec["linear_fuse_bn"], params["batch_stats"]["linear_fuse_bn"]
        y = batch_norm(nchw(y), bn["scale"], bn["bias"], stats["mean"], stats["var"],
                       training=train_bn, momentum=BN_MOMENTUM, eps=BN_EPS)
        y = nhwc(torch.relu(y))
        if drops:
            y = scale_kept(y, head_mask[:, None, None, :], head_scale)
        y = _pointwise(y, dec["linear_pred"])
        y = upsample_bilinear(nchw(y), (hh, ww))
        return nhwc(y).contiguous().to(logits_dtype)
