"""Seeded weights of a configuration, made on the device in one draw.

The tree is the JAX layout the port's ``FCN8s.from_params`` takes and the
plain reference reads: ``{'encoder', 'decoder'}`` of ``{layer: {'kernel',
'bias'}}``, convolution kernels HWIO, deconvolution kernels
``(2s, 2s, in, out)``, all fp32 (the configuration's master dtype). Every
kernel is a view of one ``torch.randn`` over the whole parameter count,
scaled per layer as the configuration's ``init`` says (He-normal encoder
kernels, score kernels of a fixed deviation, deconvolution kernels that keep
the scale of what they upsample); biases are zero. The
same seed gives the same bytes on the same device type.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WEIGHT_STREAM = 1  # SeedSequence stream of the weights (the data streams are in traffic/)


def sub_seed(seed: int, *key: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``key`` (any non-negative ints)."""
    state = np.random.SeedSequence([int(seed), *map(int, key)]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def scaled(cfg: dict, width: dict | None) -> dict:
    """The configuration's encoder widths, or with ``width`` (tests only:
    ``{'mult': m, 'fc': f}``) every conv width times ``m`` (at least 8) and
    fc6/fc7 at ``f`` channels."""
    enc = cfg["encoder"]
    if not width:
        return {"convs": [tuple(x) for x in enc["conv_layers"]], "fc": enc["fc6_kernel"][3],
                "last": enc["conv_layers"][-1][2]}

    def s(ch):
        return ch if ch == 3 else max(8, int(ch * width["mult"]))

    convs = [(name, s(cin), s(cout)) for name, cin, cout in enc["conv_layers"]]
    return {"convs": convs, "fc": int(width["fc"]), "last": convs[-1][2]}


def layer_specs(cfg: dict, width: dict | None = None) -> list[tuple]:
    """``(part, name, kernel_shape, std)`` for every layer, in forward order."""
    dims = scaled(cfg, width)
    enc, dec, c = cfg["encoder"], cfg["decoder"], cfg["num_classes"]
    init = cfg["init"]
    k = enc["conv_kernel"]
    specs = [("encoder", name, (k, k, cin, cout), math.sqrt(2.0 / (k * k * cin)))
             for name, cin, cout in dims["convs"]]
    fh, fw = enc["fc6_kernel"][:2]
    fc = dims["fc"]
    specs.append(("encoder", "fc6", (fh, fw, dims["last"], fc),
                  math.sqrt(2.0 / (fh * fw * dims["last"]))))
    specs.append(("encoder", "fc7", (1, 1, fc, fc), math.sqrt(2.0 / fc)))
    tap = {name: cout for name, _, cout in dims["convs"]}
    taps = {"pool3": tap["conv3_3"], "pool4": tap["conv4_3"], "fc7": fc}
    for name, source, _ in dec["score_layers"]:
        cin = taps[source]
        specs.append(("decoder", name, (1, 1, cin, c), init["score_std"]))
    for name, stride in dec["deconv_layers"]:
        specs.append(("decoder", name, (2 * stride, 2 * stride, c, c), 1.0 / math.sqrt(4 * c)))
    return specs


def make_tree(cfg: dict, seed: int, device, width: dict | None = None) -> dict:
    """The configuration's weights from ``seed`` on ``device`` (one draw)."""
    specs = layer_specs(cfg, width)
    sizes = [int(np.prod(shape)) for _, _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHT_STREAM))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    tree = {"encoder": {}, "decoder": {}}
    offset = 0
    for (part, name, shape, std), size in zip(specs, sizes):
        kernel = flat[offset:offset + size].view(shape).mul_(std)
        offset += size
        tree[part][name] = {"kernel": kernel,
                            "bias": torch.zeros(shape[3], device=device, dtype=torch.float32)}
    return tree

