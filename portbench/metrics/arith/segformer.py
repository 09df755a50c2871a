"""SegFormer's analytic arithmetic, from the configuration file: forward
multiply-accumulates a image, the attention's FLOPs of the calls the
program counted, and how the attention's kernels read in a device trace.

MACs follow ``flops.py``'s conventions: a convolution counts ``out_H *
out_W * kh * kw * cin / groups * cout``, a dense layer ``tokens * in *
out``, the attention ``2 * N * M * C`` (``q k^T`` and ``p v``); norms,
GELU, softmax, resizes and elementwise work are left out. A train step is
three forwards and a MAC is two FLOPs.
"""

from __future__ import annotations

import re


def forward_macs(cfg: dict, hw) -> int:
    """Forward MACs of one image of ``hw`` (H, W, multiples of 32)."""
    h, w = int(hw[0]), int(hw[1])
    if h % 32 or w % 32:
        raise ValueError(f"input must be a multiple of 32, got {(h, w)}")
    enc, dec = cfg["encoder"], cfg["decoder"]
    embed, ratio = dec["embed_dim"], enc["mlp_ratio"]
    macs, cin, tokens = 0, 3, []
    for c, depth, sr, (k, s) in zip(enc["widths"], enc["depths"], enc["sr_ratios"],
                                    enc["patches"]):
        h, w = -(-h // s), -(-w // s)  # the patch embedding's stride, padding k // 2
        n = h * w
        macs += n * k * k * cin * c
        m = n // (sr * sr)
        per_block = (n * c * c  # q
                     + (m * sr * sr * c * c if sr > 1 else 0)  # the reduction
                     + m * c * 2 * c  # keys and values
                     + 2 * n * m * c  # q k^T, p v
                     + n * c * c  # the output
                     + n * c * ratio * c * 2  # fc1, fc2
                     + n * 9 * ratio * c)  # the depthwise 3x3
        macs += depth * per_block
        tokens.append((n, c))
        cin = c
    n1 = tokens[0][0]
    macs += sum(n * c * embed for n, c in tokens)  # linear_c*
    macs += n1 * len(tokens) * embed * embed  # the fuse
    macs += n1 * embed * cfg["num_classes"]  # the prediction
    return int(macs)


def train_flops_per_image(cfg: dict, hw) -> float:
    return 3.0 * 2.0 * forward_macs(cfg, hw)


def attention_flops(calls, train: bool) -> float:
    """FLOPs of the attention calls ``[[B, heads, N, M, d, count], ...]``:
    a forward counts ``4 * N * M * d`` a head (two matrix products), a
    backward ``8 * N * M * d`` (its four), with no recomputation."""
    per = 12 if train else 4
    return float(sum(per * b * heads * n * m * d * count for b, heads, n, m, d, count in calls))


# the kernels of torch's scaled_dot_product_attention backends: flash
# (forward, backward and its dq/dot helpers), memory-efficient (CUTLASS's
# fmha), cuDNN's fused attention
_SDPA = re.compile(r"flash_fwd|flash_bwd|fmha|sdpa|attention_kernel|_attn_fwd|_attn_bwd",
                   re.IGNORECASE)


def is_attention_kernel(name: str) -> bool:
    """Whether a device event is a kernel of the fused attention."""
    return bool(_SDPA.search(name))


def attention_seconds(kernels: dict) -> float:
    """The device seconds of the attention's kernels in a trace summary's
    ``kernels`` (``{name: [calls, seconds]}``)."""
    return sum(secs for name, (_, secs) in kernels.items() if is_attention_kernel(name))
