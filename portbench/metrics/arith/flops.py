"""Analytic forward multiply-accumulates of a configuration.

A frozen copy of the port's ``utils/summary.py`` ``model_summary_rows``
conventions, computed from the configuration file instead of a param tree:
a convolution counts ``out_H * out_W * kh * kw * cin * cout`` a image, a
transposed convolution ``in_H * in_W * kh * kw * cin * cout`` (every input
pixel multiplies the whole kernel); pools and elementwise work are left
out. A train step is three forwards (forward, input and weight gradients)
and a MAC is two FLOPs.
"""

from __future__ import annotations


def forward_macs(cfg: dict, hw, widths: dict | None = None) -> int:
    """Forward MACs of one image of ``hw`` (H, W, multiples of 32).
    ``widths`` (``weights.scaled``) replaces the configuration's encoder
    widths where a test shrinks them."""
    h, w = int(hw[0]), int(hw[1])
    if h % 32 or w % 32:
        raise ValueError(f"input must be a multiple of 32, got {(h, w)}")
    enc, dec, c = cfg["encoder"], cfg["decoder"], cfg["num_classes"]
    convs = widths["convs"] if widths else [tuple(x) for x in enc["conv_layers"]]
    fc = widths["fc"] if widths else enc["fc6_kernel"][3]
    k = enc["conv_kernel"]
    macs, stride, tap = 0, 1, {}
    for name, cin, cout in convs:
        macs += (h // stride) * (w // stride) * k * k * cin * cout
        if name in enc["pool_after"]:
            stride *= 2
            tap[name] = cout
    last = convs[-1][2]
    fh, fw = enc["fc6_kernel"][:2]
    macs += (h // 32) * (w // 32) * (fh * fw * last * fc + fc * fc)
    chans = {"pool3": (tap.get("conv3_3"), 8), "pool4": (tap.get("conv4_3"), 16), "fc7": (fc, 32)}
    for _, source, _ in dec["score_layers"]:
        cin, s = chans[source]
        macs += (h // s) * (w // s) * cin * c
    s = 32
    for _, up in dec["deconv_layers"]:
        macs += (h // s) * (w // s) * (2 * up) * (2 * up) * c * c
        s //= up
    return int(macs)


def train_flops_per_image(cfg: dict, hw, widths: dict | None = None) -> float:
    return 3.0 * 2.0 * forward_macs(cfg, hw, widths)


def predict_flops_per_image(cfg: dict, hw, widths: dict | None = None) -> float:
    return 2.0 * forward_macs(cfg, hw, widths)
