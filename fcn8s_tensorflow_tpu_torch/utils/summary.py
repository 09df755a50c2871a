"""Per-layer model report: shapes, parameter counts, forward MACs, and
activation footprints — computed analytically from the param tree and the
declarative layer specs (models/vgg16.py ``VGG16_CONV_LAYERS``,
models/fcn8s.py ``_DECODER_SPECS``), no tracing or device work.

Port of ``fcn8s_tensorflow_tpu/utils/summary.py``. The port's tree holds
convolution weights OIHW; the report gives every kernel in the JAX
package's HWIO convention (a deconv's ``kernel`` is HWIO in both trees), so
``FCN8s.summary`` returns the JAX facade's text for the same weights.

MAC conventions: a conv counts ``out_H*out_W*kh*kw*cin*cout`` per image; a
transposed conv counts ``in_H*in_W*kh*kw*cin*cout`` (every input pixel
multiplies the full kernel — identical to the subpixel rewrite's cost,
ops/subpixel.py). Max-pools and elementwise ops are omitted (≪1% of MACs).
Training cost is ≈3× forward MACs (fwd + dgrad + wgrad).
"""

from __future__ import annotations

import numpy as np

from ..models.fcn8s import _DECODER_SPECS, decoder_variant
from ..models.vgg16 import VGG16_CONV_LAYERS, _BLOCK_ENDS

# encoder layer -> input-activation stride (output stride is the same; the
# 2x2/s2 pool AFTER each block end advances the next block's stride)
_ENC_STRIDE = {}
_s = 1
for _name, _, _ in VGG16_CONV_LAYERS:
    _ENC_STRIDE[_name] = _s
    if _name in _BLOCK_ENDS:
        _s *= 2
_ENC_STRIDE["fc6"] = _ENC_STRIDE["fc7"] = 32  # after pool5

# decoder layer -> (input stride, output stride) per variant
_DEC_STRIDES = {
    "fcn8s": {
        "pool3_1x1": (8, 8), "pool4_1x1": (16, 16), "fc7_1x1": (32, 32),
        "fc7_deconv": (32, 16), "fc7_pool4_deconv": (16, 8),
        "fc7_pool4_pool3_deconv": (8, 1),
    },
    "fcn16s": {
        "pool4_1x1": (16, 16), "fc7_1x1": (32, 32),
        "fc7_deconv": (32, 16), "fc7_pool4_deconv": (16, 1),
    },
    "fcn32s": {"fc7_1x1": (32, 32), "fc7_deconv": (32, 1)},
}


def _leaf_params(layer: dict) -> int:
    return sum(int(np.prod(tuple(x.shape))) for x in layer.values())


def _hwio(layer: dict) -> tuple:
    """The layer's kernel shape in the JAX layout (OIHW weight -> HWIO)."""
    if "kernel" in layer:
        return tuple(layer["kernel"].shape)
    o, i, kh, kw = layer["weight"].shape
    return (kh, kw, i, o)


def model_summary_rows(params: dict, input_hw=(1024, 512), batch: int = 1) -> list[dict]:
    """One dict per weight layer, in forward order. Keys: ``name``, ``kind``
    ('conv'/'deconv'), ``kernel`` (shape tuple), ``output`` ((H, W, C) per
    image), ``params`` (weights incl. bias), ``macs`` (forward
    multiply-accumulates for the whole ``batch``), ``act_bytes``
    (output-activation bytes for the batch at 2-byte compute dtype)."""
    H, W = int(input_hw[0]), int(input_hw[1])
    if H % 32 or W % 32:
        raise ValueError(f"input_hw must be divisible by 32, got {(H, W)}")
    rows = []

    def add(name, kind, kernel_shape, in_stride, out_stride, n_params):
        kh, kw, cin, cout = (int(s) for s in kernel_shape)
        ih, iw = H // in_stride, W // in_stride
        oh, ow = H // out_stride, W // out_stride
        # conv: per-output-pixel kernel dot; deconv: per-INPUT-pixel
        macs = batch * kh * kw * cin * cout * (ih * iw if kind == "deconv" else oh * ow)
        rows.append({
            "name": name, "kind": kind, "kernel": (kh, kw, cin, cout),
            "output": (oh, ow, cout), "params": int(n_params),
            "macs": int(macs), "act_bytes": int(batch * oh * ow * cout * 2),
        })

    enc = params["encoder"]
    for name, _, _ in VGG16_CONV_LAYERS:
        add(name, "conv", _hwio(enc[name]),
            _ENC_STRIDE[name], _ENC_STRIDE[name], _leaf_params(enc[name]))
    for name in ("fc6", "fc7"):
        add(name, "conv", _hwio(enc[name]), 32, 32, _leaf_params(enc[name]))

    dec = params["decoder"]
    variant = decoder_variant(dec)
    strides = _DEC_STRIDES[variant]
    for name, kind, _ in _DECODER_SPECS[variant]:
        in_s, out_s = strides[name]
        add(name, kind, _hwio(dec[name]), in_s, out_s, _leaf_params(dec[name]))
    return rows


def model_summary(params: dict, input_hw=(1024, 512), batch: int = 1) -> str:
    """Human-readable layer table + totals. ``print(model.summary(...))``."""
    rows = model_summary_rows(params, input_hw, batch)
    variant = decoder_variant(params["decoder"])
    header = (f"{'layer':<24}{'kind':<8}{'kernel':<20}{'output':<18}"
              f"{'params':>12}{'fwd GMACs':>12}{'act MB':>9}")
    lines = [
        f"FCN variant: {variant}   input: {batch}x{input_hw[0]}x{input_hw[1]}x3"
        f"   (activations at 2-byte compute dtype)",
        header, "-" * len(header),
    ]
    for r in rows:
        k = "x".join(map(str, r["kernel"]))
        o = "x".join(map(str, r["output"]))
        lines.append(
            f"{r['name']:<24}{r['kind']:<8}{k:<20}{o:<18}"
            f"{r['params']:>12,}{r['macs'] / 1e9:>12.2f}"
            f"{r['act_bytes'] / 1e6:>9.1f}")
    total_p = sum(r["params"] for r in rows)
    total_m = sum(r["macs"] for r in rows)
    total_a = sum(r["act_bytes"] for r in rows)
    lines += [
        "-" * len(header),
        f"params {total_p:,} ({total_p * 4 / 1e6:.1f} MB fp32 master"
        f" + {total_p * 8 / 1e6:.1f} MB Adam state)",
        f"forward {2 * total_m / 1e12:.2f} TFLOPs"
        f" | train step ≈ {6 * total_m / 1e12:.2f} TFLOPs (fwd+dgrad+wgrad)"
        f" | layer activations {total_a / 1e6:.0f} MB",
    ]
    return "\n".join(lines)
