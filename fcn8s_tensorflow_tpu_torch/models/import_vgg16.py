"""Pretrained VGG-16 encoder weights from a torchvision state dict, without
the JAX package. Port of ``tools/import_vgg16.py``'s torch path.

torchvision's ``vgg16`` state dict (``features.<i>.weight``/``.bias`` for
the 13 convolutions, ``classifier.0``/``classifier.3`` for the two fully
connected layers) becomes an encoder-only checkpoint in the JAX package's
format, loadable by ``FCN8s(vgg16_dir=...)`` of either package: the conv
kernels go OIHW -> HWIO, fc6 and fc7 are convolutionalized as the FCN paper
prescribes (fc6: (4096, 25088) -> 7x7x512x4096 in torch's (C, H, W) flatten
order, fc7: (4096, 4096) -> 1x1x4096x4096), and torchvision's input
preprocessing (``/255``, ImageNet mean and std) is folded into conv1_1, so
the encoder's Caffe-style mean subtraction feeds it correctly. The file is
the one the JAX tool writes for the same state dict, byte for byte.

The tool's ``--tf-savedmodel`` source (the reference's Udacity SavedModel)
needs TensorFlow, and stays with the JAX tool.

Usage::

    python -m fcn8s_tensorflow_tpu_torch.models.import_vgg16 \\
        --torch-state-dict vgg16.pth --out /ckpt/vgg16
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .vgg16 import FC6_KERNEL, FC7_KERNEL, VGG16_CONV_LAYERS, VGG_MEAN_RGB

# torchvision vgg16.features indices of the 13 conv layers, in order.
_TORCH_FEATURE_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

# torchvision preprocessing: inputs scaled to [0,1], ImageNet-normalized.
TORCH_IMAGENET_MEAN = (0.485, 0.456, 0.406)
TORCH_IMAGENET_STD = (0.229, 0.224, 0.225)


def _fold_torch_preprocessing(kernel: np.ndarray, bias: np.ndarray):
    """Fold torchvision's input preprocessing into conv1_1 (HWIO).

    torchvision's VGG-16 sees ``t = (x/255 - mean)/std``; ``apply_vgg16``
    feeds ``u = x - VGG_MEAN_RGB`` on 0..255 inputs. With ``a_c =
    1/(255*std_c)`` and ``resid_c = VGG_MEAN_RGB_c - 255*mean_c``,
    ``t_c = a_c*u_c + a_c*resid_c``, so ``kernel' = kernel*a_c`` (per input
    channel) and ``bias' = bias + sum_{h,w,c} kernel'[h,w,c,:] * resid_c``
    give the same conv at interior pixels (at SAME-padded borders each
    scheme zero-pads its own normalized input)."""
    a = 1.0 / (255.0 * np.asarray(TORCH_IMAGENET_STD, np.float32))
    resid = (np.asarray(VGG_MEAN_RGB, np.float32)
             - 255.0 * np.asarray(TORCH_IMAGENET_MEAN, np.float32))
    folded = kernel * a[None, None, :, None]
    bias_adj = np.einsum("hwco,c->o", folded, resid)
    return folded, bias + bias_adj


def _as_encoder_tree(kernels: dict, biases: dict) -> dict:
    """The encoder tree (fp32 numpy, JAX layout) with the JAX tool's shape
    checks: the full-width VGG-16."""
    encoder = {}
    for name, in_ch, out_ch in VGG16_CONV_LAYERS:
        k = np.asarray(kernels[name], np.float32)
        if k.shape != (3, 3, in_ch, out_ch):
            raise ValueError(f"{name}: kernel shape {k.shape} != (3,3,{in_ch},{out_ch})")
        encoder[name] = {"kernel": k, "bias": np.asarray(biases[name], np.float32)}
    for name, shape in [("fc6", FC6_KERNEL), ("fc7", FC7_KERNEL)]:
        k = np.asarray(kernels[name], np.float32)
        if k.shape != shape:
            raise ValueError(f"{name}: kernel shape {k.shape} != {shape}")
        encoder[name] = {"kernel": k, "bias": np.asarray(biases[name], np.float32)}
    return encoder


def from_torch_state_dict(state_dict) -> dict:
    """Convert a torchvision ``vgg16`` state dict: conv kernels OIHW ->
    HWIO, the classifier's fc6/fc7 matrices convolutionalized, the input
    preprocessing folded into conv1_1. Returns the encoder tree."""

    def npy(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    kernels, biases = {}, {}
    for (name, _, _), idx in zip(VGG16_CONV_LAYERS, _TORCH_FEATURE_IDX):
        kernels[name] = npy(state_dict[f"features.{idx}.weight"]).transpose(2, 3, 1, 0)
        biases[name] = npy(state_dict[f"features.{idx}.bias"])
    # fc6: (4096, 25088), 25088 = 512*7*7 in torch's (C, H, W) flatten order
    w6 = npy(state_dict["classifier.0.weight"]).reshape(4096, 512, 7, 7)
    kernels["fc6"] = w6.transpose(2, 3, 1, 0)
    biases["fc6"] = npy(state_dict["classifier.0.bias"])
    kernels["fc7"] = npy(state_dict["classifier.3.weight"]).T[None, None]
    biases["fc7"] = npy(state_dict["classifier.3.bias"])
    kernels["conv1_1"], biases["conv1_1"] = _fold_torch_preprocessing(
        kernels["conv1_1"], biases["conv1_1"])
    return _as_encoder_tree(kernels, biases)


def save_encoder(encoder: dict, out_dir: str, source: str) -> str:
    """Write an encoder-only checkpoint loadable by ``FCN8s(vgg16_dir=...)``
    (``engine/checkpoint.save_checkpoint`` of the port tree)."""
    from .. import bridge
    from ..engine.checkpoint import save_checkpoint

    return save_checkpoint(out_dir, bridge.to_port({"encoder": encoder}),
                           {"source": source, "format": "vgg16-encoder",
                            "model_config": {"num_classes": None}})


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        description="Convert a torchvision VGG-16 state dict into an encoder checkpoint "
                    "for FCN8s(vgg16_dir=...).")
    p.add_argument("--torch-state-dict", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    encoder = from_torch_state_dict(torch.load(args.torch_state_dict, map_location="cpu"))
    out = save_encoder(encoder, args.out, f"torch:{args.torch_state_dict}")
    n_params = sum(int(np.prod(v[k].shape)) for v in encoder.values() for k in v)
    print(f"wrote {out} ({n_params / 1e6:.1f}M params)")
    return out


if __name__ == "__main__":
    main()
