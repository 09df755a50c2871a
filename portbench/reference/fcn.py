"""The plain reference: FCN-8s / 16s / 32s over a VGG-16 encoder in fp32
PyTorch, its mean softmax cross-entropy, and TF1's Adam.

Written from the configuration file and the paper (arXiv:1411.4038), not
from the program: it imports nothing of the port and reads the weights as
the benchmark made them (``portbench/weights.py``: HWIO kernels). Inputs are
uint8 NHWC; the mean RGB is subtracted in fp32; every 3x3 and 7x7
convolution is SAME (symmetric padding), each block ends in a 2x2 stride-2
max pool, fc6 and fc7 are followed by ReLU and inverted dropout, and each
deconvolution is TF's SAME ``conv2d_transpose`` of the lhs-dilated,
unflipped HWIO kernel (here ``conv_transpose2d`` of the flipped kernel).
TF32 is off while it runs (``exact_fp32``).

``precision='fp8'`` is the control of the checks: every convolution's input
and weight rounded to float8 e4m3 and its output gradient to e5m2 (per
tensor scaled to the format's largest value), the arithmetic otherwise as
above: the step below bf16 that a later change could be tempted by.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to a float8 format, scaled per tensor to its range."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8In(torch.autograd.Function):
    """Forward: round to e4m3. Backward: the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _round_to(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8GradOut(torch.autograd.Function):
    """Forward: identity. Backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, torch.float8_e5m2)


def _conv(x, kernel_hwio, bias, precision):
    w = kernel_hwio.permute(3, 2, 0, 1)
    pad = (w.shape[2] // 2, w.shape[3] // 2)
    if precision == "fp8":
        return _Fp8GradOut.apply(F.conv2d(_Fp8In.apply(x), _Fp8In.apply(w), bias, padding=pad))
    return F.conv2d(x, w, bias, padding=pad)


def _deconv(x, kernel, bias, stride, precision):
    """TF SAME conv2d_transpose with a (2s, 2s, in, out) kernel: output
    ``in * s``; the lhs-dilated correlation pads ``2s - 1 - (s + 1) // 2``
    before, which is ``conv_transpose2d`` with padding ``(s + 1) // 2``."""
    w = kernel.flip(0, 1).permute(2, 3, 0, 1)
    pad = (stride + 1) // 2
    if precision == "fp8":
        out = F.conv_transpose2d(_Fp8In.apply(x), _Fp8In.apply(w), bias, stride=stride, padding=pad)
        return _Fp8GradOut.apply(out)
    return F.conv_transpose2d(x, w, bias, stride=stride, padding=pad)


def dropout_seed(seed: int, step: int) -> int:
    """The configuration's ``dropout_draw`` seed of one step."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def dropout_masks(cfg: dict, seed: int, step: int, n: int, hw, fc: int, device):
    """fc6's and fc7's keep-masks of a step over the whole global batch of
    ``n`` images of ``hw``, NCHW bool, as the configuration draws them."""
    gen = torch.Generator(device=device).manual_seed(dropout_seed(seed, step))
    h, w = hw[0] // 32, hw[1] // 32
    keep = cfg["keep_prob"]
    draws = [torch.rand((n, h, w, fc), generator=gen, device=device) for _ in range(2)]
    return [(u < keep).permute(0, 3, 1, 2) for u in draws]


def forward(tree: dict, images: torch.Tensor, cfg: dict, masks=None, precision: str = "fp32"):
    """NCHW fp32 logits of uint8 NHWC ``images``; ``masks`` (fc6's, fc7's)
    apply dropout at the configuration's keep_prob, None runs without."""
    enc, dec = tree["encoder"], tree["decoder"]
    mean = torch.tensor(cfg["encoder"]["vgg_mean_rgb"], dtype=torch.float32, device=images.device)
    x = (images.float() - mean).permute(0, 3, 1, 2)
    pool_after = set(cfg["encoder"]["pool_after"])
    taps = {}
    for name, _, _ in cfg["encoder"]["conv_layers"]:
        x = torch.relu(_conv(x, enc[name]["kernel"], enc[name]["bias"], precision))
        if name in pool_after:
            x = F.max_pool2d(x, 2, 2)
            taps[{"conv3_3": "pool3", "conv4_3": "pool4"}.get(name)] = x
    scale = 1.0 / cfg["keep_prob"]
    for i, name in enumerate(("fc6", "fc7")):
        x = torch.relu(_conv(x, enc[name]["kernel"], enc[name]["bias"], precision))
        if masks is not None:
            x = torch.where(masks[i], x * scale, 0.0)
    taps["fc7"] = x
    scales = {"pool3": cfg["decoder"].get("pool3_scale", 1.0),
              "pool4": cfg["decoder"].get("pool4_scale", 1.0), "fc7": 1.0}
    scores = {source: _conv(taps[source] * scales[source], dec[name]["kernel"], dec[name]["bias"],
                            precision)
              for name, source, _ in cfg["decoder"]["score_layers"]}
    skips = [s for s in ("pool4", "pool3") if s in scores]
    x = scores["fc7"]
    for i, (name, stride) in enumerate(cfg["decoder"]["deconv_layers"]):
        x = _deconv(x, dec[name]["kernel"], dec[name]["bias"], stride, precision)
        if i < len(skips):
            x = x + scores[skips[i]]
    return x


def decoder_l2(tree: dict) -> torch.Tensor:
    return sum(0.5 * torch.sum(layer["kernel"] ** 2) for layer in tree["decoder"].values())


def _leaves(tree):
    return [t for layers in tree.values() for layer in layers.values() for t in layer.values()]


def decoder_kernels(tree: dict) -> list[int]:
    """The positions of the decoder's kernels among the tree's leaves."""
    keys = [(part, key) for part, layers in tree.items() for layer in layers.values()
            for key in layer]
    return [i for i, (part, key) in enumerate(keys) if part == "decoder" and key == "kernel"]


def train(tree0: dict, batches: list, cfg: dict, seed: int, steps: int, *, block: int = 4,
          precision: str = "fp32", rows=None, denominator: int | None = None,
          fc: int | None = None) -> dict:
    """``steps`` train steps of the configuration from ``tree0`` (which is
    not changed) on ``batches[k]`` (host uint8 images, uint8 trainIds):
    dropout by the configuration's draw over each whole batch, the mean
    softmax CE summed over the pixels of ``rows`` (default: every row) over
    the pixels of ``denominator`` rows (default: as many as ``rows``), plus
    the L2 term, then TF1 Adam. Rows run in blocks of ``block`` with the
    gradients summed. Returns the loss of each step, each leaf's first
    gradient norm, the first gradient of each decoder kernel (HWIO, on the
    host: ``grad1_decoder``), and each leaf's change norm after the last
    step."""
    opt = cfg["optimizer"]
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["learning_rate"]
    device = _leaves(tree0)[0].device
    tree = {part: {name: {k: t.detach().clone().requires_grad_(True) for k, t in layer.items()}
                   for name, layer in layers.items()} for part, layers in tree0.items()}
    params = _leaves(tree)
    fc = fc or tree["encoder"]["fc7"]["kernel"].shape[3]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    out = {"losses": []}
    for step in range(steps):
        images, labels = batches[step]
        n, h, w = labels.shape
        use = list(range(n)) if rows is None else list(rows)
        masks = (dropout_masks(cfg, seed, step, n, (h, w), fc, device)
                 if cfg["keep_prob"] < 1.0 else None)
        grads = [torch.zeros_like(p) for p in params]
        total = 0.0
        pixels = (denominator or len(use)) * h * w
        for start in range(0, len(use), block):
            idx = use[start:start + block]
            im = torch.from_numpy(np.ascontiguousarray(images[idx])).to(device)
            lb = torch.from_numpy(np.ascontiguousarray(labels[idx])).to(device).long()
            mk = None if masks is None else [mm[idx] for mm in masks]
            logits = forward(tree, im, cfg, mk, precision)
            loss = F.cross_entropy(logits, lb, reduction="sum") / pixels
            if start == 0 and cfg["l2_regularization"]:
                loss = loss + cfg["l2_regularization"] * decoder_l2(tree)
            for acc, g in zip(grads, torch.autograd.grad(loss, params)):
                acc.add_(g)
            total += float(loss.detach())
            del logits, loss
        out["losses"].append(total)
        if step == 0:
            out["grad1"] = [float(g.norm()) for g in grads]
            out["grad1_decoder"] = [grads[i].cpu().numpy() for i in decoder_kernels(tree)]
        t = step + 1
        lr_t = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        with torch.no_grad():
            for p, g, mm, vv in zip(params, grads, m, v):
                mm.mul_(b1).add_(g, alpha=1 - b1)
                vv.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr_t * mm / (vv.sqrt() + eps))
        del grads
    out["delta"] = [float((p.detach() - p0).norm()) for p, p0 in zip(params, _leaves(tree0))]
    return out


@torch.no_grad()
def logits(tree: dict, image: np.ndarray, cfg: dict, precision: str = "fp32") -> torch.Tensor:
    """(C, H, W) fp32 logits of one uint8 (H, W, 3) image, without dropout."""
    device = _leaves(tree)[0].device
    im = torch.from_numpy(np.ascontiguousarray(image[None])).to(device)
    return forward(tree, im, cfg, None, precision)[0]
