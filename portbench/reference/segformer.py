"""The plain reference of SegFormer (arXiv:2105.15203) in fp32 PyTorch: its
forward, the mean softmax cross-entropy, the gradients and AdamW with
per-leaf multipliers.

Written from the configuration and NVlabs' code (``mix_transformer.py``,
``segformer_head.py``), not from the program: it imports only torch and
numpy, reads the weights in the JAX layout (HWIO convolution kernels, dense
kernels ``(in, out)``, the query ``(C, heads, d)``, keys and values one
``(C, 2C)`` kernel, the output ``(heads, d, C)``) and the configuration as
a dict (``encoder``, ``decoder``, ``normalize``, ``keep_prob``,
``optimizer``). TF32 is off while it runs (``exact_fp32``). The attention
is the explicit ``softmax(q k^T / sqrt(d)) v``; LayerNorm, GELU and
BatchNorm are written out.

Departures from NVlabs' code, each the configuration's:

* the drop rates come from one ``keep_prob``: block ``n`` of ``blocks``
  keeps with ``1 - (1 - keep_prob) * n / (blocks - 1)`` in fp32 (NVlabs'
  ``linspace(0, drop_path_rate, blocks)``), the head's channel dropout with
  ``keep_prob``; the uniforms are drawn in one stated order (``draws``)
  from a generator seeded by ``(seed, step)``, not from the global stream;
* BatchNorm takes its statistics over the batch given, with no SyncBN
  all-reduce across cards;
* AdamW adds eps to ``sqrt(v)`` and scales by ``sqrt(1 - b2^t) / (1 -
  b1^t)`` (TF1's form), where ``torch.optim.AdamW`` adds it to the
  bias-corrected root: a difference of order ``eps``;
* the loss is the mean over every pixel (the repo's trainIds have no
  ignored id).

``precision='fp8'`` is a control: every matrix product's and
convolution's inputs rounded to float8 e4m3 and its output gradient to
e5m2 (per tensor scaled to the format's largest value). ``bn='eval'`` is
another: the train step normalises by the running statistics and leaves
them as they were. ``batch_rows`` a third: part of each batch left out.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8In(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_to(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8GradOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, torch.float8_e5m2)


def _ins(precision, *xs):
    return [_Fp8In.apply(x) for x in xs] if precision == "fp8" else list(xs)


def _out(precision, y):
    return _Fp8GradOut.apply(y) if precision == "fp8" else y


def _matmul(a, b, precision):
    a, b = _ins(precision, a, b)
    return _out(precision, a @ b)


def _dense(x, layer, precision, shape=None):
    """``x @ kernel + bias``, the kernel read as ``shape`` (the attention's
    3-D kernels as ``(C, C)``)."""
    k = layer["kernel"] if shape is None else layer["kernel"].reshape(shape)
    return _matmul(x, k, precision) + layer["bias"].reshape(-1)


def _conv(x, layer, stride, padding, precision, groups=1):
    w = layer["kernel"].permute(3, 2, 0, 1)
    x, w = _ins(precision, x, w)
    return _out(precision, F.conv2d(x, w, layer.get("bias"), stride=stride, padding=padding,
                                    groups=groups))


def _layer_norm(x, layer, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * layer["scale"] + layer["bias"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _tokens(x):
    """NCHW -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def _grid(t, h, w):
    """(B, H*W, C) -> NCHW."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def dropout_seed(seed: int, step: int) -> int:
    """The seed of one step's draws: ``SeedSequence([seed, step])``'s first
    64-bit word shifted right by one."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def blocks(cfg: dict) -> int:
    return sum(cfg["encoder"]["depths"])


def draws(cfg: dict, seed: int, step: int, n: int, device) -> dict:
    """The step's dropout over a batch of ``n``, as the configuration draws
    it: ``(n, 2 * blocks)`` uniforms (DropPath, block after block, the
    attention's column first), then ``(n, embed)`` (the head's channels),
    from one generator on ``device``; each kept where the uniform is below
    its keep probability, scaled by one over it."""
    gen = torch.Generator(device=device).manual_seed(dropout_seed(seed, step))
    nb, embed = blocks(cfg), cfg["decoder"]["embed_dim"]
    u_path = torch.rand((n, 2 * nb), generator=gen, device=device)
    u_head = torch.rand((n, embed), generator=gen, device=device)
    kp = torch.tensor(cfg["keep_prob"], dtype=torch.float32, device=device)
    fracs = torch.arange(nb, dtype=torch.float32, device=device) / max(nb - 1, 1)
    keeps = (1.0 - (1.0 - kp) * fracs).repeat_interleave(2)
    return {"path": u_path < keeps, "path_scale": 1.0 / keeps,
            "head": u_head < kp, "head_scale": 1.0 / kp}


def rows(d: dict | None, idx) -> dict | None:
    """The draws of the rows ``idx`` of the batch."""
    if d is None:
        return None
    return {"path": d["path"][idx], "path_scale": d["path_scale"],
            "head": d["head"][idx], "head_scale": d["head_scale"]}


def _attention(enc, b, x, h, w, heads, sr, precision):
    n, t, c = x.shape
    d = c // heads
    q = _dense(x, enc[b + "q"], precision, (c, c)).reshape(n, t, heads, d).transpose(1, 2)
    if sr > 1:
        r = _tokens(_conv(_grid(x, h, w), enc[b + "sr"], sr, 0, precision))
        r = _layer_norm(r, enc[b + "sr_norm"], 1e-5)
    else:
        r = x
    kv = _dense(r, enc[b + "kv"], precision)
    k = kv[..., :c].reshape(n, -1, heads, d).transpose(1, 2)
    v = kv[..., c:].reshape(n, -1, heads, d).transpose(1, 2)
    probs = torch.softmax(_matmul(q, k.transpose(-1, -2), precision) * d ** -0.5, dim=-1)
    o = _matmul(probs, v, precision).transpose(1, 2).reshape(n, t, c)
    return _dense(o, enc[b + "proj"], precision, (c, c))


def _mix_ffn(enc, b, x, h, w, precision):
    y = _dense(x, enc[b + "fc1"], precision)
    y = _conv(_grid(y, h, w), enc[b + "dwconv"], 1, 1, precision, groups=y.shape[-1])
    return _dense(_gelu(_tokens(y)), enc[b + "fc2"], precision)


def _block(enc, b, x, h, w, heads, sr, precision, keep, scale):
    eps = 1e-6
    for k in range(2):
        y = _layer_norm(x, enc[b + ("norm1", "norm2")[k]], eps)
        y = (_attention(enc, b, y, h, w, heads, sr, precision) if k == 0
             else _mix_ffn(enc, b, y, h, w, precision))
        if keep is not None:
            y = torch.where(keep[:, k, None, None], y * scale[k], 0.0)
        x = x + y
    return x


def _batch_norm(x, layer, stats, bn, eps, momentum):
    """NCHW BatchNorm: by the batch's statistics (biased variance), the
    running ones moved by ``momentum`` with the unbiased variance, when
    ``bn == 'train'``; by the running statistics otherwise."""
    if bn == "train":
        mean = x.mean((0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean((0, 2, 3))
        count = x.numel() // x.shape[1]
        with torch.no_grad():
            stats["mean"].mul_(1 - momentum).add_(momentum * mean)
            stats["var"].mul_(1 - momentum).add_(momentum * var * count / (count - 1))
    else:
        mean, var = stats["mean"], stats["var"]
    y = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + eps)
    return y * layer["scale"][:, None, None] + layer["bias"][:, None, None]


def forward(tree: dict, stats: dict, images: torch.Tensor, cfg: dict, d: dict | None = None,
            precision: str = "fp32", bn: str = "train", remat: bool = False) -> torch.Tensor:
    """NCHW fp32 logits of uint8 NHWC ``images``; ``d`` (``draws``, these
    rows') applies dropout, None runs without. ``stats``: the running
    ``mean``/``var`` of the head's BatchNorm, updated in place when ``bn ==
    'train'``. ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``), which keeps the batch whole in memory."""
    enc, dec, ecfg = tree["encoder"], tree["decoder"], cfg["encoder"]
    mean = torch.tensor(cfg["normalize"]["mean"], dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg["normalize"]["std"], dtype=torch.float32, device=images.device)
    x = ((images.float() - mean) / std).permute(0, 3, 1, 2)
    outs, nblock = [], 0
    for i, (heads, depth, sr, (k, s)) in enumerate(
            zip(ecfg["heads"], ecfg["depths"], ecfg["sr_ratios"], ecfg["patches"]), start=1):
        x = _conv(x, enc[f"patch_embed{i}"], s, k // 2, precision)
        h, w = x.shape[2], x.shape[3]
        x = _layer_norm(_tokens(x), enc[f"patch_embed{i}_norm"], 1e-5)
        for j in range(depth):
            keep = None if d is None else d["path"][:, 2 * nblock:2 * nblock + 2]
            scale = None if d is None else d["path_scale"][2 * nblock:2 * nblock + 2]
            args = (enc, f"block{i}_{j}_", x, h, w, heads, sr, precision, keep, scale)
            x = checkpoint(_block, *args, use_reentrant=False) if remat else _block(*args)
            nblock += 1
        x = _layer_norm(x, enc[f"norm{i}"], 1e-6)
        outs.append((x, h, w))
        x = _grid(x, h, w)
    h1, w1 = outs[0][1], outs[0][2]
    feats = []
    for i in reversed(range(len(outs))):
        t, h, w = outs[i]
        y = _grid(_dense(t, dec[f"linear_c{i + 1}"], precision), h, w)
        if i > 0:
            y = F.interpolate(y, size=(h1, w1), mode="bilinear", align_corners=False)
        feats.append(y)
    y = _conv(torch.cat(feats, dim=1), dec["linear_fuse"], 1, 0, precision)
    y = torch.relu(_batch_norm(y, dec["linear_fuse_bn"], stats, bn, cfg["decoder"]["bn_eps"],
                               cfg["decoder"]["bn_momentum"]))
    if d is not None:
        y = torch.where(d["head"][:, :, None, None], y * d["head_scale"], 0.0)
    y = _conv(y, dec["linear_pred"], 1, 0, precision)
    return F.interpolate(y, size=images.shape[1:3], mode="bilinear", align_corners=False)


def leaf_paths(tree: dict) -> list[str]:
    """The JAX paths of the trained leaves (every part but
    ``batch_stats``), in the tree's order."""
    return [f"{part}/{name}/{key}" for part, layers in tree.items() if part != "batch_stats"
            for name, layer in layers.items() for key in layer]


def multipliers(cfg: dict, paths: list[str]) -> list[tuple[float, float]]:
    """Each path's ``(lr_mult, decay_mult)``: the first of the
    configuration's ``custom_keys`` found in the path, tried longest first
    and then alphabetically (mmcv's ``paramwise_cfg``)."""
    keys = cfg["optimizer"].get("custom_keys") or {}
    order = sorted(sorted(keys), key=len, reverse=True)
    out = []
    for path in paths:
        rule = next((keys[k] for k in order if k in path), {})
        out.append((float(rule.get("lr_mult", 1.0)), float(rule.get("decay_mult", 1.0))))
    return out


def train(tree0: dict, batches: list, cfg: dict, seed: int, steps: int, *,
          precision: str = "fp32", bn: str = "train", remat: bool = True,
          batch_rows=None) -> dict:
    """``steps`` train steps from ``tree0`` (not changed) on ``batches[k]``
    (host uint8 NHWC images, uint8 trainIds), each whole batch at once
    (BatchNorm couples its rows): dropout by the configuration's draws, the
    mean softmax CE over every pixel, then AdamW with the multipliers.
    ``batch_rows`` is a control: each step takes only those rows of its
    batch, with their draws of the whole batch's, and BatchNorm's
    statistics are theirs.
    Returns the ``paths`` of the trained leaves, each step's ``losses``,
    ``grad1`` (each leaf's first gradient norm), ``grad1_head`` (the first
    gradient of each decoder kernel, on the host), ``delta`` (each leaf's
    change norm after the last step) and ``stats`` (the running ``mean`` and
    ``var`` after it, on the host)."""
    opt = cfg["optimizer"]
    b1, b2, eps, lr, wd = (opt["b1"], opt["b2"], opt["eps"], opt["learning_rate"],
                           opt["weight_decay"])
    paths = leaf_paths(tree0)
    tree = {part: {name: {k: t.detach().clone().requires_grad_(part != "batch_stats")
                          for k, t in layer.items()} for name, layer in layers.items()}
            for part, layers in tree0.items()}
    params = [t for part, layers in tree.items() if part != "batch_stats"
              for layer in layers.values() for t in layer.values()]
    stats = tree["batch_stats"]["linear_fuse_bn"]
    mults = multipliers(cfg, paths)
    device = params[0].device
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    head = [i for i, p in enumerate(paths) if p.startswith("decoder/") and p.endswith("/kernel")]
    out = {"paths": paths, "losses": []}
    for step in range(steps):
        images, labels = batches[step]
        n = labels.shape[0]
        im = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        lb = torch.from_numpy(np.ascontiguousarray(labels)).to(device).long()
        d = draws(cfg, seed, step, n, device) if cfg["keep_prob"] < 1.0 else None
        if batch_rows is not None:
            use = list(batch_rows)
            im, lb, d = im[use], lb[use], rows(d, use)
        logits = forward(tree, stats, im, cfg, d, precision, bn, remat)
        loss = F.cross_entropy(logits, lb, reduction="sum") / lb.numel()
        grads = torch.autograd.grad(loss, params)
        out["losses"].append(float(loss.detach()))
        del logits, loss
        if step == 0:
            out["grad1"] = [float(g.norm()) for g in grads]
            out["grad1_head"] = [grads[i].cpu().numpy() for i in head]
        t = step + 1
        lr_scale = math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        with torch.no_grad():
            for p, g, mm, vv, (lm, dm) in zip(params, grads, m, v, mults):
                mm.mul_(b1).add_(g, alpha=1 - b1)
                vv.mul_(b2).addcmul_(g, g, value=1 - b2)
                update = lr_scale * mm / (vv.sqrt() + eps) + wd * dm * p
                p.sub_(float(np.float32(lr) * np.float32(lm)) * update)
        del grads
    flat0 = [t for part, layers in tree0.items() if part != "batch_stats"
             for layer in layers.values() for t in layer.values()]
    out["delta"] = [float((p.detach() - p0).norm()) for p, p0 in zip(params, flat0)]
    out["stats"] = {k: t.detach().cpu().numpy() for k, t in stats.items()}
    return out


@torch.no_grad()
def logits(tree: dict, image: np.ndarray, cfg: dict, precision: str = "fp32") -> torch.Tensor:
    """(C, H, W) fp32 logits of one uint8 (H, W, 3) image in eval mode (the
    running statistics, no dropout)."""
    device = tree["decoder"]["linear_pred"]["kernel"].device
    im = torch.from_numpy(np.ascontiguousarray(image[None])).to(device)
    stats = {k: t.clone() for k, t in tree["batch_stats"]["linear_fuse_bn"].items()}
    return forward(tree, stats, im, cfg, None, precision, "eval")[0]
