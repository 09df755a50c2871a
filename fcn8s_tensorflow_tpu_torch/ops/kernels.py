"""The loss and metric CUDA kernels, with their plain twins, dispatch and
autograd.

Port of ``fcn8s_tensorflow_tpu/ops/pallas_kernels.py``:

* ``ce_sum_per_sample`` (K1 forward, ``csrc/ce_sum.cu``) replaces
  ``_lse_sum_kernel`` plus the XLA label pick of ``_ce_sample_impl``;
* ``ce_sum_weighted`` (K3 forward, the same row loop in ``csrc/ce_sum.cu``)
  replaces ``_ce_fwd_kernel`` of ``_ce_sum_impl``;
* ``ce_grad`` (``csrc/ce_grad.cu``) is the hand-written form of the
  custom-VJP bodies ``_ce_sum_sample_bwd`` and ``_ce_sum_bwd``, which had no
  ``pallas_call`` (XLA fused them): one kernel for both weight modes;
* ``softmax_cross_entropy`` and ``masked_softmax_cross_entropy`` are the
  public losses around them (``softmax_cross_entropy_pallas``,
  ``masked_softmax_cross_entropy_pallas``), differentiable through
  ``_CESum``;
* ``confusion_matrix_accumulate`` (K5, ``csrc/confmat.cu``) replaces
  ``_confmat_kernel`` / ``confusion_matrix_pallas``.

Every wrapper takes its plain twin for a CPU tensor and launches its kernel
for a CUDA tensor; on a CUDA tensor it checks device, dtype, shape and
layout and raises on anything the kernel does not take, never converting or
falling back. Each counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels import build
from .losses import softmax_cross_entropy_with_ids, valid_pixel_weights

_ID_DTYPES = (torch.uint8, torch.int32)
# The CE kernels' tiles and grid. Fastest on the H100 at the train shape among
# 528/792/1056 blocks x 10/20/40 KB tiles (probes/ce_kernels.py --sweep,
# PERF.md §6): bigger tiles halve the per-tile barriers and waits, 40 KB ones
# leave too few blocks resident.
_CE_TILE_BYTES = 20480  # logits a tile: 512 rows of 20 bf16 classes
_CE_TILE_ROWS = (16, 1024)  # a multiple of 16 rows, so every tile starts on a 16-byte line
_CE_MAX_BLOCKS = 1056


def ce_tiling(p: int, c: int, dtype: torch.dtype) -> tuple[int, int]:
    """(rows a tile, blocks) of the CE kernels (``csrc/row_tiles.cuh``) for
    P pixel rows of C classes in ``dtype``: a function of the shape and dtype
    alone, so K1's and K3's sums add the same rows in the same order on every
    run."""
    lo, hi = _CE_TILE_ROWS
    rows = min(hi, max(lo, _CE_TILE_BYTES // (c * dtype.itemsize) // lo * lo))
    return rows, min(-(-p // rows), _CE_MAX_BLOCKS)


def _check_per_sample(p: int, mask: torch.Tensor, pps: int, name: str) -> None:
    kernels.require(mask.dim() == 1 and mask.dtype == torch.float32 and mask.is_contiguous(),
                    f"{name}: mask must be a contiguous (N,) float32 tensor")
    kernels.require(pps > 0 and p > 0 and p == mask.numel() * pps,
                    f"{name}: {p} pixels do not split into {mask.numel()} samples of {pps}")


def _check_logits(flat_logits: torch.Tensor, name: str) -> None:
    kernels.require(flat_logits.dim() == 2 and flat_logits.is_contiguous(),
                    f"{name}: logits must be a contiguous (P, C) tensor")
    kernels.require(flat_logits.dtype in (torch.bfloat16, torch.float32),
                    f"{name}: logits must be bf16 or fp32, got {flat_logits.dtype}")


def _check_ids(t: torch.Tensor, p: int, what: str, name: str) -> None:
    kernels.require(t.dim() == 1 and t.numel() == p and t.is_contiguous(),
                    f"{name}: {what} must be a contiguous ({p},) tensor, got {tuple(t.shape)}")
    kernels.require(t.dtype in _ID_DTYPES, f"{name}: {what} must be uint8 or int32, got {t.dtype}")


# ---------------------------------------------------------------------------
# K1: per-sample softmax cross-entropy sum
# ---------------------------------------------------------------------------


def ce_sum_per_sample_plain(flat_logits: torch.Tensor, labels: torch.Tensor,
                            mask: torch.Tensor, pps: int) -> torch.Tensor:
    """Plain twin of K1: ``sum_p mask[p // pps] * (lse_p - pick_p)`` in fp32,
    a label outside [0, C) picking nothing."""
    ce = softmax_cross_entropy_with_ids(flat_logits, labels)
    return (ce.view(mask.numel(), pps) * mask.float()[:, None]).sum()


def ce_sum_per_sample(flat_logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                      pps: int) -> torch.Tensor:
    """K1 forward: the fp32 0-d sum ``sum_p mask[p // pps] * (lse_p - pick_p)``
    over ``flat_logits`` (P, C) bf16/fp32 with the class dim minor, labels
    (P,) uint8/int32 and the per-sample ``mask`` (N,) fp32, P = N * pps.
    Deterministic: the same inputs give the same bits on every run."""
    if flat_logits.device.type == "cpu":
        return ce_sum_per_sample_plain(flat_logits, labels, mask, pps)
    name = "ce_sum_per_sample"
    _check_logits(flat_logits, name)
    p, c = flat_logits.shape
    _check_ids(labels, p, "labels", name)
    _check_per_sample(p, mask, pps, name)
    dev = kernels.require_cuda(flat_logits, labels, mask)
    rows, n_blocks = ce_tiling(p, c, flat_logits.dtype)
    partials = torch.empty(n_blocks, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_ce_sum_per_sample(
            flat_logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), partials.data_ptr(),
            out.data_ptr(), n_blocks, p, c, pps, rows, kernels.dtype_code(flat_logits),
            kernels.dtype_code(labels), kernels.stream_handle(dev))
    build.check(rc, name)
    ce_sum_per_sample.launches += 1
    return out


ce_sum_per_sample.launches = 0


# ---------------------------------------------------------------------------
# K3: per-pixel-weight CE sum
# ---------------------------------------------------------------------------


def _check_pixel_weights(weights: torch.Tensor, p: int, name: str) -> None:
    kernels.require(weights.dim() == 1 and weights.numel() == p and weights.is_contiguous()
                    and weights.dtype == torch.float32,
                    f"{name}: weights must be a contiguous ({p},) float32 tensor")


def ce_sum_weighted_plain(flat_logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3: ``sum_p w_p * (lse_p - pick_p)`` in fp32, a label
    outside [0, C) picking nothing."""
    return (softmax_cross_entropy_with_ids(flat_logits, labels) * weights).sum()


def ce_sum_weighted(flat_logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """K3 forward: the fp32 0-d sum ``sum_p w_p * (lse_p - pick_p)`` over
    ``flat_logits`` (P, C) bf16/fp32, labels (P,) uint8/int32 and per-pixel
    ``weights`` (P,) fp32. K1's row loop with a per-pixel weight;
    deterministic like K1."""
    if flat_logits.device.type == "cpu":
        return ce_sum_weighted_plain(flat_logits, labels, weights)
    name = "ce_sum_weighted"
    _check_logits(flat_logits, name)
    p, c = flat_logits.shape
    _check_ids(labels, p, "labels", name)
    _check_pixel_weights(weights, p, name)
    dev = kernels.require_cuda(flat_logits, labels, weights)
    rows, n_blocks = ce_tiling(p, c, flat_logits.dtype)
    partials = torch.empty(n_blocks, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_ce_sum_weighted(
            flat_logits.data_ptr(), labels.data_ptr(), weights.data_ptr(), partials.data_ptr(),
            out.data_ptr(), n_blocks, p, c, rows, kernels.dtype_code(flat_logits),
            kernels.dtype_code(labels), kernels.stream_handle(dev))
    build.check(rc, name)
    ce_sum_weighted.launches += 1
    return out


ce_sum_weighted.launches = 0


# ---------------------------------------------------------------------------
# CE grad: the backward of K1 and K3
# ---------------------------------------------------------------------------


def ce_grad_plain(flat_logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                  g: torch.Tensor, pps: int | None = None) -> torch.Tensor:
    """Plain twin of the CE-grad kernel: JAX's two VJP bodies in torch.
    With ``pps``, ``_ce_sum_sample_bwd``: ``(softmax - onehot) * g`` times
    the per-sample ``weights[p // pps]``; without, ``_ce_sum_bwd``:
    ``(softmax - onehot) * w_p * g``. fp32 arithmetic, stored in the logits'
    dtype; a label outside [0, C) one-hots to zeros."""
    logits = flat_logits.float()
    c = logits.shape[1]
    softmax = torch.softmax(logits, dim=1)
    onehot = (labels.long()[:, None] == torch.arange(c, device=logits.device)).float()
    if pps is None:
        d = (softmax - onehot) * weights[:, None] * g.float()
    else:
        d = ((softmax - onehot) * g.float()).view(weights.numel(), pps, c) * weights[:, None, None]
    return d.reshape(flat_logits.shape).to(flat_logits.dtype)


def ce_grad(flat_logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
            g: torch.Tensor, pps: int | None = None) -> torch.Tensor:
    """The CE-grad kernel: ``dlogits[p, c] = (softmax(l_p)_c - [c == label_p])
    * w_p * g``, fp32 arithmetic stored once in the logits' dtype. ``weights``
    is K1's per-sample mask (N,) with ``pps`` pixels per sample, or K3's
    per-pixel weights (P,) with ``pps=None``. ``g`` is a one-element fp32
    tensor on the device (the upstream gradient), read there, so the
    backward never syncs. A pixel of weight 0 gets exact zeros."""
    if flat_logits.device.type == "cpu":
        return ce_grad_plain(flat_logits, labels, weights, g, pps)
    name = "ce_grad"
    _check_logits(flat_logits, name)
    p, c = flat_logits.shape
    _check_ids(labels, p, "labels", name)
    if pps is None:
        _check_pixel_weights(weights, p, name)
    else:
        _check_per_sample(p, weights, pps, name)
    kernels.require(g.numel() == 1 and g.dtype == torch.float32 and g.is_contiguous(),
                    f"{name}: g must be a one-element float32 tensor")
    dev = kernels.require_cuda(flat_logits, labels, weights, g)
    rows, n_blocks = ce_tiling(p, c, flat_logits.dtype)
    out = torch.empty_like(flat_logits)
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_ce_grad(
            flat_logits.data_ptr(), labels.data_ptr(), weights.data_ptr(), g.data_ptr(),
            out.data_ptr(), p, c, 1 if pps is None else pps, int(pps is None), rows, n_blocks,
            kernels.dtype_code(flat_logits), kernels.dtype_code(labels),
            kernels.stream_handle(dev))
    build.check(rc, name)
    ce_grad.launches += 1
    return out


ce_grad.launches = 0


class _CESum(torch.autograd.Function):
    """``sum_p w_p * CE_p`` with the CE-grad kernel as its backward: K1
    forward when ``pps`` is given (per-sample weights), K3 forward when it
    is None (per-pixel weights). The counterpart of JAX's custom VJPs
    ``_ce_sum_sample`` and ``_ce_sum``; only the logits get a gradient."""

    @staticmethod
    def forward(ctx, flat_logits, labels, weights, pps):
        ctx.save_for_backward(flat_logits, labels, weights)
        ctx.pps = pps
        if pps is None:
            return ce_sum_weighted(flat_logits, labels, weights)
        return ce_sum_per_sample(flat_logits, labels, weights, pps)

    @staticmethod
    def backward(ctx, g):
        flat_logits, labels, weights = ctx.saved_tensors
        return ce_grad(flat_logits, labels, weights, g.contiguous(), ctx.pps), None, None, None


def softmax_cross_entropy(logits: torch.Tensor, label_ids: torch.Tensor,
                          pixel_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted-mean softmax CE over (N, ..., C) logits with (N, ...)
    integer labels, differentiable through the CE-grad kernel; returns an
    fp32 0-d tensor. The port of ``softmax_cross_entropy_pallas``, with its
    normalisation contracts:

    * ``pixel_weights`` None or (N,) (a per-sample mask): K1, divided by
      ``max(sum(mask) * pixels_per_sample, 1)``;
    * any other weight, broadcast to the label shape (per pixel): K3,
      divided by ``max(sum(w), 1)``.

    The TPU's chunk-divisibility fallback has no counterpart: the kernels
    take any pixel count. A label outside [0, C) picks nothing and one-hots
    to zeros in the gradient."""
    c = logits.shape[-1]
    flat = logits.reshape(-1, c)
    labels = label_ids.reshape(-1)
    if labels.dtype not in _ID_DTYPES:
        labels = labels.to(torch.int32)
    batch = label_ids.shape[0]
    if pixel_weights is None or (pixel_weights.dim() == 1 and pixel_weights.shape[0] == batch):
        pps = flat.shape[0] // batch
        mask = (torch.ones(batch, dtype=torch.float32, device=logits.device)
                if pixel_weights is None else pixel_weights.float())
        total = _CESum.apply(flat, labels, mask, pps)
        return total / torch.clamp(mask.sum() * pps, min=1.0)
    w = pixel_weights.float()
    w = w.reshape(w.shape + (1,) * (label_ids.dim() - w.dim())).expand(label_ids.shape)
    weights = w.reshape(-1).contiguous()
    total = _CESum.apply(flat, labels, weights, None)
    return total / torch.clamp(weights.sum(), min=1.0)


def masked_softmax_cross_entropy(logits: torch.Tensor, label_ids: torch.Tensor,
                                 sample_mask: torch.Tensor, ignore_label: int) -> torch.Tensor:
    """Mean softmax CE over valid pixels: the contract of
    ``masked_softmax_cross_entropy_pallas`` without its neutral-row trick (a
    TPU fusion workaround). K3 with ``valid_pixel_weights``: the value is
    the ``sample_mask``-weighted mean over pixels whose label is not
    ``ignore_label``; an ignored pixel adds exactly 0.0 and gets an exactly
    zero gradient; an all-ignored batch gives 0."""
    return softmax_cross_entropy(logits, label_ids,
                                 valid_pixel_weights(label_ids, sample_mask, ignore_label))


# ---------------------------------------------------------------------------
# K5: confusion matrix
# ---------------------------------------------------------------------------


def confusion_matrix_accumulate_plain(conf: torch.Tensor, pred: torch.Tensor, gt: torch.Tensor,
                                      mask: torch.Tensor, pps: int) -> torch.Tensor:
    """Plain twin of K5: ``conf[gt, pred] += 1`` over pixels whose ids lie in
    [0, C) and whose sample's mask entry is not 0; in place, returns conf."""
    c = conf.shape[0]
    g, q = gt.long(), pred.long()
    keep = (g >= 0) & (g < c) & (q >= 0) & (q < c)
    keep = (keep.view(mask.numel(), pps) & (mask != 0)[:, None]).view(-1)
    counts = torch.bincount(g[keep] * c + q[keep], minlength=c * c)
    conf += counts.view(c, c).to(conf.dtype)
    return conf


def confusion_matrix_accumulate(conf: torch.Tensor, pred: torch.Tensor, gt: torch.Tensor,
                                mask: torch.Tensor, pps: int) -> torch.Tensor:
    """K5: add one batch's (C, C) counts (rows = GT, cols = prediction) to
    the running int32 ``conf`` IN PLACE and return it. ``pred``/``gt`` are
    (P,) uint8/int32 id maps, ``mask`` (N,) fp32 with P = N * pps. Ids
    outside [0, C) and pixels of samples whose mask is 0 drop out. The mask
    is a 0/1 batch-padding mask: any non-zero entry counts its pixels once.
    The plain twin runs only when all four tensors lie on the CPU; otherwise
    they must all lie on one card."""
    if all(t.device.type == "cpu" for t in (conf, pred, gt, mask)):
        return confusion_matrix_accumulate_plain(conf, pred, gt, mask, pps)
    name = "confusion_matrix_accumulate"
    kernels.require(conf.dim() == 2 and conf.shape[0] == conf.shape[1]
                    and conf.dtype == torch.int32 and conf.is_contiguous(),
                    f"{name}: conf must be a contiguous (C, C) int32 tensor")
    p = pred.numel()
    _check_ids(pred, p, "pred", name)
    _check_ids(gt, p, "gt", name)
    _check_per_sample(p, mask, pps, name)
    dev = kernels.require_cuda(conf, pred, gt, mask)
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_confmat_accumulate(
            pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), conf.data_ptr(), p, conf.shape[0],
            pps, kernels.dtype_code(pred), kernels.dtype_code(gt), kernels.stream_handle(dev))
    build.check(rc, name)
    confusion_matrix_accumulate.launches += 1
    return conf


confusion_matrix_accumulate.launches = 0
