"""The eval path's CUDA kernels, K1 (per-sample CE sum) and K5 (confusion
matrix), with their plain twins and dispatch.

Port of ``fcn8s_tensorflow_tpu/ops/pallas_kernels.py``:

* ``ce_sum_per_sample`` (K1 forward, ``csrc/ce_sum.cu``) replaces
  ``_lse_sum_kernel`` plus the XLA label pick of ``_ce_sample_impl``;
  ``softmax_cross_entropy_per_sample`` is the per-sample branch of
  ``softmax_cross_entropy_pallas`` around it. The backward, the dense
  per-pixel-weight kernel (K3) and the masked path come with training.
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
from .losses import softmax_cross_entropy_with_ids

_ID_DTYPES = (torch.uint8, torch.int32)
_CE_BLOCK = 256
_CE_MAX_BLOCKS = 1024  # fixed by P alone, so the two-pass sum is reproducible


def _check_per_sample(p: int, mask: torch.Tensor, pps: int, name: str) -> None:
    kernels.require(mask.dim() == 1 and mask.dtype == torch.float32 and mask.is_contiguous(),
                    f"{name}: mask must be a contiguous (N,) float32 tensor")
    kernels.require(pps > 0 and p > 0 and p == mask.numel() * pps,
                    f"{name}: {p} pixels do not split into {mask.numel()} samples of {pps}")


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
    kernels.require(flat_logits.dim() == 2 and flat_logits.is_contiguous(),
                    f"{name}: logits must be a contiguous (P, C) tensor")
    kernels.require(flat_logits.dtype in (torch.bfloat16, torch.float32),
                    f"{name}: logits must be bf16 or fp32, got {flat_logits.dtype}")
    p, c = flat_logits.shape
    _check_ids(labels, p, "labels", name)
    _check_per_sample(p, mask, pps, name)
    dev = kernels.require_cuda(flat_logits, labels, mask)
    n_blocks = min(-(-p // _CE_BLOCK), _CE_MAX_BLOCKS)
    partials = torch.empty(n_blocks, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_ce_sum_per_sample(
            flat_logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), partials.data_ptr(),
            out.data_ptr(), n_blocks, p, c, pps, kernels.dtype_code(flat_logits),
            kernels.dtype_code(labels), kernels.stream_handle(dev))
    build.check(rc, name)
    ce_sum_per_sample.launches += 1
    return out


ce_sum_per_sample.launches = 0


def softmax_cross_entropy_per_sample(logits: torch.Tensor, label_ids: torch.Tensor,
                                     sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax CE over (N, ..., C) logits with (N, ...) integer labels
    and an optional (N,) 0/1 ``sample_mask``, normalised by
    ``max(sum(mask) * pixels_per_sample, 1)`` — the per-sample branch of
    ``softmax_cross_entropy_pallas``. Returns an fp32 0-d tensor."""
    c = logits.shape[-1]
    batch = label_ids.shape[0]
    flat = logits.reshape(-1, c)
    pps = flat.shape[0] // batch
    mask = (torch.ones(batch, dtype=torch.float32, device=logits.device) if sample_mask is None
            else sample_mask.float())
    labels = label_ids.reshape(-1)
    if labels.dtype not in _ID_DTYPES:
        labels = labels.to(torch.int32)
    total = ce_sum_per_sample(flat, labels, mask, pps)
    return total / torch.clamp(mask.sum() * pps, min=1.0)


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
    is a 0/1 batch-padding mask: any non-zero entry counts its pixels once."""
    if conf.device.type == "cpu":
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
