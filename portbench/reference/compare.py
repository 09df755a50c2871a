"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference gives. Plain numpy and torch; no
import of the program."""

from __future__ import annotations

import numpy as np
import torch


def logit_gaps(ref_logits: torch.Tensor, ids) -> tuple[float, float, int]:
    """The widest gap, over the pixels, by which the reference's logit of
    the served class lies below the reference's best (0 where every id is
    the reference's argmax), the sum of the gaps, and the pixel count.
    ``ref_logits`` (C, H, W), ``ids`` (H, W)."""
    ids = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=ref_logits.device)
    if ids.shape != ref_logits.shape[1:]:
        raise ValueError(f"ids {tuple(ids.shape)} against logits {tuple(ref_logits.shape)}")
    if int(ids.min()) < 0 or int(ids.max()) >= ref_logits.shape[0]:
        # an id outside the classes is wrong whatever the logits
        return float("inf"), float("inf"), ids.numel()
    gap = ref_logits.max(dim=0).values - torch.gather(ref_logits, 0, ids[None])[0]
    return float(gap.max()), float(gap.double().sum()), ids.numel()


def answer_gaps(pairs) -> dict:
    """The number compared for served answers, over ``(ref_logits, ids)``
    pairs: ``mean_gap``, the mean gap over every pixel (0 where every id is
    the reference's argmax; a bf16 program flips near-ties by its rounding,
    a lower precision flips more pixels by more)."""
    total, count = 0.0, 0
    for ref, ids in pairs:
        _, s, n = logit_gaps(ref, ids)
        total, count = total + s, count + n
    return {"mean_gap": total / count if count else float("inf")}


def loss_gap(program: list, reference: list) -> float:
    """The largest relative gap of the losses, step by step."""
    if len(program) != len(reference):
        return float("inf")
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def norm_gap(program: list, reference: list, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's:
    ``keep`` (booleans) leaves some leaves out."""
    prog, ref = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return float("inf")
    gaps = np.abs(prog - ref) / np.maximum(ref, float(np.median(ref)))
    if keep is not None:
        gaps = gaps[np.asarray(keep, bool)]
    return float(gaps.max())


def vector_gap(program: list, reference: list) -> float:
    """The worst leaf's distance between the program's tensor and the
    reference's, over the reference's norm of that leaf: unlike a gap of
    norms, it sees which rows made a gradient."""
    if len(program) != len(reference):
        return float("inf")
    worst = 0.0
    for p, r in zip(program, reference):
        p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
        if p.shape != r.shape or not np.all(np.isfinite(p)):
            return float("inf")
        worst = max(worst, float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30)))
    return worst


def moving_leaves(grad1: list, share: float = 1e-3) -> list:
    """The leaves whose first gradient is at least ``share`` of the median
    leaf's: the others move under Adam by round-off alone."""
    g = np.asarray(grad1, np.float64)
    return list(g >= share * float(np.median(g)))
