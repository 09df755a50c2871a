"""The train, eval and predict steps and the optimizers. Port of
``fcn8s_tensorflow_tpu/parallel/steps.py``.

Eager PyTorch needs no compiled executable per shape, so each step is a
plain function of (params, device tensors). On a mesh (``parallel/mesh.py``:
one process per position, ``mesh=`` and ``tensor_parallel=`` on every step)
each rank passes its rows of the batch (``mesh.batch_rows``) and, under
tensor parallelism, its fc6/fc7 shards (``mesh.shard_params``), and the
step returns what the single-card step returns for the whole batch: the
loss is the masked mean over the global batch (its normalisers summed over
'data'), gradients are summed over 'data', metrics too, and predictions are
gathered over 'data' (``parallel/collectives.py``). On the (1, 1) mesh, or
with no mesh, every step runs the single-card code.

``eval_step``/``predict_step`` take the compute-dtype params of
``bridge.cast_params``; ``train_step`` takes a ``TrainState`` over the fp32
masters and derives that cast inside autograd on every step.
``predict_step(quantized=True)`` and ``tta_step(quantized=True)`` take the
int8 tree of ``ops.quantize.quantize_fcn8s_params`` instead.

JAX's arrays are immutable and its optimizer returns new trees; here the
optimizer updates the params and its moments IN PLACE under
``torch.no_grad`` (no second copy of 134 M parameters), and ``TrainState``
is a mutable record that ``train_step`` advances and returns.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import bridge
from ..models.fcn8s import apply_fcn8s, decoder_l2_loss
from ..ops.kernels import softmax_cross_entropy
from ..ops.losses import class_pixel_weights, valid_pixel_weights
from ..ops.metrics import update_metrics_state
from ..ops.nn import resize_bilinear
from ..ops.quantize import apply_fcn8s_int8
from .collectives import all_gather_cat, all_reduce, all_reduce_flat
from .mesh import DATA_AXIS, MODEL_AXIS, sharded_leaves

OPTIMIZERS = ("adam", "adamw", "momentum", "sgd")
INITIAL_LEARNING_RATE = 1e-4  # make_optimizer's injected default in the JAX package


@dataclasses.dataclass
class ScaleByAdamTF1State:
    """Adam's step count and first/second moments, one per param leaf."""

    count: int
    mu: list
    nu: list


@dataclasses.dataclass
class OptimizerState:
    """The state of an ``Optimizer``: the counterpart of optax's
    ``inject_hyperparams`` state around the JAX package's chain. ``count``
    is the number of updates applied, ``learning_rate`` the last one applied
    (before the first, JAX's injected default 1e-4), and ``inner`` the update
    rule's own state: a ``ScaleByAdamTF1State`` (adam, adamw), a list of
    momentum traces, one per param leaf (momentum), or None (sgd)."""

    count: int
    learning_rate: float
    inner: Any

    def to(self, device, copy: bool = False) -> "OptimizerState":
        """A copy with every tensor on ``device``; a tensor already there is
        shared unless ``copy``."""
        def move(ts):
            return [t.to(device, copy=copy) for t in ts]

        inner = self.inner
        if isinstance(inner, ScaleByAdamTF1State):
            inner = ScaleByAdamTF1State(count=inner.count, mu=move(inner.mu), nu=move(inner.nu))
        elif inner is not None:
            inner = move(inner)
        return OptimizerState(count=self.count, learning_rate=self.learning_rate, inner=inner)


@dataclasses.dataclass
class TrainState:
    """The carried training state: ``step`` is the reference's
    ``global_step`` (it drives the LR schedule and the dropout draws),
    ``params`` the fp32 master tree, ``opt_state`` the optimizer's."""

    step: int
    params: dict
    opt_state: Any


class Optimizer:
    """One of ``make_optimizer``'s four update rules, applied in the order
    of the JAX package's optax chain: global-norm clip, scaling (Adam's or
    the momentum trace), decoupled weight decay, then the learning rate,
    which is an argument of every ``apply`` (``_set_lr``'s counterpart)."""

    def __init__(self, name: str, clip_norm: float | None, hyper: dict):
        self.name, self.clip_norm, self.hyper = name, clip_norm, hyper

    def init(self, params: dict, device=None) -> OptimizerState:
        """Zeroed state for the leaves of ``params`` (on ``device``, by
        default theirs)."""
        leaves = bridge.param_leaves(params)

        def zeros():
            return [torch.zeros_like(t, device=device) for t in leaves]

        if self.name in ("adam", "adamw"):
            inner = ScaleByAdamTF1State(count=0, mu=zeros(), nu=zeros())
        else:
            inner = zeros() if self.name == "momentum" else None
        return OptimizerState(count=0, learning_rate=INITIAL_LEARNING_RATE, inner=inner)

    @torch.no_grad()
    def apply(self, params: dict, grads: list, opt_state: OptimizerState,
              learning_rate: float, *, mesh=None, tensor_parallel: bool = False) -> None:
        """One update of ``params`` and ``opt_state`` in place from ``grads``
        (aligned with ``bridge.param_leaves(params)``). Every rule is
        elementwise, so on a mesh it runs on this rank's shards; only the
        clip's global norm needs the mesh: the squares of the replicated
        leaves once, plus those of the fc6/fc7 shards summed over 'model'."""
        opt_state.count += 1
        opt_state.learning_rate = learning_rate
        state = opt_state.inner
        leaves = bridge.param_leaves(params)
        if self.clip_norm is not None:  # optax.clip_by_global_norm
            if mesh is not None and mesh.tensor_parallel(tensor_parallel):
                sharded = sharded_leaves(params, mesh, tensor_parallel=True)
                local = sum(torch.sum(g * g) for g, s in zip(grads, sharded) if s)
                rest = sum(torch.sum(g * g) for g, s in zip(grads, sharded) if not s)
                g_norm = torch.sqrt(rest + all_reduce(local, mesh, MODEL_AXIS))
            else:
                g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.clip_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.clip_norm) for g in grads]
        if self.name in ("adam", "adamw"):
            updates = self._adam_tf1(grads, state)
            if self.name == "adamw":  # optax.add_decayed_weights
                wd = self.hyper.get("weight_decay", 1e-4)
                updates = [u.add_(p * wd) for u, p in zip(updates, leaves)]
        elif self.name == "momentum":  # optax.trace: t = g + decay * t
            decay = self.hyper.get("momentum", 0.9)
            for t, g in zip(state, grads):
                t.mul_(decay).add_(g)
            updates = ([g + decay * t for g, t in zip(grads, state)]
                       if self.hyper.get("nesterov", False) else state)
        else:
            updates = grads
        lr = -learning_rate  # optax.scale_by_learning_rate, then apply_updates
        for p, u in zip(leaves, updates):
            p.add_(u * lr)

    def _adam_tf1(self, grads: list, state: ScaleByAdamTF1State) -> list:
        """``scale_by_adam_tf1``: TF1's ``AdamOptimizer`` rule, written out
        because ``torch.optim.Adam`` (like optax) adds eps to the
        bias-corrected sqrt(v_hat), which fails the one-step TF parity:

            lr_scale = sqrt(1 - b2^t) / (1 - b1^t)
            update   = lr_scale * m_t / (sqrt(v_t) + eps)

        The scalar is computed in fp32, as JAX computes it."""
        b1, b2 = self.hyper.get("b1", 0.9), self.hyper.get("b2", 0.999)
        eps = self.hyper.get("eps", 1e-8)
        state.count += 1
        t = torch.tensor(float(state.count), dtype=torch.float32)
        f32 = dict(dtype=torch.float32)
        lr_scale = float(torch.sqrt(1.0 - torch.pow(torch.tensor(b2, **f32), t))
                         / (1.0 - torch.pow(torch.tensor(b1, **f32), t)))
        updates = []
        for m, v, g in zip(state.mu, state.nu, grads):
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            updates.append((m * lr_scale) / (v.sqrt() + eps))
        return updates


def make_optimizer(name: str = "adam", clip_norm: float | None = None, **hyper) -> Optimizer:
    """The train-step optimizer, as in the JAX package: ``"adam"`` (TF1-exact
    Adam; ``b1``, ``b2``, ``eps``), ``"adamw"`` (the same plus decoupled
    ``weight_decay``, default 1e-4, scaled by the learning rate),
    ``"momentum"`` (``momentum`` default 0.9, ``nesterov`` default False:
    ``accum = momentum * accum + g; w -= lr * accum``) or ``"sgd"``.
    ``clip_norm`` clips the raw gradient's global norm first. Unknown names
    and kwargs raise ``ValueError``."""
    name = name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{name}'; one of {OPTIMIZERS}")
    allowed = {"adam": {"b1", "b2", "eps"},
               "adamw": {"b1", "b2", "eps", "weight_decay"},
               "momentum": {"momentum", "nesterov"},
               "sgd": set()}[name]
    if not set(hyper) <= allowed:
        raise ValueError(
            f"unknown kwargs for optimizer '{name}': "
            f"{sorted(set(hyper) - allowed)} (accepted: {sorted(allowed)})")
    return Optimizer(name, clip_norm, hyper)


def create_train_state(params: dict, optimizer: Optimizer) -> TrainState:
    """Step 0 over ``params`` (the fp32 master tree, whose leaves now
    require grad) with a zeroed optimizer state."""
    for t in bridge.param_leaves(params):
        t.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def dropout_generator(device, seed: int, step: int, microbatch: int | None = None):
    """The dropout draw of one step (and grad-accum microbatch), derived from
    (seed, step[, microbatch]) alone: the counterpart of JAX's
    ``fold_in(rng, state.step)``, so a run restarted at step k draws the
    same masks as the uninterrupted run."""
    key = [seed, step] + ([] if microbatch is None else [microbatch])
    draw = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(draw)


AUGMENT_STREAM = 1  # the spawn key that sets the augmentation draws apart


def augment_key(seed: int, step: int) -> np.random.SeedSequence:
    """The key of one step's device augmentation (``make_augment_fn``),
    derived from (seed, step) alone, like ``dropout_generator``'s draw: a
    run restarted at step k augments as the uninterrupted run did. It
    carries the spawn key ``(AUGMENT_STREAM,)`` (each transform appends its
    slot), and dropout's keys carry none, so no augmentation key is ever a
    dropout key, of any step or grad-accum microbatch."""
    return np.random.SeedSequence([seed, step], spawn_key=(AUGMENT_STREAM,))


def loss_and_grads(params: dict, images: torch.Tensor, label_ids: torch.Tensor,
                   sample_mask: torch.Tensor, *, seed: int, step: int, l2_rate: float,
                   keep_prob: float, compute_dtype=torch.bfloat16, remat: bool = False,
                   grad_accum: int = 1, ignore_label: int | None = None, class_weights=None,
                   mesh=None, tensor_parallel: bool = False):
    """The loss and the gradient of every leaf of ``params`` (in
    ``bridge.param_leaves`` order): the value-and-grad half of
    ``train_step``. See ``train_step`` for the arguments.

    Over a >1 'data' axis each rank holds its rows (with ``grad_accum``, in
    ``batch_rows``' microbatch layout) and computes ``sum(w * ce)`` over
    them divided by the whole batch's ``sum(w)``, summed over 'data' before
    the loss, plus the L2 term on data position 0 only; the loss and the
    gradients are then summed over 'data', so every rank holds the global
    batch's."""
    weighted = ignore_label is not None or class_weights is not None
    leaves = bridge.param_leaves(params)
    dp = mesh is not None and mesh.shape[DATA_AXIS] > 1
    fwd_mesh = mesh if dp or (mesh is not None and mesh.tensor_parallel(tensor_parallel)) else None
    with_l2 = not dp or mesh.coords[DATA_AXIS] == 0

    def pixel_weights(lb, mk):
        if class_weights is not None:
            return class_pixel_weights(lb, mk, class_weights, ignore_label)
        return valid_pixel_weights(lb, mk, ignore_label)

    def loss_for(im, lb, mk, generator, denominator):
        run = bridge.cast_params(params, compute_dtype)  # inside autograd, every call
        logits = apply_fcn8s(run, im, keep_prob=keep_prob, generator=generator,
                             deterministic=False, compute_dtype=compute_dtype,
                             logits_dtype=compute_dtype, remat=remat, mesh=fwd_mesh,
                             tensor_parallel=tensor_parallel)
        ce = softmax_cross_entropy(logits, lb, pixel_weights(lb, mk) if weighted else mk,
                                   denominator=denominator)
        if not with_l2:
            return ce
        reg = torch.tensor(l2_rate, dtype=torch.float32) * decoder_l2_loss(params["decoder"])
        return ce + reg

    def global_counts(lb, mk):
        """The (grad_accum,) real-sample counts (pixel-weight sums when
        weighted) of the global microbatches, and the loss denominators
        (summed over 'data'; off a mesh the all-reduce is a no-op)."""
        with torch.no_grad():
            if weighted:
                counts = pixel_weights(lb, mk).reshape(grad_accum, -1).sum(dim=1)
            else:
                counts = mk.float().reshape(grad_accum, -1).sum(dim=1)
            counts = all_reduce(counts, mesh)
        pps = lb[0].numel()
        return counts, (counts if weighted else counts * pps)

    if grad_accum <= 1:
        denominator = global_counts(label_ids, sample_mask)[1][0] if dp else None
        loss = loss_for(images, label_ids, sample_mask,
                        dropout_generator(images.device, seed, step), denominator)
        grads = list(torch.autograd.grad(loss, leaves))
        if dp:
            loss, grads = all_reduce(loss.detach(), mesh), all_reduce_flat(grads, mesh)
        return loss.detach(), grads

    n = images.shape[0]
    if n % grad_accum:
        raise ValueError(f"batch {n} not divisible by grad_accum={grad_accum}")
    b = n // grad_accum
    # weight each microbatch by its real-sample share (with ignore_label /
    # class_weights, its pixel-weight share): the weighted sum of the
    # microbatch means is the full-batch mean, and the L2 term rides along
    # exactly since the weights sum to 1
    counts, denominators = global_counts(label_ids, sample_mask)
    if not dp:  # each microbatch divides by its own sum, as on one card
        denominators = [None] * grad_accum
    shares = counts / torch.clamp(counts.sum(), min=1.0)
    grads = [torch.zeros_like(t) for t in leaves]
    total = torch.zeros((), dtype=torch.float32, device=images.device)
    for i in range(grad_accum):
        part = slice(i * b, (i + 1) * b)
        loss_i = loss_for(images[part], label_ids[part], sample_mask[part],
                          dropout_generator(images.device, seed, step, i), denominators[i])
        g_i = torch.autograd.grad(loss_i, leaves)
        with torch.no_grad():
            for acc, g in zip(grads, g_i):
                acc.add_(g.mul_(shares[i]))
            total = total + shares[i] * loss_i.detach()
    if dp:
        total, grads = all_reduce(total, mesh), all_reduce_flat(grads, mesh)
    return total, grads


def train_step(state: TrainState, images: torch.Tensor, label_ids: torch.Tensor,
               sample_mask: torch.Tensor, seed: int, learning_rate: float, l2_rate: float,
               keep_prob: float, *, optimizer: Optimizer, num_classes: int,
               compute_dtype=torch.bfloat16, remat: bool = False, grad_accum: int = 1,
               ignore_label: int | None = None, class_weights=None, augment_fn=None,
               mesh=None, tensor_parallel: bool = False):
    """One optimization step; returns ``(state, loss)`` with ``state``
    advanced in place and ``loss`` a 0-d fp32 device tensor (no sync).

    ``images`` NHWC uint8, ``label_ids`` NHW uint8/int32, ``sample_mask``
    (N,) float 0/1, zero for batch-padding samples: the masked mean makes
    the gradient exactly the short-batch gradient. ``augment_fn`` (from
    ``ops.augment_device.make_augment_fn``) first augments the whole padded
    batch on its device, outside autograd, with the key
    ``augment_key(seed, state.step)`` (over a >1 'data' axis, that key with
    the data position appended: ranks that hold the same rows draw the
    same). Loss = mean softmax CE + ``l2_rate * decoder_l2_loss``. The CE
    runs through the kernels (K1 with the sample mask; K3 with per-pixel
    weights when ``ignore_label`` or ``class_weights``, an (num_classes,)
    vector, is set), each with the CE-grad kernel as its backward. Dropout
    draws come from (``seed``, ``state.step``). ``grad_accum=A`` splits the
    batch into A microbatches weighted by their real-sample (or
    pixel-weight) share. ``num_classes`` is kept for the JAX signature; the
    logits carry it.

    ``mesh``/``tensor_parallel``: the step of JAX's ``compile_train_step``
    on that mesh; ``images``, ``label_ids`` and ``sample_mask`` are this
    rank's rows (``mesh.batch_rows(n, mesh, grad_accum)``) and ``state``
    holds its shards (``loss_and_grads``; the optimizer runs on the
    shards)."""
    del num_classes
    if augment_fn is not None:
        key = augment_key(seed, state.step)
        if mesh is not None and mesh.shape[DATA_AXIS] > 1:
            key = np.random.SeedSequence(key.entropy,
                                         spawn_key=key.spawn_key + (mesh.coords[DATA_AXIS],))
        with torch.no_grad():
            images, label_ids = augment_fn(key, images, label_ids)
    loss, grads = loss_and_grads(
        state.params, images, label_ids, sample_mask, seed=seed, step=state.step,
        l2_rate=l2_rate, keep_prob=keep_prob, compute_dtype=compute_dtype, remat=remat,
        grad_accum=grad_accum, ignore_label=ignore_label, class_weights=class_weights,
        mesh=mesh, tensor_parallel=tensor_parallel)
    optimizer.apply(state.params, grads, state.opt_state, learning_rate, mesh=mesh,
                    tensor_parallel=tensor_parallel)
    state.step += 1
    return state, loss


def eval_step(params: dict, metrics_state: dict, images: torch.Tensor, label_ids: torch.Tensor,
              sample_mask: torch.Tensor, *, num_classes: int, compute_dtype=torch.bfloat16,
              ignore_label: int | None = None, class_weights=None, mesh=None,
              tensor_parallel: bool = False) -> dict:
    """Forward-only metric accumulation at keep_prob=1: the forward in
    ``compute_dtype`` with logits kept in it, the CE through K1 with
    ``sample_mask`` (through K3 with the pixel weights of ``ignore_label`` /
    ``class_weights``, as the train step), the argmax, and the confusion
    matrix through K5, where an ignored id drops out (it matches no class).
    Updates ``metrics_state`` in place and returns it.

    ``mesh``/``tensor_parallel``: JAX's ``compile_eval_step`` on that mesh,
    ``images``, ``label_ids`` and ``sample_mask`` being this rank's rows;
    the batch's loss (over the whole batch's normaliser) and its K5 counts
    are summed over 'data' before they join the state, which is then the
    same on every rank."""
    dp = mesh is not None and mesh.shape[DATA_AXIS] > 1
    logits = apply_fcn8s(params, images, compute_dtype=compute_dtype,
                         logits_dtype=compute_dtype, mesh=mesh, tensor_parallel=tensor_parallel)
    if class_weights is not None:
        weights = class_pixel_weights(label_ids, sample_mask, class_weights, ignore_label)
    elif ignore_label is not None:
        weights = valid_pixel_weights(label_ids, sample_mask, ignore_label)
    else:
        weights = sample_mask
    denominator = None
    if dp:
        denominator = all_reduce(weights.float().sum(), mesh)
        if weights is sample_mask:
            denominator = denominator * label_ids[0].numel()
    loss = softmax_cross_entropy(logits, label_ids, weights, denominator=denominator)
    pred = torch.argmax(logits, dim=-1).to(torch.int32)
    if not dp:
        return update_metrics_state(metrics_state, loss=loss, pred_ids=pred, gt_ids=label_ids,
                                    num_classes=num_classes, sample_mask=sample_mask)
    batch = update_metrics_state(
        {"loss_sum": torch.zeros_like(metrics_state["loss_sum"]),
         "loss_count": torch.zeros_like(metrics_state["loss_count"]),
         "conf_matrix": torch.zeros_like(metrics_state["conf_matrix"])},
        loss=loss, pred_ids=pred, gt_ids=label_ids, num_classes=num_classes,
        sample_mask=sample_mask)
    metrics_state["loss_sum"] += all_reduce(batch["loss_sum"], mesh)
    metrics_state["loss_count"] += 1.0
    metrics_state["conf_matrix"] += all_reduce(batch["conf_matrix"], mesh)
    return metrics_state


def _forward(params: dict, images: torch.Tensor, quantized: bool, mesh, tensor_parallel,
             **kwargs) -> torch.Tensor:
    """The inference forward: int8 encoder for a quantized tree (replicated
    on a mesh, as JAX keeps it), else the compute-dtype model."""
    if quantized:
        return apply_fcn8s_int8(params, images, mesh=mesh, **kwargs)
    return apply_fcn8s(params, images, mesh=mesh, tensor_parallel=tensor_parallel, **kwargs)


def predict_step(params: dict, images: torch.Tensor, *, argmax: bool = True,
                 compute_dtype=torch.bfloat16, id_dtype=torch.int32, overlay_lut=None,
                 quantized: bool = False, mesh=None,
                 tensor_parallel: bool = False) -> torch.Tensor:
    """Inference head on NHWC ``images``: argmax ids ``(N, H, W)`` in
    ``id_dtype``, the fp32 softmax ``(N, H, W, C)`` (``argmax=False``), or
    with ``overlay_lut`` ((C, 4) RGBA rows) the alpha-composited uint8 RGB
    ``floor(img * (1 - a) + color * a)``.

    Ids are computed in the packed subpixel layout, so full-resolution
    logits never go through a depth-to-space; only the id map does. The
    overlay is the JAX package's per-class compare/select chain in fp32,
    in the same order, with the final ``floor``. ``quantized``: ``params``
    is a ``quantize_fcn8s_params`` tree and the encoder runs in int8.

    ``mesh``/``tensor_parallel``: JAX's ``compile_predict_step`` on that
    mesh; ``images`` are this rank's rows, and the output of the whole
    batch is gathered over 'data' (``tensor_parallel`` does not apply to
    the int8 tree)."""
    return all_gather_cat(_predict_rows(params, images, argmax, compute_dtype, id_dtype,
                                        overlay_lut, quantized, mesh, tensor_parallel), mesh)


def _predict_rows(params, images, argmax, compute_dtype, id_dtype, overlay_lut, quantized, mesh,
                  tensor_parallel):
    """``predict_step`` on this rank's rows."""
    want_ids = argmax or overlay_lut is not None
    logits = _forward(params, images, quantized, mesh, tensor_parallel,
                      compute_dtype=compute_dtype, logits_dtype=compute_dtype,
                      packed_final=want_ids)
    if not want_ids:
        return torch.softmax(logits.float(), dim=-1)
    pred = torch.argmax(logits, dim=-1)  # (n, H/s, W/s, s, s)
    n, h, w, s, _ = pred.shape
    pred = pred.permute(0, 1, 3, 2, 4).reshape(n, h * s, w * s)
    if overlay_lut is None:
        return pred.to(id_dtype)
    lut = np.asarray(overlay_lut, np.float32)
    zero = torch.zeros(pred.shape, dtype=torch.float32, device=pred.device)
    chan = [zero, zero, zero, zero]
    for cls in range(lut.shape[0]):
        mask = pred == cls
        for c in range(4):
            if lut[cls, c] != 0.0:
                chan[c] = torch.where(mask, float(lut[cls, c]), chan[c])
    alpha = chan[3] * (1.0 / 255.0)
    out = [images[..., c].float() * (1.0 - alpha) + chan[c] * alpha for c in range(3)]
    return torch.floor(torch.stack(out, dim=-1)).to(torch.uint8)


def tta_step(params: dict, images: torch.Tensor, *, scale_hw=None, flip: bool = True,
             compute_dtype=torch.bfloat16, quantized: bool = False, mesh=None,
             tensor_parallel: bool = False) -> torch.Tensor:
    """Test-time-augmentation probability head for ONE scale: NHWC uint8
    ``images`` -> ``(N, H, W, C)`` fp32 mean probabilities at the input
    resolution. The view is resized to ``scale_hw`` (``ops.nn.resize_bilinear``,
    JAX's antialiased bilinear); with ``flip`` its mirror joins the batch,
    so one doubled forward runs (logits in ``compute_dtype``, softmax in
    fp32), and the mirrored half is flipped back and averaged with the
    other, ``(fwd + mir) * 0.5``; the probabilities are resized back to
    (H, W). Bilinear weights are convex, so the result stays a
    distribution. ``quantized``, ``mesh`` and ``tensor_parallel`` as in
    ``predict_step``: ``images`` are this rank's rows, and the whole
    batch's probabilities are gathered over 'data'."""
    n, h, w = images.shape[:3]
    x = images.float()
    if scale_hw is not None and tuple(scale_hw) != (h, w):
        x = resize_bilinear(x, scale_hw)
    if flip:
        x = torch.cat([x, x.flip(2)], dim=0)
    logits = _forward(params, x, quantized, mesh, tensor_parallel,
                      compute_dtype=compute_dtype, logits_dtype=compute_dtype)
    del x
    probs = torch.softmax(logits.float(), dim=-1)
    del logits
    if flip:
        fwd, mir = probs[:n], probs[n:]
        probs = (fwd + mir.flip(2)) * 0.5
    if probs.shape[1:3] != (h, w):
        probs = resize_bilinear(probs, (h, w))
    return all_gather_cat(probs, mesh)
