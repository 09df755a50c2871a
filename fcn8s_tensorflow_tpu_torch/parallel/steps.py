"""The train, eval and predict steps and the optimizers. Port of
``fcn8s_tensorflow_tpu/parallel/steps.py``.

Each step is a plain function of (params, device tensors), run eagerly.
``compile_train_step``, ``compile_multi_train_step``, ``compile_eval_step``,
``compile_predict_step`` and ``compile_tta_step`` (JAX's compiled steps,
at the end of this module) capture the same bodies in CUDA graphs
(``parallel/graphs.py``) and replay them, one dispatch per step (or per S
steps), with the eager steps' results bit for bit; on a mesh of more than
one position, as graphs cut at the step's collectives, which the host
issues between them.

On a mesh (``parallel/mesh.py``: one process per position, ``mesh=`` and
``tensor_parallel=`` on every step) each rank passes its rows of the batch
(``mesh.batch_rows``) and, under tensor parallelism, its fc6/fc7 shards
(``mesh.shard_params``), and the step returns what the single-card step
returns for the whole batch: the loss is the masked mean over the global
batch (its normalisers summed over 'data'), gradients are summed over
'data', metrics too, and predictions are gathered over 'data'
(``parallel/collectives.py``). On the (1, 1) mesh, or with no mesh, every
step runs the single-card code.

``spatial_partition=True`` (JAX's ``spatial_spec``) splits the width over
'model' too, with replicated params: each step takes this rank's rows at
the full width, keeps its columns (``mesh.width_split``; after the device
augmentation in training), and runs the model on them with a halo exchange
at every conv and deconv. The per-rank kernels see complete rows: K1/K3
sum over this rank's pixels, divided by the whole batch's normaliser (its
global pixel count), and the loss, the gradients, the weight sums and K5's
counts are then summed over both axes; predictions are gathered over
'model' along the width, then over 'data'. The L2 term is added on
position (0, 0) alone.

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
from functools import partial
from typing import Any

import numpy as np
import torch

from .. import bridge
from ..kernels import resolve_device
from ..models.fcn8s import apply_fcn8s, decoder_l2_loss
from ..models.segformer import apply_segformer, is_segformer
from ..ops.augment_device import transform_seed
from ..ops.kernels import softmax_cross_entropy
from ..ops.losses import class_pixel_weights, valid_pixel_weights
from ..ops.metrics import update_metrics_state
from ..ops.nn import resize_bilinear
from ..ops.quantize import apply_fcn8s_int8
from ..utils.profiling import annotate
from .collectives import all_gather_cat, all_reduce, all_reduce_flat, gather_width, grad
from .graphs import (CaptureCache, CaptureEntry, FixedGenerators, binding, capture, fill_scalars,
                     signature, static_like, tensors_of)
from .mesh import ALL_AXES, DATA_AXIS, MODEL_AXIS, sharded_leaves, width_split

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
        self._mults = None  # (the tree's leaf count, its multipliers), from ``multipliers``

    def multipliers(self, params: dict):
        """Each leaf's ``(lr_mult, decay_mult)`` under adamw's
        ``custom_keys`` (aligned with ``bridge.param_leaves(params)``), or
        None without them. A leaf takes the first key found in its JAX path
        (``'decoder/linear_c1/kernel'``), the keys tried longest first and
        then alphabetically, as mmcv's ``paramwise_cfg`` tries them; a key's
        missing multiplier is 1. Worked out once a tree, at ``init`` or at
        the first update of a state ``init`` did not make (a checkpoint's),
        and kept while the tree has as many leaves."""
        keys = self.hyper.get("custom_keys")
        if not keys:
            return None
        n = len(bridge.param_leaves(params))
        if self._mults is None or self._mults[0] != n:
            order = sorted(sorted(keys), key=len, reverse=True)
            out = []
            for path in bridge.jax_leaf_paths(params):
                rule = next((keys[k] for k in order if k in path), {})
                out.append((float(rule.get("lr_mult", 1.0)), float(rule.get("decay_mult", 1.0))))
            self._mults = n, out
        return self._mults[1]

    def init(self, params: dict, device=None) -> OptimizerState:
        """Zeroed state for the leaves of ``params`` (on ``device``, by
        default theirs)."""
        leaves = bridge.param_leaves(params)
        self.multipliers(params)

        def zeros():
            return [torch.zeros_like(t, device=device) for t in leaves]

        if self.name in ("adam", "adamw"):
            inner = ScaleByAdamTF1State(count=0, mu=zeros(), nu=zeros())
        else:
            inner = zeros() if self.name == "momentum" else None
        return OptimizerState(count=0, learning_rate=INITIAL_LEARNING_RATE, inner=inner)

    def apply(self, params: dict, grads: list, opt_state: OptimizerState,
              learning_rate: float, *, mesh=None, tensor_parallel: bool = False) -> None:
        """One update of ``params`` and ``opt_state`` in place from ``grads``
        (aligned with ``bridge.param_leaves(params)``): ``advance``, then
        ``update``."""
        lr_scale = self.advance(opt_state, learning_rate)
        self.update(params, grads, opt_state, learning_rate, lr_scale, mesh=mesh,
                    tensor_parallel=tensor_parallel)

    def advance(self, opt_state: OptimizerState, learning_rate: float) -> float | None:
        """The host half of one update: the counters advance, the learning
        rate is recorded, and Adam's ``lr_scale`` for the new count is
        returned (None for the other rules). A step captured in a CUDA graph
        runs this on the host before each replay."""
        opt_state.count += 1
        opt_state.learning_rate = learning_rate
        if self.name not in ("adam", "adamw"):
            return None
        opt_state.inner.count += 1
        return self.lr_scale(opt_state.inner.count)

    def lr_scale(self, count: int) -> float:
        """``scale_by_adam_tf1``'s ``sqrt(1 - b2^t) / (1 - b1^t)`` at ``t =
        count``, computed in fp32 as JAX computes it (``_adam``)."""
        b1, b2 = self.hyper.get("b1", 0.9), self.hyper.get("b2", 0.999)
        t = torch.tensor(float(count), dtype=torch.float32)
        f32 = dict(dtype=torch.float32)
        return float(torch.sqrt(1.0 - torch.pow(torch.tensor(b2, **f32), t))
                     / (1.0 - torch.pow(torch.tensor(b1, **f32), t)))

    @torch.no_grad()
    def update(self, params: dict, grads: list, opt_state: OptimizerState, learning_rate,
               lr_scale=None, *, mesh=None, tensor_parallel: bool = False) -> None:
        """The device half of one update: ``params`` and the rule's state in
        place. ``learning_rate`` and Adam's ``lr_scale`` (``advance``) are
        floats, or 0-d fp32 tensors on the params' device, which a captured
        step fills before each replay; both give the same bits. Every rule
        is elementwise, so on a mesh it runs on this rank's shards; only the
        clip's global norm needs the mesh: the squares of the replicated
        leaves once, plus those of the fc6/fc7 shards summed over 'model'."""
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
            self._adam(leaves, grads, state, learning_rate, lr_scale, self.multipliers(params))
            return
        if self.name == "momentum":  # optax.trace: t = g + decay * t
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

    def _adam(self, leaves: list, grads: list, state: ScaleByAdamTF1State, learning_rate,
              lr_scale, mults) -> None:
        """``scale_by_adam_tf1``, adamw's decoupled decay
        (``optax.add_decayed_weights``) and the step, as multi-tensor ops
        over every leaf, in a few dozen kernels whatever the leaf count.
        TF1's ``AdamOptimizer`` rule is written out because
        ``torch.optim.Adam`` (like optax) adds eps to the bias-corrected
        sqrt(v_hat), which fails the one-step TF parity:

            lr_scale = sqrt(1 - b2^t) / (1 - b1^t)
            update   = lr_scale * m_t / (sqrt(v_t) + eps)

        ``lr_scale`` comes from ``lr_scale`` (fp32, as JAX computes it).
        Each op is the elementwise op a per-leaf loop would make, in the
        same order, so each leaf gets the loop's bits. The multipliers group
        the leaves by value; a ``decay_mult`` of 0 adds nothing. A
        multi-tensor op takes its one-kernel route only where every tensor
        has its partner's strides, so a gradient autograd left channels_last
        (a convolution's) is made contiguous, as the moments and the masters
        are."""
        b1, b2 = self.hyper.get("b1", 0.9), self.hyper.get("b2", 0.999)
        eps = self.hyper.get("eps", 1e-8)
        grads = [g.contiguous() for g in grads]
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, 1 - b2)
        torch._foreach_mul_(sq, grads)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, sq)
        del sq
        updates = torch._foreach_mul(state.mu, lr_scale)
        den = torch._foreach_sqrt(state.nu)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(updates, den)
        del den
        mults = mults or [(1.0, 1.0)] * len(leaves)
        if self.name == "adamw":
            wd = self.hyper.get("weight_decay", 1e-4)
            for dm, idx in _groups(m[1] for m in mults).items():
                if dm:
                    torch._foreach_add_([updates[i] for i in idx],
                                        torch._foreach_mul([leaves[i] for i in idx], wd * dm))
        lr = -learning_rate  # optax.scale_by_learning_rate, then apply_updates
        for lm, idx in _groups(m[0] for m in mults).items():
            step = lr if lm == 1.0 else _scaled_lr(lr, lm)
            torch._foreach_add_([leaves[i] for i in idx],
                                torch._foreach_mul([updates[i] for i in idx], step))


def _groups(values) -> dict:
    """The positions of each distinct value, in order of first appearance."""
    out: dict = {}
    for i, v in enumerate(values):
        out.setdefault(v, []).append(i)
    return out


def _scaled_lr(lr, mult: float):
    """``lr * mult`` rounded to fp32, for a float ``lr`` as for a 0-d fp32
    tensor (a captured step's), so both give the same bits."""
    if isinstance(lr, torch.Tensor):
        return lr * mult
    return float(np.float32(lr) * np.float32(mult))


def make_optimizer(name: str = "adam", clip_norm: float | None = None, **hyper) -> Optimizer:
    """The train-step optimizer, as in the JAX package: ``"adam"`` (TF1-exact
    Adam; ``b1``, ``b2``, ``eps``), ``"adamw"`` (the same plus decoupled
    ``weight_decay``, default 1e-4, scaled by the learning rate),
    ``"momentum"`` (``momentum`` default 0.9, ``nesterov`` default False:
    ``accum = momentum * accum + g; w -= lr * accum``) or ``"sgd"``.
    ``clip_norm`` clips the raw gradient's global norm first. adamw takes
    ``custom_keys``, per-leaf multipliers in mmcv's form (``{'decoder':
    {'lr_mult': 10.0}, 'norm': {'decay_mult': 0.0}}``,
    ``Optimizer.multipliers``): a leaf's learning rate is the rate times its
    ``lr_mult``, and its decay ``weight_decay`` times its ``decay_mult``.
    Unknown names and kwargs raise ``ValueError``."""
    name = name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{name}'; one of {OPTIMIZERS}")
    allowed = {"adam": {"b1", "b2", "eps"},
               "adamw": {"b1", "b2", "eps", "weight_decay", "custom_keys"},
               "momentum": {"momentum", "nesterov"},
               "sgd": set()}[name]
    if not set(hyper) <= allowed:
        raise ValueError(
            f"unknown kwargs for optimizer '{name}': "
            f"{sorted(set(hyper) - allowed)} (accepted: {sorted(allowed)})")
    for key, rule in (hyper.get("custom_keys") or {}).items():
        if not set(rule) <= {"lr_mult", "decay_mult"}:
            raise ValueError(f"custom_keys[{key!r}] takes lr_mult and decay_mult, got "
                             f"{sorted(rule)}")
    return Optimizer(name, clip_norm, hyper)


def create_train_state(params: dict, optimizer: Optimizer) -> TrainState:
    """Step 0 over ``params`` (the fp32 master tree, whose leaves now
    require grad) with a zeroed optimizer state."""
    for t in bridge.param_leaves(params):
        t.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def dropout_seed(seed: int, step: int, microbatch: int | None = None) -> int:
    """The seed of one step's (and grad-accum microbatch's) dropout draw,
    derived from (seed, step[, microbatch]) alone: the counterpart of JAX's
    ``fold_in(rng, state.step)``, so a run restarted at step k draws the
    same masks as the uninterrupted run."""
    key = [seed, step] + ([] if microbatch is None else [microbatch])
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0] >> np.uint64(1))


def dropout_generator(device, seed: int, step: int, microbatch: int | None = None):
    """A fresh generator on ``device`` seeded with ``dropout_seed``."""
    return torch.Generator(device=device).manual_seed(dropout_seed(seed, step, microbatch))


AUGMENT_STREAM = 1  # the spawn key that sets the augmentation draws apart


def augment_key(seed: int, step: int) -> np.random.SeedSequence:
    """The key of one step's device augmentation (``make_augment_fn``),
    derived from (seed, step) alone, like ``dropout_generator``'s draw: a
    run restarted at step k augments as the uninterrupted run did. It
    carries the spawn key ``(AUGMENT_STREAM,)`` (each transform appends its
    slot), and dropout's keys carry none, so no augmentation key is ever a
    dropout key, of any step or grad-accum microbatch."""
    return np.random.SeedSequence([seed, step], spawn_key=(AUGMENT_STREAM,))


def apply_model(params: dict, images: torch.Tensor, *, train: bool = False, mesh=None,
                tensor_parallel: bool = False, split=None, remat: bool = False,
                packed_final: bool = False, **kwargs) -> torch.Tensor:
    """The forward of the model the tree holds: ``apply_fcn8s`` with every
    argument as given, or ``apply_segformer`` (``models/segformer.py``),
    whose BatchNorm runs in training mode when ``train``; its logits are
    never packed, and it takes no tensor parallelism, width split or
    remat, which raise ``ValueError``. On a data-parallel mesh SegFormer's
    BatchNorm is local: each rank normalises by its own rows."""
    if not is_segformer(params):
        return apply_fcn8s(params, images, mesh=mesh, tensor_parallel=tensor_parallel,
                           split=split, remat=remat, packed_final=packed_final, **kwargs)
    if split is not None or (mesh is not None and mesh.tensor_parallel(tensor_parallel)):
        raise ValueError("SegFormer does not run tensor_parallel or spatial_partition")
    if remat:
        raise ValueError("SegFormer does not run with remat")
    return apply_segformer(params, images, train_bn=train, **kwargs)


def loss_and_grads(params: dict, images: torch.Tensor, label_ids: torch.Tensor,
                   sample_mask: torch.Tensor, *, seed: int, step: int, l2_rate: float,
                   keep_prob: float, compute_dtype=torch.bfloat16, remat: bool = False,
                   grad_accum: int = 1, ignore_label: int | None = None, class_weights=None,
                   mesh=None, tensor_parallel: bool = False, split=None, generators=None):
    """The loss and the gradient of every leaf of ``params`` (in
    ``bridge.param_leaves`` order): the value-and-grad half of
    ``train_step``. See ``train_step`` for the arguments. ``generators``: a
    callable ``microbatch -> torch.Generator`` (``microbatch`` None without
    ``grad_accum``) in place of ``dropout_generator``'s fresh ones from
    (``seed``, ``step``), which a step captured in a CUDA graph keeps fixed
    and re-seeds with the same seeds (``parallel/graphs.py``); ``l2_rate``
    and ``keep_prob`` may then be 0-d fp32 tensors on the device.

    Over a >1 'data' axis each rank holds its rows (with ``grad_accum``, in
    ``batch_rows``' microbatch layout) and computes ``sum(w * ce)`` over
    them divided by the whole batch's ``sum(w)``, summed over 'data' before
    the loss, plus the L2 term on data position 0 only; the loss and the
    gradients are then summed over 'data', so every rank holds the global
    batch's. ``split`` (a ``parallel.mesh.WidthSplit``): the inputs are
    this rank's columns of those rows; the normalisers count the whole
    width, the sums run over both axes, and the L2 term is added on
    position (0, 0) only."""
    weighted = ignore_label is not None or class_weights is not None
    leaves = bridge.param_leaves(params)
    dp = mesh is not None and mesh.shape[DATA_AXIS] > 1
    spread = dp or split is not None  # the batch's pixels lie on more than this rank
    axes = ALL_AXES if split is not None else DATA_AXIS
    tp = mesh is not None and mesh.tensor_parallel(tensor_parallel)
    fwd_mesh = mesh if spread or tp else None
    with_l2 = ((not dp or mesh.coords[DATA_AXIS] == 0)
               and (split is None or mesh.coords[MODEL_AXIS] == 0))

    def pixel_weights(lb, mk):
        if class_weights is not None:
            return class_pixel_weights(lb, mk, class_weights, ignore_label)
        return valid_pixel_weights(lb, mk, ignore_label)

    if generators is None:
        def generators(microbatch=None):
            return dropout_generator(images.device, seed, step, microbatch)

    def loss_for(im, lb, mk, generator, denominator):
        run = bridge.cast_params(params, compute_dtype)  # inside autograd, every call
        logits = apply_model(run, im, train=True, keep_prob=keep_prob, generator=generator,
                             deterministic=False, compute_dtype=compute_dtype,
                             logits_dtype=compute_dtype, remat=remat, mesh=fwd_mesh,
                             tensor_parallel=tensor_parallel, split=split)
        ce = softmax_cross_entropy(logits, lb, pixel_weights(lb, mk) if weighted else mk,
                                   denominator=denominator)
        if not with_l2:
            return ce
        rate = (l2_rate if isinstance(l2_rate, torch.Tensor)
                else torch.tensor(l2_rate, dtype=torch.float32))  # 0-d on the CPU: a scalar
        reg = rate * decoder_l2_loss(params["decoder"])
        return ce + reg

    def global_counts(lb, mk):
        """The (grad_accum,) real-sample counts (pixel-weight sums when
        weighted) of the global microbatches, and the loss denominators
        (summed over 'data', the weight sums over 'model' too under a
        split; off a mesh the all-reduce is a no-op). A sample's pixel
        count is the whole width's."""
        with torch.no_grad():
            if weighted:
                counts = pixel_weights(lb, mk).reshape(grad_accum, -1).sum(dim=1)
                counts = all_reduce(counts, mesh, axes)
            else:  # the sample mask is replicated over 'model'
                counts = all_reduce(mk.float().reshape(grad_accum, -1).sum(dim=1), mesh)
        pps = lb.shape[1] * (lb.shape[2] if split is None else split.width)
        return counts, (counts if weighted else counts * pps)

    if grad_accum <= 1:
        denominator = global_counts(label_ids, sample_mask)[1][0] if spread else None
        loss = loss_for(images, label_ids, sample_mask, generators(), denominator)
        grads = list(grad(loss, leaves))
        if spread:
            loss, grads = all_reduce(loss.detach(), mesh, axes), all_reduce_flat(grads, mesh, axes)
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
    if not spread:  # each microbatch divides by its own sum, as on one card
        denominators = [None] * grad_accum
    shares = counts / torch.clamp(counts.sum(), min=1.0)
    grads = [torch.zeros_like(t) for t in leaves]
    total = torch.zeros((), dtype=torch.float32, device=images.device)
    for i in range(grad_accum):
        part = slice(i * b, (i + 1) * b)
        loss_i = loss_for(images[part], label_ids[part], sample_mask[part], generators(i),
                          denominators[i])
        g_i = grad(loss_i, leaves)
        with torch.no_grad():
            for acc, g in zip(grads, g_i):
                acc.add_(g.mul_(shares[i]))
            total = total + shares[i] * loss_i.detach()
    if spread:
        total, grads = all_reduce(total, mesh, axes), all_reduce_flat(grads, mesh, axes)
    return total, grads


def train_step(state: TrainState, images: torch.Tensor, label_ids: torch.Tensor,
               sample_mask: torch.Tensor, seed: int, learning_rate: float, l2_rate: float,
               keep_prob: float, *, optimizer: Optimizer, num_classes: int,
               compute_dtype=torch.bfloat16, remat: bool = False, grad_accum: int = 1,
               ignore_label: int | None = None, class_weights=None, augment_fn=None,
               mesh=None, tensor_parallel: bool = False, spatial_partition: bool = False):
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
    shards). ``spatial_partition``: the width is split over 'model' too
    (not with ``tensor_parallel``); the rows come at the full width, are
    augmented whole, and the step keeps this rank's columns."""
    del num_classes
    split = _width_split(images, mesh, spatial_partition, tensor_parallel)
    if augment_fn is not None:
        with torch.no_grad():
            images, label_ids = augment_fn(_rank_augment_key(seed, state.step, mesh), images,
                                           label_ids)
    if split is not None:
        images, label_ids = split.columns(images, 2), split.columns(label_ids, 2)
    loss, grads = loss_and_grads(
        state.params, images, label_ids, sample_mask, seed=seed, step=state.step,
        l2_rate=l2_rate, keep_prob=keep_prob, compute_dtype=compute_dtype, remat=remat,
        grad_accum=grad_accum, ignore_label=ignore_label, class_weights=class_weights,
        mesh=mesh, tensor_parallel=tensor_parallel, split=split)
    optimizer.apply(state.params, grads, state.opt_state, learning_rate, mesh=mesh,
                    tensor_parallel=tensor_parallel)
    state.step += 1
    return state, loss


def _rank_augment_key(seed: int, step: int, mesh) -> np.random.SeedSequence:
    """``augment_key(seed, step)``, over a >1 'data' axis with this rank's
    data position appended: ranks that hold the same rows draw the same."""
    key = augment_key(seed, step)
    if mesh is not None and mesh.shape[DATA_AXIS] > 1:
        key = np.random.SeedSequence(key.entropy,
                                     spawn_key=key.spawn_key + (mesh.coords[DATA_AXIS],))
    return key


def _check_layout(spatial_partition: bool, tensor_parallel: bool) -> None:
    """JAX's argument check: the two uses of 'model' exclude each other."""
    if spatial_partition and tensor_parallel:
        raise ValueError("spatial_partition and tensor_parallel are mutually exclusive")


def _width_split(images: torch.Tensor, mesh, spatial_partition: bool, tensor_parallel: bool):
    """The width split of a step's NHWC ``images`` (None: the width is
    whole), after ``_check_layout``."""
    _check_layout(spatial_partition, tensor_parallel)
    return width_split(images.shape[2], mesh) if spatial_partition else None


def eval_step(params: dict, metrics_state: dict, images: torch.Tensor, label_ids: torch.Tensor,
              sample_mask: torch.Tensor, *, num_classes: int, compute_dtype=torch.bfloat16,
              ignore_label: int | None = None, class_weights=None, mesh=None,
              tensor_parallel: bool = False, spatial_partition: bool = False) -> dict:
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
    same on every rank. ``spatial_partition``: as in ``train_step``, this
    rank's columns of its rows, the sums over both axes."""
    split = _width_split(images, mesh, spatial_partition, tensor_parallel)
    dp = mesh is not None and mesh.shape[DATA_AXIS] > 1
    spread = dp or split is not None
    axes = ALL_AXES if split is not None else DATA_AXIS
    pps = label_ids.shape[1] * label_ids.shape[2]  # a sample's pixels, the whole width's
    if split is not None:
        images, label_ids = split.columns(images, 2), split.columns(label_ids, 2)
    logits = apply_model(params, images, compute_dtype=compute_dtype,
                         logits_dtype=compute_dtype, mesh=mesh, tensor_parallel=tensor_parallel,
                         split=split)
    if class_weights is not None:
        weights = class_pixel_weights(label_ids, sample_mask, class_weights, ignore_label)
    elif ignore_label is not None:
        weights = valid_pixel_weights(label_ids, sample_mask, ignore_label)
    else:
        weights = sample_mask
    denominator = None
    if spread:
        if weights is sample_mask:  # replicated over 'model'
            denominator = all_reduce(weights.float().sum(), mesh) * pps
        else:
            denominator = all_reduce(weights.float().sum(), mesh, axes)
    loss = softmax_cross_entropy(logits, label_ids, weights, denominator=denominator)
    pred = torch.argmax(logits, dim=-1).to(torch.int32)
    if not spread:
        return update_metrics_state(metrics_state, loss=loss, pred_ids=pred, gt_ids=label_ids,
                                    num_classes=num_classes, sample_mask=sample_mask)
    batch = update_metrics_state(
        {"loss_sum": torch.zeros_like(metrics_state["loss_sum"]),
         "loss_count": torch.zeros_like(metrics_state["loss_count"]),
         "conf_matrix": torch.zeros_like(metrics_state["conf_matrix"])},
        loss=loss, pred_ids=pred, gt_ids=label_ids, num_classes=num_classes,
        sample_mask=sample_mask)
    metrics_state["loss_sum"] += all_reduce(batch["loss_sum"], mesh, axes)
    metrics_state["loss_count"] += 1.0
    metrics_state["conf_matrix"] += all_reduce(batch["conf_matrix"], mesh, axes)
    return metrics_state


def _forward(params: dict, images: torch.Tensor, quantized: bool, mesh, tensor_parallel,
             split=None, **kwargs) -> torch.Tensor:
    """The inference forward: int8 encoder for a quantized tree (replicated
    on a mesh, as JAX keeps it), else the compute-dtype model."""
    if quantized:
        return apply_fcn8s_int8(params, images, mesh=mesh, split=split, **kwargs)
    return apply_model(params, images, mesh=mesh, tensor_parallel=tensor_parallel, split=split,
                       **kwargs)


def predict_step(params: dict, images: torch.Tensor, *, argmax: bool = True,
                 compute_dtype=torch.bfloat16, id_dtype=torch.int32, overlay_lut=None,
                 quantized: bool = False, mesh=None, tensor_parallel: bool = False,
                 spatial_partition: bool = False) -> torch.Tensor:
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
    the int8 tree). ``spatial_partition``: as in ``train_step``, this rank's
    columns of its rows; the output is gathered over 'model' along the
    width first."""
    split = _width_split(images, mesh, spatial_partition, tensor_parallel)
    if split is not None:
        images = split.columns(images, 2)
    out = _predict_rows(params, images, argmax, compute_dtype, id_dtype, overlay_lut, quantized,
                        mesh, tensor_parallel, split)
    return all_gather_cat(gather_width(out, split, 2), mesh)


def _predict_rows(params, images, argmax, compute_dtype, id_dtype, overlay_lut, quantized, mesh,
                  tensor_parallel, split=None):
    """``predict_step`` on this rank's rows (its columns of them under a
    width ``split``)."""
    want_ids = argmax or overlay_lut is not None
    packed = want_ids and not is_segformer(params)  # SegFormer's logits are never packed
    logits = _forward(params, images, quantized, mesh, tensor_parallel, split,
                      compute_dtype=compute_dtype, logits_dtype=compute_dtype,
                      packed_final=packed)
    if not want_ids:
        return torch.softmax(logits.float(), dim=-1)
    pred = torch.argmax(logits, dim=-1)  # (n, H/s, W/s, s, s) when packed
    if packed:
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


# ---------------------------------------------------------------------------
# the compiled steps: each step body captured once per signature in a CUDA
# graph (parallel/graphs.py) and replayed
# ---------------------------------------------------------------------------


def _segmented(mesh) -> bool:
    """Whether a step on ``mesh`` issues collectives, so that its capture is
    cut at them (``graphs.Segments``): a mesh of more than one position."""
    return mesh is not None and mesh.size > 1


def _require_on(device: torch.device, tensors, what: str) -> None:
    if any(t.device != device for t in tensors):
        raise ValueError(f"{what} must lie on {device}, the compiled step's device")


def _device(device) -> torch.device:
    """The compiled step's device: the card unless the caller asks for the
    CPU (``kernels.resolve_device``), with the card's index made explicit."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _class_weights(class_weights, device):
    """The class weights as an fp32 tensor on ``device``, made once when the
    step is compiled: a tuple copied to the card on every step would sync."""
    if class_weights is None:
        return None
    return torch.as_tensor(class_weights, dtype=torch.float32).to(device)


def _site_seed(seed: int, step: int, mesh, site) -> int:
    """The seed of one draw site of a compiled train dispatch that starts at
    ``step``: the eager step's dropout seed per microbatch, or its
    augmentation slot's seed (this rank's key on ``mesh``), for the
    dispatch's ``k``-th step."""
    kind, k, index = site
    if kind == "dropout":
        return dropout_seed(seed, step + k, index)
    return transform_seed(_rank_augment_key(seed, step + k, mesh), index)


class _CompiledStep:
    """What the compiled steps share: their captures (``graphs.CaptureCache``,
    keyed by the bound tensors, the inputs' signature and the regime),
    ``captures_made``, ``purge`` (release the captures whose tensors are
    gone) and ``release`` (all of them)."""

    captures: CaptureCache

    @property
    def captures_made(self) -> int:
        return self.captures.made

    def purge(self) -> None:
        self.captures.purge()

    def release(self) -> None:
        self.captures.clear()


class _CompiledTrain(_CompiledStep):
    """``compile_train_step``'s and ``compile_multi_train_step``'s callable:
    ``steps`` train steps (S) captured in one graph per state, input
    signature and keep_prob regime (on a mesh of more than one position,
    in graphs cut at their collectives)."""

    def __init__(self, optimizer: Optimizer, *, multi: bool, steps: int, device,
                 compute_dtype, augment_fn, remat: bool, grad_accum: int, ignore_label,
                 class_weights, mesh, tensor_parallel: bool, spatial_partition: bool = False):
        self.optimizer, self.multi, self.steps, self.device = optimizer, multi, steps, device
        self.augment_fn = augment_fn
        self.mesh, self.tensor_parallel, self.spatial = mesh, tensor_parallel, spatial_partition
        self.loss_kw = dict(compute_dtype=compute_dtype, remat=remat, grad_accum=grad_accum,
                            ignore_label=ignore_label,
                            class_weights=_class_weights(class_weights, device),
                            mesh=mesh, tensor_parallel=tensor_parallel)
        self.generators = FixedGenerators(device)
        # learning rate, L2 rate, keep_prob, then Adam's lr_scale of each step
        self.scalars = torch.zeros(3 + steps, dtype=torch.float32, device=device)
        self.captures = CaptureCache()

    @staticmethod
    def state_tensors(state: TrainState) -> list:
        inner = state.opt_state.inner
        if isinstance(inner, ScaleByAdamTF1State):
            inner = [inner.mu, inner.nu]
        # and the state the step updates in place without a gradient (SegFormer's
        # BatchNorm statistics), put back after the warm-up like the rest
        return (bridge.param_leaves(state.params) + tensors_of(inner)
                + bridge.state_leaves(state.params))

    def __call__(self, state: TrainState, images, label_ids, sample_mask, seed: int,
                 learning_rate: float, l2_rate: float, keep_prob: float):
        inputs = (images, label_ids, sample_mask)
        held = self.state_tensors(state)
        _require_on(self.device, held, "the train state")
        drops = not keep_prob >= 1.0
        key = (binding(held), signature(inputs), drops)
        inner = state.opt_state.inner
        adam = isinstance(inner, ScaleByAdamTF1State)
        scalars = [learning_rate, l2_rate, keep_prob] + [
            self.optimizer.lr_scale(inner.count + k + 1) if adam else 0.0
            for k in range(self.steps)]
        seeds = partial(_site_seed, seed, state.step, self.mesh)
        args = (state.params, state.opt_state)
        entry = self.captures.lookup(key)
        if entry is None:
            with annotate("fcn8s.step.capture"):
                fill_scalars(self.scalars, scalars)
                self.generators.reseed(seeds)
                statics = [static_like(x, self.device) for x in inputs]
                for buf, x in zip(statics, inputs):
                    buf.copy_(x)
                captured = capture(partial(self._body, statics, drops), self.device, args=args,
                                   restore=held, generators=self.generators,
                                   segmented=_segmented(self.mesh))
                entry = self.captures.add(key, CaptureEntry(captured, statics, held))
        with annotate("fcn8s.step.copy_in"):
            fill_scalars(self.scalars, scalars)
            self.generators.reseed(seeds)
            for buf, x in zip(entry.statics, inputs):
                buf.copy_(x)
            for _ in range(self.steps):
                self.optimizer.advance(state.opt_state, learning_rate)
        losses = entry.captured.run(*args).clone()
        state.step += self.steps
        return state, losses

    def _draw(self, kind: str, k: int, index=None) -> torch.Generator:
        return self.generators.get((kind, k, index))

    def _body(self, statics: list, drops: bool, params: dict, opt_state: OptimizerState):
        """The device work of ``steps`` train steps on the static inputs,
        every host scalar read from ``scalars``: the eager step's augment,
        width split, ``loss_and_grads`` and ``Optimizer.update``, each draw
        from a fixed generator of ``generators``; on a mesh, with the eager
        step's collectives (the cuts of a segmented capture)."""
        lr, l2 = self.scalars[0], self.scalars[1]
        keep_prob = self.scalars[2] if drops else 1.0
        losses = []
        for k in range(self.steps):
            images, label_ids, sample_mask = (x[k] for x in statics) if self.multi else statics
            split = _width_split(images, self.mesh, self.spatial, self.tensor_parallel)
            if self.augment_fn is not None:
                with torch.no_grad():
                    images, label_ids = self.augment_fn(partial(self._draw, "augment", k),
                                                        images, label_ids)
            if split is not None:
                images, label_ids = split.columns(images, 2), split.columns(label_ids, 2)
            loss, grads = loss_and_grads(params, images, label_ids, sample_mask, seed=None,
                                         step=None, l2_rate=l2, keep_prob=keep_prob,
                                         generators=partial(self._draw, "dropout", k),
                                         split=split, **self.loss_kw)
            self.optimizer.update(params, grads, opt_state, lr, self.scalars[3 + k],
                                  mesh=self.mesh, tensor_parallel=self.tensor_parallel)
            losses.append(loss)
        return torch.stack(losses) if self.multi else losses[0]


def compile_train_step(mesh, optimizer: Optimizer, num_classes: int, *,
                       tensor_parallel: bool = True, compute_dtype=torch.bfloat16,
                       example_state=None, donate: bool = True, augment_fn=None,
                       remat: bool = False, grad_accum: int = 1, spatial_partition: bool = False,
                       use_pallas_ce: bool | None = None, ignore_label: int | None = None,
                       class_weights=None, device="cuda"):
    """``train_step`` captured in a CUDA graph: returns ``step(state,
    images, label_ids, sample_mask, seed, learning_rate, l2_rate,
    keep_prob) -> (state, loss)`` with ``train_step``'s semantics and
    arguments, ``state`` advanced in place and ``loss`` a fresh 0-d fp32
    tensor on the device (no sync).

    The first call for a set of input shapes and dtypes, keep_prob regime
    (below 1 or not) and state tensors warms the step up (the state put
    back as it was), captures one whole step (augment, forward, autograd
    backward, optimizer) and replays it; later calls copy the inputs into
    the capture's buffers and replay. The learning rate, ``l2_rate``,
    ``keep_prob`` and Adam's ``lr_scale`` are written into a device buffer
    before each replay, computed as the eager step computes them, and the
    dropout and augmentation draws come from fixed generators re-seeded
    with the eager step's seeds (``dropout_seed``, ``augment_key``): the
    compiled step gives the eager step's results bit for bit. ``state.step``
    and the optimizer's counters advance on the host once per call, as the
    eager step advances them. A state whose tensors are others (a loaded
    checkpoint, a new ``TrainState``) is captured anew, beside the captures
    it already has: the step keeps ``graphs.MAX_CAPTURES`` of them, the
    least recently used evicted, and releases one whose state is gone.
    ``step.captures_made`` counts the captures made.

    ``device`` (default the card; without one it raises and names
    ``device="cpu"``): on the CPU the same body runs without a capture.
    On the card nothing falls back: a failed warm-up or capture raises.

    ``mesh``, ``tensor_parallel`` and ``spatial_partition`` as in
    ``train_step`` (the inputs are this rank's rows, the state its shards;
    ``spatial_partition`` with ``tensor_parallel`` raises ``ValueError``, as
    in JAX). On a mesh of more than one position the capture is cut at the
    step's collectives (``graphs.Segments``): the sample-count sum, the
    graph of the forward and backward (cut again at each collective of the
    backward: the Megatron pair's, every halo exchange's), the loss and
    gradient sums, the update (cut at the clip's 'model' sum under tensor
    parallelism); the host issues each collective between two replayed
    graphs, on the buffers the capture recorded. Every rank must call the
    step alike. ``example_state``, ``donate`` and ``use_pallas_ce`` are
    JAX's and change nothing here: a capture is made at the first call,
    the state is always updated in place, and the CE always runs through
    K1/K3. ``num_classes`` is kept for the signature."""
    del num_classes, example_state, donate, use_pallas_ce
    _check_layout(spatial_partition, tensor_parallel)
    return _CompiledTrain(optimizer, multi=False, steps=1, device=_device(device),
                          compute_dtype=compute_dtype, augment_fn=augment_fn, remat=remat,
                          grad_accum=grad_accum, ignore_label=ignore_label,
                          class_weights=class_weights, mesh=mesh,
                          tensor_parallel=tensor_parallel, spatial_partition=spatial_partition)


def compile_multi_train_step(mesh, optimizer: Optimizer, num_classes: int, *,
                             steps_per_dispatch: int, tensor_parallel: bool = True,
                             compute_dtype=torch.bfloat16, example_state=None,
                             donate: bool = True, augment_fn=None, remat: bool = False,
                             grad_accum: int = 1, use_pallas_ce: bool | None = None,
                             ignore_label: int | None = None, class_weights=None,
                             device="cuda"):
    """``steps_per_dispatch`` (S) train steps captured in ONE CUDA graph:
    returns ``step(state, images_s, labels_s, mask_s, seed, learning_rate,
    l2_rate, keep_prob) -> (state, losses)`` over S-stacked ``(S, N, H, W,
    C)``, ``(S, N, H, W)`` and ``(S, N)`` inputs, ``losses`` the (S,) fp32
    losses. As in JAX, the S steps share (lr, l2, keep_prob): a learning
    rate schedule advances per dispatch. Each step keeps its own dropout
    and augmentation draws (those of its ``state.step``) and its own Adam
    ``t``, so S single compiled steps at the same scalars give the same
    state and losses. ``steps_per_dispatch < 1`` raises ``ValueError``;
    the rest as ``compile_train_step`` (no ``spatial_partition``, as in
    JAX; on a mesh of more than one position, S steps' cuts in turn)."""
    del num_classes, example_state, donate, use_pallas_ce
    if steps_per_dispatch < 1:
        raise ValueError("steps_per_dispatch must be >= 1")
    return _CompiledTrain(optimizer, multi=True, steps=steps_per_dispatch,
                          device=_device(device), compute_dtype=compute_dtype,
                          augment_fn=augment_fn, remat=remat, grad_accum=grad_accum,
                          ignore_label=ignore_label, class_weights=class_weights, mesh=mesh,
                          tensor_parallel=tensor_parallel)


class _CompiledForward(_CompiledStep):
    """A forward-only step ``fn(params, *inputs)`` under ``no_grad``,
    captured per params tree and input signature. With ``metrics`` (the
    eval step) the step also takes a metrics state, which is copied into
    the capture's accumulators before each replay and back after it, so
    the caller's tensors are updated in place. ``segmented``: ``fn`` issues
    collectives (a mesh of more than one position), and the capture is cut
    at them."""

    def __init__(self, fn, device: torch.device, metrics: bool = False,
                 segmented: bool = False):
        self.fn, self.device, self.metrics, self.segmented = fn, device, metrics, segmented
        self.captures = CaptureCache()

    def __call__(self, params: dict, *args):
        state, inputs = (args[0], args[1:]) if self.metrics else (None, args)
        held = tensors_of(params)
        _require_on(self.device, held, "the params")
        names = sorted(state) if self.metrics else []
        key = (binding(held), signature(inputs) + signature([state[k] for k in names]))
        entry = self.captures.lookup(key)
        if entry is None:
            with annotate("fcn8s.step.capture"):
                statics = [static_like(x, self.device) for x in inputs]
                acc = {k: static_like(state[k], self.device) for k in names}
                self._copy_in(statics, inputs, acc, state)
                body = partial(self._body, acc if self.metrics else None, statics)
                captured = capture(body, self.device, args=(params,),
                                   restore=list(acc.values()), segmented=self.segmented)
                entry = self.captures.add(key, CaptureEntry(captured, statics, held, acc))
        with annotate("fcn8s.step.copy_in"):
            self._copy_in(entry.statics, inputs, entry.acc, state)
        out = entry.captured.run(params)
        if not self.metrics:
            return out.clone()
        for k in names:
            state[k].copy_(entry.acc[k])
        return state

    @staticmethod
    def _copy_in(statics, inputs, acc, state) -> None:
        for buf, x in zip(statics, inputs):
            buf.copy_(x)
        for k, buf in acc.items():
            buf.copy_(state[k])

    def _body(self, acc, statics, params):
        with torch.no_grad():
            if acc is None:
                return self.fn(params, *statics)
            return self.fn(params, acc, *statics)


def compile_eval_step(mesh, num_classes: int, *, tensor_parallel: bool = True,
                      compute_dtype=torch.bfloat16, example_params=None,
                      spatial_partition: bool = False, ignore_label: int | None = None,
                      class_weights=None, device="cuda"):
    """``eval_step`` captured in a CUDA graph: returns ``step(params,
    metrics_state, images, label_ids, sample_mask) -> metrics_state``, the
    metrics state updated in place (JAX donates it) with ``eval_step``'s
    results bit for bit: K4f, K1 (K3 with ``ignore_label`` /
    ``class_weights``) and K5 inside the graph. A capture is made per params
    tree and input signature, so one step serves the live, the EMA and the
    int8 trees side by side (``graphs.MAX_CAPTURES`` captures, the least
    recently used evicted; a capture whose tree is gone is released).
    ``mesh``, ``tensor_parallel``, ``spatial_partition`` and ``device`` as
    in ``compile_train_step``: on a mesh of more than one position the
    graphs are cut at the loss normaliser's and the metric sums, at the
    Megatron pair's 'model' sum and at every halo exchange; JAX's
    ``example_params`` changes nothing."""
    del example_params
    _check_layout(spatial_partition, tensor_parallel)
    device = _device(device)
    fn = partial(eval_step, num_classes=num_classes, compute_dtype=compute_dtype,
                 ignore_label=ignore_label, class_weights=_class_weights(class_weights, device),
                 mesh=mesh, tensor_parallel=tensor_parallel, spatial_partition=spatial_partition)
    return _CompiledForward(fn, device, metrics=True, segmented=_segmented(mesh))


def compile_predict_step(mesh, *, argmax: bool = True, tensor_parallel: bool = True,
                         compute_dtype=torch.bfloat16, example_params=None,
                         spatial_partition: bool = False, id_dtype=torch.int32,
                         overlay_lut=None, quantized: bool = False, device="cuda"):
    """``predict_step`` captured in a CUDA graph: returns ``step(params,
    images)`` -> ids, softmax or overlay (a fresh tensor on the device),
    ``predict_step``'s result bit for bit. ``quantized``: ``params`` is the
    int8 tree (``apply_fcn8s_int8``; on a mesh, cut at dynamic int8's
    per-layer absmax sums too). The output of the whole batch is gathered
    over the mesh inside the step (cut at the gathers). The rest as
    ``compile_eval_step``."""
    del example_params
    _check_layout(spatial_partition, tensor_parallel)
    fn = partial(predict_step, argmax=argmax, compute_dtype=compute_dtype, id_dtype=id_dtype,
                 overlay_lut=overlay_lut, quantized=quantized, mesh=mesh,
                 tensor_parallel=tensor_parallel, spatial_partition=spatial_partition)
    return _CompiledForward(fn, _device(device), segmented=_segmented(mesh))


def compile_tta_step(mesh, *, scale_hw=None, flip: bool = True, tensor_parallel: bool = True,
                     compute_dtype=torch.bfloat16, example_params=None, quantized: bool = False,
                     device="cuda"):
    """``tta_step`` for one scale captured in a CUDA graph: returns
    ``step(params, images)`` -> (N, H, W, C) fp32 mean probabilities (a
    fresh tensor), ``tta_step``'s result bit for bit. The rest as
    ``compile_predict_step`` (no ``spatial_partition``, as in JAX)."""
    del example_params
    fn = partial(tta_step, scale_hw=scale_hw, flip=flip, compute_dtype=compute_dtype,
                 quantized=quantized, mesh=mesh, tensor_parallel=tensor_parallel)
    return _CompiledForward(fn, _device(device), segmented=_segmented(mesh))
