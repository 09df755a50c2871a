"""Checkpoints in the JAX package's format: save, restore, best-only pruning.

Port of ``fcn8s_tensorflow_tpu/engine/checkpoint.py`` with its public names
and its on-disk layout, so one checkpoint loads in both packages: a
directory holding ``checkpoint.msgpack`` (flax's msgpack of the payload,
written and read by ``engine/msgpack.py`` without flax) and
``metadata.json`` (``model_config``, ``format_version``, ``param_paths``
and the facade's bookkeeping). The payload:

* ``params_leaves``: the params in JAX's flatten order (keys sorted at
  every level: ``decoder`` before ``encoder``, ``bias`` before ``kernel``)
  and JAX's layout (HWIO convolution kernels, deconv kernels as they are),
  fp32; ``param_paths`` names them;
* ``step``: the global step, a 0-d int32;
* ``opt_leaves``: the leaves of the optax state of the JAX package's
  ``make_optimizer``: ``[count, learning_rate]`` of its
  ``inject_hyperparams`` wrapper, then for adam and adamw Adam's count, mu
  and nu (each in the params' order and layout), for momentum the trace,
  for sgd nothing (global-norm clipping and weight decay hold no state).
  The port's ``OptimizerState`` carries the same values;
* ``ema_leaves``: the EMA average of ``train(ema_decay=...)``, in the
  params' order and layout (absent when no average is kept).

Writers take the port's ``TrainState`` (or a bare port params tree) and
convert on the way out; readers return port trees on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from .. import bridge
from ..parallel.steps import Optimizer, OptimizerState, ScaleByAdamTF1State, TrainState
from . import msgpack

# Bump on any incompatible change to the on-disk layout; equal to the JAX
# package's. Readers accept <= their own version and reject newer ones;
# checkpoints written before the field existed load as v1.
CHECKPOINT_FORMAT_VERSION = 1

PAYLOAD = "checkpoint.msgpack"
MANIFEST = "metadata.json"


def _check_format_version(meta: dict, directory: str) -> None:
    version = int(meta.get("format_version", 1))
    if version > CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f"checkpoint at '{directory}' has format_version {version}, but this "
            f"build reads <= {CHECKPOINT_FORMAT_VERSION} — upgrade the library "
            "or re-save the checkpoint with a matching version"
        )


def compose_checkpoint_name(
    name: str | None = None,
    global_step: int | None = None,
    training_loss: float | None = None,
    eval_dataset: str | None = None,
    metric_values: dict | None = None,
) -> str:
    """The reference's directory naming scheme, as in the JAX package."""
    model_name = "saved_model"
    if name:
        model_name += "_" + name
    if global_step is not None:
        model_name += f"_(globalstep-{global_step})"
    if training_loss is not None:
        model_name += f"_(trainloss-{training_loss:.4f})"
    if metric_values:
        if eval_dataset is not None:
            model_name += f"_(eval_on_{eval_dataset}_dataset)"
        for metric_name, value in metric_values.items():
            model_name += f"_({metric_name}-{value:.4f})"
    if model_name == "saved_model":
        model_name += f"_{time.time()}"
    return model_name


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _in_jax_order(tensors: list, params: dict, copy: bool) -> list:
    """``tensors`` (aligned with ``bridge.param_leaves(params)``) in JAX's
    order and layout; with ``copy`` each is a fresh contiguous copy on its
    device."""
    paths = bridge.jax_leaf_paths(params)
    out = []
    for i in bridge.jax_order(params):
        t = bridge.leaf_to_jax(tensors[i].detach(), paths[i])
        out.append(t.clone(memory_format=torch.contiguous_format) if copy else t)
    return out


def _opt_leaves(opt_state: OptimizerState, params: dict, copy: bool) -> list:
    leaves = [np.asarray(opt_state.count, np.int32),
              np.asarray(opt_state.learning_rate, np.float32)]
    inner = opt_state.inner
    if isinstance(inner, ScaleByAdamTF1State):
        leaves += [np.asarray(inner.count, np.int32), *_in_jax_order(inner.mu, params, copy),
                   *_in_jax_order(inner.nu, params, copy)]
    elif inner is not None:  # momentum traces
        leaves += _in_jax_order(inner, params, copy)
    return leaves


def _payload(state, ema, copy: bool) -> tuple[dict, list[str]]:
    """The payload (tensors still on their device) and its ``param_paths``.
    ``state`` is a ``TrainState`` whose ``opt_state`` is an
    ``OptimizerState``, or a bare port params tree; ``ema`` a port tree of
    the params' structure, or None."""
    params = state.params if isinstance(state, TrainState) else state
    leaves = bridge.param_leaves(params)
    payload = {"params_leaves": _in_jax_order(leaves, params, copy)}
    if isinstance(state, TrainState):
        payload["step"] = np.asarray(state.step, np.int32)
        payload["opt_leaves"] = _opt_leaves(state.opt_state, params, copy)
    if ema is not None:
        payload["ema_leaves"] = _in_jax_order(bridge.param_leaves(ema), params, copy)
    paths = bridge.jax_leaf_paths(params)
    return payload, [paths[i] for i in bridge.jax_order(params)]


def _write(directory: str, payload: dict, param_paths: list[str], metadata: dict,
           ready=None) -> None:
    """Write the payload (CUDA tensors streamed to the file, read after the
    event ``ready`` or the caller's current stream) and the manifest."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, PAYLOAD), "wb") as f:
        msgpack.dump(payload, f, ready=ready)
    metadata = dict(metadata)
    metadata["format_version"] = CHECKPOINT_FORMAT_VERSION
    metadata["param_paths"] = param_paths
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(metadata, f, indent=2, default=float)


def save_checkpoint(directory: str, state, metadata: dict, *, max_to_keep: int | None = None,
                    ema_params=None) -> str:
    """Serialize a ``TrainState`` (or a bare port params tree) into
    ``directory``: ``checkpoint.msgpack`` + ``metadata.json``. Returns the
    directory. With ``max_to_keep``, the oldest sibling checkpoints beyond
    the limit are pruned (by mtime). ``ema_params``: the EMA average (a
    port tree of the params' structure), written as ``ema_leaves``."""
    payload, paths = _payload(state, ema_params, copy=False)
    _write(directory, payload, paths, metadata)
    if max_to_keep is not None:
        _prune_old_checkpoints(os.path.dirname(directory.rstrip("/")), max_to_keep)
    return directory


def _prune_old_checkpoints(parent: str, max_to_keep: int) -> None:
    if not parent or not os.path.isdir(parent):
        return
    checkpoints = [
        os.path.join(parent, d)
        for d in os.listdir(parent)
        # in-flight async writes (.tmp) and replaced-aside old versions
        # (.old) are not checkpoints
        if not d.endswith((".tmp", ".old"))
        and os.path.isfile(os.path.join(parent, d, PAYLOAD))
    ]
    checkpoints.sort(key=os.path.getmtime)
    for stale in checkpoints[:-max_to_keep]:
        shutil.rmtree(stale, ignore_errors=True)


def save_checkpoint_async(directory: str, state, metadata: dict, *,
                          max_to_keep: int | None = None,
                          ema_params=None) -> threading.Thread:
    """Non-blocking ``save_checkpoint``. Returns a started
    ``threading.Thread``; ``join()`` it before reading the checkpoint, and
    read its ``exc`` (None, or the exception the write raised).

    The port's optimizer updates params and moments IN PLACE, and the EMA
    update its average, so the writer
    never reads the live tensors: here, on the caller's current stream,
    every payload tensor is copied (in its JAX layout) on its device, and an
    event is recorded behind the copies. The writer thread streams that
    snapshot to the file through pinned buffers on a stream of its own,
    which waits for the event (the train loop keeps its stream and is not
    stalled by the copies), into ``directory + '.tmp'``, which is then
    renamed into place: an existing checkpoint of
    the same name is renamed aside first and deleted last, so at every
    instant one complete checkpoint is visible to ``latest_checkpoint``.
    The snapshot costs one transient state-sized device allocation."""
    with torch.no_grad():
        payload, paths = _payload(state, ema_params, copy=True)
    tensors = [x for v in payload.values() for x in (v if isinstance(v, list) else [v])
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"]
    ready = None
    if tensors:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(tensors[0].device))

    def _write_async():
        try:
            tmp = directory.rstrip("/") + ".tmp"
            old = directory.rstrip("/") + ".old"
            _write(tmp, payload, paths, metadata, ready=ready)
            # crash-safe replace: rename the old checkpoint aside (atomic),
            # promote the new one (atomic), then delete the old; a stale
            # `.old` is removed only while `directory` itself exists
            if os.path.isdir(directory):
                if os.path.isdir(old):
                    shutil.rmtree(old)
                os.rename(directory, old)
            os.rename(tmp, directory)
            shutil.rmtree(old, ignore_errors=True)
            if max_to_keep is not None:
                _prune_old_checkpoints(os.path.dirname(directory.rstrip("/")), max_to_keep)
        except BaseException as exc:  # surfaced by the joiner, never swallowed
            thread.exc = exc

    thread = threading.Thread(target=_write_async, name="ckpt-writer", daemon=True)
    thread.exc = None
    thread.start()
    return thread


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def load_metadata(directory: str) -> dict:
    with open(os.path.join(directory, MANIFEST)) as f:
        return json.load(f)


def _read(directory: str) -> tuple[dict, dict]:
    """(payload, manifest), the format version checked."""
    meta = load_metadata(directory)
    _check_format_version(meta, directory)
    return msgpack.load(os.path.join(directory, PAYLOAD)), meta


def _leaf_list(leaves) -> list:
    return list(leaves.values()) if isinstance(leaves, dict) else list(leaves)


def _tree_from_paths(directory: str, paths, leaves) -> dict:
    if not paths:
        raise ValueError(
            f"checkpoint at '{directory}' has no param_paths manifest "
            "entry — re-save it with this library version first")
    if len(paths) != len(leaves):
        raise ValueError(
            f"checkpoint at '{directory}' has {len(leaves)} leaves but "
            f"{len(paths)} param_paths — corrupt manifest?")
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        _set_path(tree, path, leaf)
    return tree


def _set_path(tree: dict, path: str, leaf) -> None:
    """``tree[a][b][c] = leaf`` for ``path`` 'a/b/c', creating the dicts."""
    *parents, last = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[last] = leaf


def load_params_tree(directory: str) -> tuple:
    """Rebuild the nested JAX-layout params dict (numpy leaves) from the
    manifest's ``param_paths`` alone — no live model needed. Returns
    ``(params_tree, metadata)``."""
    raw, meta = _read(directory)
    return _tree_from_paths(directory, meta.get("param_paths"),
                            _leaf_list(raw["params_leaves"])), meta


def _to_port_leaves(leaves: list, params: dict, jax_paths: list[str], what: str) -> list:
    """Checkpoint leaves aligned with ``jax_paths`` -> CPU tensors in the
    port's layout, aligned with ``bridge.param_leaves(params)``."""
    by_path = dict(zip(jax_paths, leaves))
    out = []
    for path, like in zip(bridge.jax_leaf_paths(params), bridge.param_leaves(params)):
        t = bridge.leaf_from_jax(torch.from_numpy(np.array(by_path[path])), path)
        if t.shape != like.shape:
            raise ValueError(f"checkpoint {what} leaf {path} has shape {tuple(t.shape)}, "
                             f"expected {tuple(like.shape)}")
        out.append(t)
    return out


def _opt_state_from_leaves(leaves: list, optimizer: Optimizer, params: dict,
                           jax_paths: list[str]) -> OptimizerState:
    n = len(jax_paths)
    inner_leaves = {"adam": 1 + 2 * n, "adamw": 1 + 2 * n, "momentum": n, "sgd": 0}[optimizer.name]
    if len(leaves) != 2 + inner_leaves:
        raise ValueError(
            f"checkpoint has {len(leaves)} optimizer leaves but '{optimizer.name}' "
            f"expects {2 + inner_leaves} — optimizer config mismatch?")
    count, lr, rest = int(leaves[0]), float(leaves[1]), leaves[2:]
    if optimizer.name in ("adam", "adamw"):
        inner = ScaleByAdamTF1State(
            count=int(rest[0]), mu=_to_port_leaves(rest[1:1 + n], params, jax_paths, "mu"),
            nu=_to_port_leaves(rest[1 + n:], params, jax_paths, "nu"))
    elif optimizer.name == "momentum":
        inner = _to_port_leaves(rest, params, jax_paths, "trace")
    else:
        inner = None
    return OptimizerState(count=count, learning_rate=lr, inner=inner)


def load_checkpoint(directory: str, optimizer: Optimizer | None = None) -> dict:
    """Restore a checkpoint on the CPU: ``{'params'``: the port's fp32 tree
    (in JAX's key order), ``'step'``: int or None, ``'opt_state'``: an
    ``OptimizerState`` for ``optimizer`` (None without one or without
    optimizer leaves), ``'ema'``: the EMA average as a port tree of the
    params' structure, or None, ``'metadata'``: the manifest``}``."""
    raw, meta = _read(directory)
    paths = meta.get("param_paths")
    tree = _tree_from_paths(directory, paths, _leaf_list(raw["params_leaves"]))
    params = bridge.to_port(tree)
    out = {"params": params, "step": None, "opt_state": None, "ema": None, "metadata": meta}
    if "step" in raw:
        out["step"] = int(raw["step"])
    if optimizer is not None and "opt_leaves" in raw:
        out["opt_state"] = _opt_state_from_leaves(_leaf_list(raw["opt_leaves"]), optimizer,
                                                  params, paths)
    if "ema_leaves" in raw:
        leaves = _leaf_list(raw["ema_leaves"])
        if len(leaves) != len(paths):
            raise ValueError(f"checkpoint has {len(leaves)} EMA leaves but {len(paths)} params")
        ema = iter(_to_port_leaves(leaves, params, paths, "EMA"))
        out["ema"] = {part: {name: {k: next(ema) for k in layer} for name, layer in layers.items()}
                      for part, layers in params.items()}
    return out


def _flatten_paths(tree: dict, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) pairs of a nested dict in JAX's flatten order."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out += _flatten_paths(value, path + "/")
        else:
            out.append((path, value))
    return out


def load_params_only(directory: str, example_params: dict) -> dict:
    """Restore just the params, matched by path into the structure of
    ``example_params`` (a JAX-layout nested dict whose leaves have
    ``.shape``, e.g. ``bridge.to_numpy(model.params)`` or only its
    ``encoder``), so partial restores work. Returns that structure with
    numpy leaves (the reference's ``load_variables``)."""
    tree, _ = load_params_tree(directory)
    by_path = dict(_flatten_paths(tree))
    out: dict = {}
    for path, want in _flatten_paths(example_params):
        if path not in by_path:
            raise ValueError(f"checkpoint does not contain parameter '{path}'")
        got = np.array(by_path[path])
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint leaf shape {got.shape} != expected "
                             f"{tuple(want.shape)}")
        _set_path(out, path, got)
    return out


def describe_checkpoint(directory: str) -> str:
    """Human-readable summary of a checkpoint (manifest + leaf inventory),
    the same text as the JAX package's. CLI:

        python -m fcn8s_tensorflow_tpu_torch.engine.checkpoint <dir-or-parent>
    """
    if not os.path.isfile(os.path.join(directory, PAYLOAD)):
        latest = latest_checkpoint(directory)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        directory = latest
    meta = load_metadata(directory)
    raw = msgpack.load(os.path.join(directory, PAYLOAD))
    leaves = _leaf_list(raw["params_leaves"])
    n_params = sum(int(np.prod(tuple(x.shape))) for x in leaves)
    lines = [f"checkpoint: {directory}"]
    for key in ("model_config", "global_step", "training_loss", "eval_dataset",
                "metrics", "saved_at"):
        if key in meta:
            lines.append(f"  {key}: {meta[key]}")
    lines.append(f"  params: {len(leaves)} leaves, {n_params:,} values"
                 + (", + optimizer state" if "opt_leaves" in raw else "")
                 + (", + EMA average" if "ema_leaves" in raw else ""))
    paths = meta.get("param_paths") or []
    for p, x in zip(paths, leaves):
        lines.append(f"    {p:<45} {tuple(int(d) for d in x.shape)}")
    return "\n".join(lines)


def latest_checkpoint(parent: str) -> str | None:
    """Most recent checkpoint directory under ``parent`` (by mtime). An
    in-flight async write (``.tmp``) is skipped; a renamed-aside ``.old`` is
    a complete checkpoint and stays visible (the fallback if a crash hit
    between the rename-aside and the promote)."""
    if not os.path.isdir(parent):
        return None
    candidates = [
        os.path.join(parent, d)
        for d in os.listdir(parent)
        if not d.endswith(".tmp") and os.path.isfile(os.path.join(parent, d, PAYLOAD))
    ]

    def _mtime(p):
        # a transient `.old` can vanish between the listdir and this stat
        try:
            return os.path.getmtime(p)
        except OSError:
            return float("-inf")

    candidates = [c for c in candidates if _mtime(c) != float("-inf")]
    return max(candidates, key=_mtime) if candidates else None


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 2:
        print("usage: python -m fcn8s_tensorflow_tpu_torch.engine.checkpoint <dir>")
        raise SystemExit(1)
    print(describe_checkpoint(sys.argv[1]))
