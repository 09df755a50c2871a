"""The collectives of the mesh (``parallel/mesh.py``), over one axis's group.

* The Megatron pair, as ``torch.autograd.Function``s over the 'model'
  group: ``copy_to_model`` (identity forward, all-reduce backward; before
  the column-parallel fc6, whose input is replicated) and
  ``reduce_from_model`` (all-reduce forward, identity backward; on fc7's
  partial sums, before its bias).
* Over 'data': the in-place sums of gradients, loss normalisers and
  metrics (``all_reduce``), the concatenation of predict outputs
  (``all_gather_cat``), and the object broadcast of a rank-0 result.

On an axis of one position every function returns its input and launches
nothing, so a (1, 1) mesh runs the single-card code exactly. The calls are
the ones the gloo backend takes on CUDA tensors as well as on CPU tensors
(``all_reduce``, ``all_gather``, ``broadcast_object_list``, ``barrier``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh


def all_reduce(t: torch.Tensor, mesh: Mesh | None, axis: str = DATA_AXIS,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``axis`` in place (SUM by default) and return it."""
    group = None if mesh is None else mesh.group(axis)
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_flat(tensors: list, mesh: Mesh | None, axis: str = DATA_AXIS) -> list:
    """Sum a list of same-dtype tensors over ``axis`` through one flat
    buffer (one collective instead of one per tensor); returns tensors of
    the same shapes."""
    if mesh is None or mesh.group(axis) is None or not tensors:
        return tensors
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh, axis)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                               tensors)]


def all_gather_cat(t: torch.Tensor, mesh: Mesh | None, axis: str = DATA_AXIS,
                   dim: int = 0) -> torch.Tensor:
    """Every position's ``t`` along ``axis``, concatenated on ``dim`` in
    axis order (each position's ``t`` has the same shape)."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast_object(obj, mesh: Mesh | None):
    """Rank 0's ``obj`` (picklable) on every rank of the mesh."""
    if mesh is None or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0,
                               device=mesh.device if dist.get_backend() == "nccl" else None)
    return box[0]


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of the mesh (after rank 0 wrote a file)."""
    if mesh is not None and mesh.size > 1:
        dist.barrier()


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward over 'model'."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward over 'model', identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        y = x.contiguous()
        if y is x:  # reduced in place
            ctx.mark_dirty(x)
        return all_reduce(y, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The replicated input of a column-parallel layer (``f``)."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over 'model' of a row-parallel layer's partial results (``g``)."""
    return _ReduceFromModel.apply(x, mesh)
