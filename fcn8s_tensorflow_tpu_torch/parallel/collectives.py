"""The collectives of the mesh (``parallel/mesh.py``), over one axis's group.

* The Megatron pair, as ``torch.autograd.Function``s over the 'model'
  group: ``copy_to_model`` (identity forward, all-reduce backward; before
  the column-parallel fc6, whose input is replicated) and
  ``reduce_from_model`` (all-reduce forward, identity backward; on fc7's
  partial sums, before its bias).
* Over 'data' (or ``ALL_AXES``, the whole mesh, under spatial
  partitioning): the in-place sums of gradients, loss normalisers and
  metrics (``all_reduce``), the concatenation of predict outputs
  (``all_gather_cat``; along the width over 'model', ``gather_width``), the
  object broadcast of a rank-0 result, and the tensor broadcast that
  carries the serving controller's commands (``broadcast``).
* ``halo_exchange``, over 'model' under spatial partitioning: a
  width-sharded activation extended by its neighbours' edge columns before
  a convolution, and the halo's gradient sent back and added where those
  columns live. It is built on ``all_gather`` of each rank's edges, which
  gloo takes on CUDA tensors; point-to-point sends would move less.

On an axis of one position every function returns its input and launches
nothing, so a (1, 1) mesh runs the single-card code exactly. The calls are
the ones the gloo backend takes on CUDA tensors as well as on CPU tensors
(``all_reduce``, ``all_gather``, ``broadcast``, ``broadcast_object_list``,
``barrier``).

The cut points of a segmented capture (``parallel/graphs.py``): every
``all_reduce`` and ``all_gather`` of a step goes through ``_issue`` as a
``Collective`` on the buffers it reads and writes. Outside a capture it runs
at once. While a compiled step is captured over a mesh, ``segmenter`` is
set and takes it instead: the work before it ends up in one CUDA graph, the
collective joins the step's plan on those same buffers, and the work after
it goes into the next graph. A step computes its gradients through ``grad``,
so a collective that autograd reaches in a backward (``_CopyToModel``,
``_HaloExchange``, a recomputed block) is cut the same way.
``broadcast``, ``broadcast_object`` and ``barrier`` run outside every step
and are never cut.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.profiling import annotate
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, WidthSplit


class Collective:
    """One ``all_reduce`` (``tensor`` reduced in place with ``op``) or
    ``all_gather`` (every position's ``tensor`` into ``parts``) over
    ``group``, held with its buffers, so that a captured step can issue it
    again between two graphs on the same addresses. Each ``run`` is the span
    ``fcn8s.mesh.<kind>`` under a profiler."""

    def __init__(self, kind: str, tensor: torch.Tensor, group, op=None, parts=None):
        self.kind, self.tensor, self.group, self.op, self.parts = kind, tensor, group, op, parts
        self.span = "fcn8s.mesh." + kind

    def run(self) -> None:
        with annotate(self.span):
            if self.kind == "all_reduce":
                dist.all_reduce(self.tensor, op=self.op, group=self.group)
            else:
                dist.all_gather(self.parts, self.tensor, group=self.group)

    def describe(self) -> tuple:
        """(kind, reduce op, shape, dtype, the group's ranks): what the call
        does, for comparing the collectives of two runs."""
        return describe_call(self.kind, self.tensor, self.group, self.op)


def describe_call(kind: str, tensor: torch.Tensor, group, op=None) -> tuple:
    """``Collective.describe`` of a ``dist.all_reduce`` (``op``) or
    ``dist.all_gather`` call on ``tensor`` over ``group``."""
    op = None if kind != "all_reduce" else str(dist.ReduceOp.SUM if op is None else op)
    return (kind, op, tuple(tensor.shape), str(tensor.dtype),
            tuple(dist.get_process_group_ranks(group)))


# the segmented capture in progress (``parallel/graphs.py``), or None
segmenter = None


def _issue(collective: Collective) -> None:
    """Run ``collective``, or hand it to the segmented capture in progress."""
    cut = segmenter
    if cut is None:
        collective.run()
    else:
        cut.cut(collective)


def grad(outputs, inputs) -> tuple:
    """``torch.autograd.grad(outputs, inputs)``; inside a segmented capture,
    on a thread of its own, so that the capturing thread stays free to cut
    at the collectives that the backward reaches."""
    cut = segmenter
    if cut is None:
        return torch.autograd.grad(outputs, inputs)
    return cut.grad(outputs, inputs)


def all_reduce(t: torch.Tensor, mesh: Mesh | None, axis: str = DATA_AXIS,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``axis`` in place (SUM by default) and return it."""
    group = None if mesh is None else mesh.group(axis)
    if group is not None:
        _issue(Collective("all_reduce", t, group, op=op))
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
    _issue(Collective("all_gather", t, group, parts=parts))
    return torch.cat(parts, dim=dim)


def gather_width(t: torch.Tensor, split: WidthSplit | None, dim: int) -> torch.Tensor:
    """The full-width tensor from every 'model' position's columns of it
    along ``dim`` (positions may differ in width: each block is padded to
    the widest for the all-gather and trimmed after). No split: ``t``."""
    if split is None:
        return t
    widths = split.widths(t.shape[dim])
    top = max(widths)
    t = t.contiguous()
    if t.shape[dim] < top:
        pad = list(t.shape)
        pad[dim] = top - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    parts = _all_gather_raw(t, split.mesh, MODEL_AXIS)
    return torch.cat([p.narrow(dim, 0, w) for p, w in zip(parts, widths)], dim=dim)


def _all_gather_raw(t: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """Every position's contiguous ``t`` along ``axis``, moved as bytes: the
    gather copies data and computes nothing, so it takes any dtype (bf16
    and int8 included) whatever the backend's own type list."""
    raw = t.contiguous().view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.shape[axis])]
    _issue(Collective("all_gather", raw, mesh.group(axis), parts=parts))
    return [p.view(t.dtype) for p in parts]


def _halo_forward(x: torch.Tensor, h: int, mesh: Mesh, widths: list) -> torch.Tensor:
    """``x`` (N, C, H, w) -> (N, C, H, h + w + h), channels_last: the ``h``
    columns left and right of this rank's block in the whole width, zero
    beyond its two ends. Each rank contributes its first and last
    ``min(h, w)`` columns (its whole block where it is narrower than ``h``),
    so a halo wider than a neighbour's block is filled from further ranks."""
    n, c, rows, w = x.shape
    j = mesh.coords[MODEL_AXIS]
    starts = [sum(widths[:r]) for r in range(len(widths))]
    lo, hi = starts[j], starts[j] + w
    e = min(h, w)
    edges = x.new_zeros((n, c, rows, 2 * h))
    edges[..., :e] = x[..., :e]
    edges[..., 2 * h - e:] = x[..., w - e:]
    parts = _all_gather_raw(edges, mesh, MODEL_AXIS)
    halo_exchange.bytes += edges.nbytes * (len(parts) - 1)
    out = torch.empty((n, c, rows, w + 2 * h), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    out[..., h:h + w] = x
    out[..., :h] = 0
    out[..., h + w:] = 0
    for r, part in enumerate(parts):
        if r == j:
            continue
        er = min(h, widths[r])
        # rank r's first er columns sit at edges[:er], its last er at edges[2h - er:]
        for src_lo, at in ((starts[r], 0), (starts[r] + widths[r] - er, 2 * h - er)):
            for win_lo, out_at in ((lo - h, 0), (hi, h + w)):  # the left and right halo
                a, b = max(src_lo, win_lo), min(src_lo + er, win_lo + h)
                if a < b:
                    out[..., out_at + a - win_lo:out_at + b - win_lo] = (
                        part[..., at + a - src_lo:at + b - src_lo])
    return out


def _halo_backward(g: torch.Tensor, h: int, mesh: Mesh, widths: list) -> torch.Tensor:
    """The adjoint of ``_halo_forward``: this rank's block of ``g`` plus
    the halo gradients of every rank whose halo covers its columns."""
    n, c, rows, w2 = g.shape
    w = w2 - 2 * h
    j = mesh.coords[MODEL_AXIS]
    starts = [sum(widths[:r]) for r in range(len(widths))]
    lo, hi = starts[j], starts[j] + w
    halos = torch.cat([g[..., :h], g[..., h + w:]], dim=3)
    parts = _all_gather_raw(halos, mesh, MODEL_AXIS)
    halo_exchange.bytes += halos.nbytes * (len(parts) - 1)
    gx = torch.empty((n, c, rows, w), dtype=g.dtype, device=g.device,
                     memory_format=torch.channels_last)
    gx.copy_(g[..., h:h + w])
    for r, part in enumerate(parts):
        if r == j:
            continue
        r_lo, r_hi = starts[r], starts[r] + widths[r]
        for win_lo, at in ((r_lo - h, 0), (r_hi, h)):  # rank r's left and right halo
            a, b = max(win_lo, lo), min(win_lo + h, hi)
            if a < b:
                gx[..., a - lo:b - lo] += part[..., at + a - win_lo:at + b - win_lo]
    return gx


class _HaloExchange(torch.autograd.Function):
    """``halo_exchange`` under autograd: the forward fills the halo from the
    neighbours, the backward adds the halo's gradient where it came from."""

    @staticmethod
    def forward(ctx, x, h, mesh, widths):
        ctx.h, ctx.mesh, ctx.widths = h, mesh, widths
        return _halo_forward(x, h, mesh, widths)

    @staticmethod
    def backward(ctx, g):
        return _halo_backward(g, ctx.h, ctx.mesh, ctx.widths), None, None, None


def halo_exchange(x: torch.Tensor, h: int, split: WidthSplit) -> torch.Tensor:
    """This rank's width block ``x`` (N, C, H, w) of an activation split over
    'model' (``split``, at any level of the model), extended by ``h``
    columns on each side from the blocks around it (zeros beyond the whole
    width's ends: SAME padding), as a new channels_last tensor
    (N, C, H, w + 2h). A convolution of kernel width ``2h + 1`` with no
    width padding (``ops.nn.conv2d(..., halo=True)``) then gives this
    rank's columns of the unsharded convolution. The halo may reach past a
    neighbour narrower than ``h`` into the ranks beyond. Backward: the halo
    columns' gradients go back to the ranks that own them and are added
    there. A collective over 'model': every rank calls it, in the same
    order. ``halo_exchange.bytes`` counts the bytes this rank receives,
    forward and backward."""
    if h == 0:
        return x
    return _HaloExchange.apply(x, h, split.mesh, split.widths(x.shape[3]))


halo_exchange.bytes = 0


def _transport(mesh: Mesh) -> torch.device:
    """Where a broadcast's tensor travels: the card under NCCL, the host
    under gloo."""
    return mesh.device if dist.get_backend() == "nccl" else torch.device("cpu")


def broadcast_object(obj, mesh: Mesh | None):
    """Rank 0's ``obj`` (picklable) on every rank of the mesh."""
    if mesh is None or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_transport(mesh))
    return box[0]


def broadcast(tensor: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Rank 0's ``tensor`` on every rank of the mesh: each rank passes a
    tensor of the same shape and dtype (the others' contents are not read)
    and gets rank 0's, on the group's transport device (``_transport``);
    ``tensor`` itself on a mesh of one position."""
    if mesh is None or mesh.size == 1:
        return tensor
    wire = tensor.to(_transport(mesh)).contiguous()
    dist.broadcast(wire, src=0)
    return wire


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
