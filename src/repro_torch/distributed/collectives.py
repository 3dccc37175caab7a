"""Collectives over mesh axes for the port's SPMD steps: what GSPMD
inserts into the reference's programs, issued by hand.

Each function takes a tensor, a mesh and a tuple of its axis names (split
jointly, the first the slowest, as in a ``PartitionSpec`` entry):

  * :func:`all_gather` — blocks along ``dim`` into the whole; its backward
    is a reduce-scatter (the cotangents summed over the group, each rank
    keeping its block);
  * :func:`all_reduce` — the sum over the group on every rank; its
    backward is the same sum of the cotangents;
  * :func:`reduce_scatter` — the sum over the group, each rank keeping its
    block along ``dim``; its backward is the all-gather of the cotangents;
  * :func:`all_reduce_` — the in-place sum of a gradient, outside autograd;
  * :func:`all_reduce_max` — the elementwise max over the group, outside
    autograd (a distributed softmax's row max in decode).

On a ``DeviceMesh`` they run over the process group of those axes (a
flattened group for two or more).  On an :class:`AbstractMesh` they are
shape-only, for the dry-run's meta tensors: the result has the shape it
would have and nothing moves.  An axis set of size 1 is the identity.
Every call that moves data adds its result's bytes to
:data:`COLLECTIVE_BYTES` under its kind (the reference's convention: the
result shape's bytes), which the roofline's collective term reads.

Under ``gloo`` (the CPU ranks of the tests, and ranks that share one card)
the collectives run on the tensors where they lie: gloo takes all-gather
and all-reduce on CUDA tensors, and a reduce-scatter is an all-reduce and
a slice.  No compute leaves the card.

Tensor parallelism.  A step builder hands a layer the blocks of its
weights that hold this rank's heads, units or vocabulary rows, each
marked with a :class:`Split` (:func:`split_of`).  The layers compute on
what they are given, and join the partial results with :func:`tp_sum`
(a norm's statistics), :func:`tp_reduce` (after a product whose
contraction dim is split: ``layers.matmul`` does it itself) or
:func:`tp_gather` (the vocabulary-parallel logits), all over the active
step's "model" axes and the identity outside a mesh.

Sequence parallelism (Megatron-SP).  While a layer runs on a residual
stream split by sequence over "model" (``context.sequence_parallel``),
:func:`tp_stream` all-gathers its normed rows into the whole sequence
before the column-parallel products, :func:`tp_reduce` ends each
row-parallel product in a reduce-scatter on the sequence (an all-reduce
outside it), and :func:`tp_rows` keeps this rank's rows of an output
computed whole.

Every rank differentiates its own copy of the loss, and the backward of a
collective sums cotangents over its group (the all-gather's reduce-scatter
keeps each rank's block of that sum, the reduce-scatter's all-gather
joins the blocks).  So each rank's gradient of a tensor
it holds whole is its part of the gradient, and the step sums those over
the axes the tensor is replicated on (``launch.steps``): no other
collective is needed in the backward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.context import (AbstractMesh, axis_sizes,
                                             current_mesh, sp_seq, tp_axes)

#: bytes of the results of the collectives issued since the last reset
COLLECTIVE_BYTES = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}


def reset_counts() -> None:
    for k in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[k] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def group_size(mesh, axes: tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def group_rank(mesh, axes: tuple[str, ...]) -> int:
    """This rank's row-major index over ``axes``."""
    sizes, idx = axis_sizes(mesh), 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _mesh_order(mesh, axes: tuple[str, ...]) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in axes)


def process_group(mesh, axes: tuple[str, ...]):
    """The process group of ``axes`` of a ``DeviceMesh`` (flattened when
    there are several; its ranks in the mesh's order of the axes, which a
    ``DeviceMesh`` slices only in that order)."""
    axes = _mesh_order(mesh, axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if tuple(mesh.mesh_dim_names) == tuple(axes):
        return mesh._flatten().get_group()
    return mesh[tuple(axes)]._flatten().get_group()


def _group_order(mesh, axes: tuple[str, ...]) -> list[int]:
    """For each block index in ``axes``' order (the first the slowest),
    the rank of the group :func:`process_group` gives that holds it."""
    order = _mesh_order(mesh, axes)
    sizes = axis_sizes(mesh)
    out = []
    for idx in range(math.prod(sizes[a] for a in axes)):
        coord = {}
        for a in reversed(axes):
            idx, coord[a] = divmod(idx, sizes[a])
        k = 0
        for a in order:
            k = k * sizes[a] + coord[a]
        out.append(k)
    return out


def _gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    n = group_size(mesh, axes)
    if isinstance(mesh, AbstractMesh):
        out = torch.cat([x] * n, dim=dim)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=process_group(mesh,
                                                                     axes))
        out = torch.cat([parts[k] for k in _group_order(mesh, axes)],
                        dim=dim)
    COLLECTIVE_BYTES["all-gather"] += _nbytes(out)
    return out


def _all_reduce_on(out: torch.Tensor, mesh, axes, op=None
                   ) -> torch.Tensor:
    """``out`` reduced over ``axes`` in place."""
    if not isinstance(mesh, AbstractMesh):
        kw = {} if op is None else {"op": op}
        dist.all_reduce(out, group=process_group(mesh, axes), **kw)
    return out


def _reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    out = _all_reduce_on(x.clone(), mesh, axes)
    COLLECTIVE_BYTES["all-reduce"] += _nbytes(out)
    return out


def _scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The sum over the group of ``x``, each rank keeping its block along
    ``dim``: ``reduce_scatter_tensor`` under NCCL, a sum then a slice under
    gloo (which has no reduce-scatter)."""
    n, r = group_size(mesh, axes), group_rank(mesh, axes)
    size = x.shape[dim] // n
    if isinstance(mesh, AbstractMesh):
        out = x.narrow(dim, r * size, size).clone()
    else:
        group = process_group(mesh, axes)
        if dist.get_backend(group) == "nccl":
            src = x.movedim(dim, 0).contiguous()
            out = torch.empty((size, *src.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, src, group=group)
            out = out.movedim(0, dim)
        else:
            full = _all_reduce_on(x.contiguous().clone(), mesh, axes)
            out = full.narrow(dim, r * size, size).clone()
    COLLECTIVE_BYTES["reduce-scatter"] += _nbytes(out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes), None, None


def all_gather(x: torch.Tensor, mesh, axes: tuple[str, ...], dim: int
               ) -> torch.Tensor:
    if group_size(mesh, axes) == 1:
        return x
    return _AllGather.apply(x, mesh, tuple(axes), dim)


def all_reduce(x: torch.Tensor, mesh, axes: tuple[str, ...]
               ) -> torch.Tensor:
    if group_size(mesh, axes) == 1:
        return x
    return _AllReduce.apply(x, mesh, tuple(axes))


def reduce_scatter(x: torch.Tensor, mesh, axes: tuple[str, ...], dim: int
                   ) -> torch.Tensor:
    if group_size(mesh, axes) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, tuple(axes), dim)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> None:
    """Sum ``x`` over ``axes`` in place (a gradient after the backward)."""
    if group_size(mesh, axes) == 1:
        return
    _all_reduce_on(x, mesh, axes)
    COLLECTIVE_BYTES["all-reduce"] += _nbytes(x)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, mesh, axes: tuple[str, ...]
                   ) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axes`` (a new tensor)."""
    if group_size(mesh, axes) == 1:
        return x
    out = _all_reduce_on(x.clone(), mesh, axes, dist.ReduceOp.MAX)
    COLLECTIVE_BYTES["all-reduce"] += _nbytes(out)
    return out


# --------------------------------------------------------------------------
# Tensor parallelism over the active step's "model" axes
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Split:
    """A weight block that holds part ``index`` of ``parts`` equal parts
    along ``dim``: this rank's heads (or units, or vocabulary rows).
    ``parts`` is the "model" group's size, or fewer when ranks share a
    part (a GQA key/value head that serves the query heads of several
    ranks).  With ``groups`` > 1 the dim is that many equal halves side by
    side (the xLSTM's ``w_up``, ``[x_in | gate]``) and the part is this
    rank's part of each, in order."""
    dim: int
    index: int
    parts: int
    groups: int = 1

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This part of a tensor ``t`` holds whole along ``dim``."""
        d = self.dim % t.ndim
        g = t.unflatten(d, (self.groups, -1))
        size = g.shape[d + 1] // self.parts
        return g.narrow(d + 1, self.index * size, size).flatten(d, d + 1)


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A decode cache block that holds block ``index`` of ``parts`` equal
    blocks of its sequence, split over the mesh ``axes`` (a cache spec's
    sequence entry, jointly, the first the slowest).  Attention against it
    is the distributed softmax over ``axes``."""
    axes: tuple
    index: int
    parts: int


def seq_split_of(t: torch.Tensor) -> Optional[SeqSplit]:
    """The :class:`SeqSplit` a step builder marked a cache block with (None:
    the whole sequence)."""
    return getattr(t, "seq_split", None)


def mark_seq(t: torch.Tensor, split: Optional[SeqSplit]) -> torch.Tensor:
    if split is not None:
        t.seq_split = split
    return t


def layer_of(t: torch.Tensor, index) -> torch.Tensor:
    """``t[index]`` (a layer of a stacked cache, a view), carrying
    ``t``'s :class:`SeqSplit`."""
    return mark_seq(t[index], seq_split_of(t))


def split_of(t: torch.Tensor) -> Optional[Split]:
    """The :class:`Split` a step builder marked ``t`` with (None: whole)."""
    return getattr(t, "tp_split", None)


def mark(t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    if split is not None:
        t.tp_split = split
    return t


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active step's "model" group (identity
    outside a mesh)."""
    mesh, axes = current_mesh(), tp_axes()
    return all_reduce(x, mesh, axes) if mesh is not None and axes else x


def tp_reduce(y: torch.Tensor) -> torch.Tensor:
    """The sum of a row-parallel product's partial results over the
    "model" group: on a sequence-parallel stream a reduce-scatter on the
    sequence (dim 1), leaving this rank's rows; else :func:`tp_sum`."""
    mesh, axes = current_mesh(), tp_axes()
    if mesh is None or not axes:
        return y
    if sp_seq() is not None:
        return reduce_scatter(y, mesh, axes, 1)
    return all_reduce(y, mesh, axes)


def tp_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a [B, S, ...] stream held whole, on a
    sequence-parallel stream of S rows; otherwise ``x`` as it is (already
    this rank's rows, or no split active)."""
    seq = sp_seq()
    if seq is None or x.ndim < 3 or x.shape[1] != seq:
        return x
    mesh, axes = current_mesh(), tp_axes()
    size = seq // group_size(mesh, axes)
    return x.narrow(1, group_rank(mesh, axes) * size, size)


def tp_stream(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence from this rank's rows of a sequence-parallel
    stream (an all-gather over "model" on dim 1); ``x`` outside one."""
    if sp_seq() is None:
        return x
    return all_gather(x, current_mesh(), tp_axes(), 1)


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The "model" group's blocks of ``x`` along ``dim``, in rank order
    (identity outside a mesh)."""
    mesh, axes = current_mesh(), tp_axes()
    return all_gather(x, mesh, axes, dim) if mesh is not None and axes \
        else x
