"""Shard context of the port, from ``repro.distributed.context``: the mesh
and its axis names, carried into model code.

Model functions (attention, MoE, the layer stacks) consult the active
``ShardCtx`` to decide whether to take the distributed paths (expert
parallelism, sequence-sharded decode attention).  With no context set the
model runs the plain single-device path.

The mesh (``Mesh``) is the port's own: axis names, their sizes and, when
it was built over ``torch.distributed``, this rank's coordinates and one
process group per set of axes.  Without process groups it is a shape only,
which is all the spec trees of ``distributed/sharding.py`` need.

``shard_map`` is the port of ``jax.shard_map``.  Outside a region every
tensor is whole on every rank (replicated, as GSPMD would compute it).  A
region slices each input to this rank's block by its spec, runs the body,
whose collectives (``Mesh.psum``, ``pmax``, ``all_gather``, ``all_to_all``,
``axis_index``) run over the named axes' process groups, and gathers the
outputs back whole by their specs.

A tensor may also be *stored* (``Stored``, the store of
``distributed/sharding.py``): this rank's block of it and the spec that
cut the block.  A region takes a stored argument whose spec is its
``in_spec`` as it is, with no narrow of a whole tensor; code outside a
region gathers a stored tensor whole where it uses it (``gather``), and a
stored cache is opened whole and written back into the rank's block
(``opened``).

Gradients follow one convention inside a region: the gradient a rank holds
for a value that is replicated over some axes is its share, and the true
gradient is the sum of the shares over those axes.  So ``psum`` sums the
incoming gradient (its transpose), ``all_gather`` reduce-scatters it, an
output that leaves the region replicated over an axis hands its gradient
to the rank at coordinate 0 of that axis alone, and an input's gradient is
summed over every rank of the mesh as it leaves the region (for a stored
input, over the ranks that hold the same block).  Every rank then holds
the whole, true gradient of every tensor outside the regions, as a single
rank would, so a stored tensor gathered on use takes its block of that
gradient.

Batch blocks (``ShardCtx.batch_blocks``, set by the steps of
``launch/steps.py`` when their batch arrives stored): every activation
outside a region is this rank's block of the global batch on dim 0, split
over the batch axes and replicated over the others, as the reference's
GSPMD computes it from its input shardings.  A region takes an input whose
``in_spec`` puts dim 0 on the batch axes as that block, without a narrow,
and returns such an output as the rank's block; a stored cache opens to
its batch block (``opened``, ``gather_rows``).  The gradients outside the
regions then follow a second convention: a rank holds the true gradient of
its block of an activation, and for a weight (whole on every rank) a
partial one, the sum over its batch block alone; the true gradient is the
sum of the partials over the batch axes.  So an input leaves a region with
its gradient summed over the axes other than the batch axes only; a stored
weight gathered on use sums its partial over the batch axes and keeps its
block (``_Gather``: a reduce-scatter over a batch axis the leaf is split
on, an all-reduce over one it is whole on); a weight kept whole has its
partial summed by ``sum_partials``; and a value summed over the batch
blocks (``sum_blocks``: a loss, the MoE statistics) passes its gradient
through, since every rank holds that sum and its true gradient.  A stored
block that enters a region as it is already gets its true gradient there
(the body computes on the batch block, and the shares are summed over the
ranks that hold the same block), so it takes no further sum.

The model axis (``ShardCtx.tp``, Megatron-style tensor parallelism, as the
reference's GSPMD partitions its dense layers): under a context every layer
computes on the "model" block of each weight its spec cuts over that axis
(``sharding.tp_weight``) and keeps a weight the spec leaves whole over it
whole.  The residual stream between blocks is the rank's block of the
sequence when ``ShardCtx.seq_blocks`` (set by ``models/model.py`` where the
reference's ``_seq_constraint`` pins it), else whole over "model".  Four
functions move activations in and out of a layer's blocks
(``copy_to_model``, ``reduce_from_model``, ``gather_seq``,
``scatter_seq``), and two more make a block whole or cut it where a
replicated computation (a region, a layer that keeps its weights whole)
takes it (``whole_of``, ``block_of``).  Inside a layer, between its entry
and its exit, a value held whole over "model" carries a partial gradient
(this rank's use of it); the entry sums it (``copy_to_model``'s backward,
or the reduce-scatter of ``gather_seq``).  Three gradient rules follow:

  * a weight a layer computes on by its "model" block takes its gradient
    as it is (the block's, as a rank with that block alone would have it);
  * a weight kept whole over "model" but used on the rank's sequence block
    or head block (norms, ``bk``/``bv``, replicated ``wk``/``wv``, mamba's
    ``w_in`` and ``conv_w``) enters through ``copy_to_model``, whose
    backward sums its gradient over "model";
  * the vocab-parallel loss (``launch/steps.py``) passes a gradient only to
    the rank's vocab block of the logits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

Axes = Union[str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per dimension, each ``None``
    (replicated), an axis name, or a tuple of axis names (the dimension
    split over them, the first the major one).  A one-name tuple is stored
    as the name, as JAX's ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _as_axes(entry: Optional[Axes]) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Mesh:
    """Named mesh axes over the ranks of ``torch.distributed`` (rank r sits
    at the row-major coordinates of r in ``shape``), or a shape only
    (``groups`` None).

    ``shape`` maps axis name -> size in axis order, as a JAX mesh's does."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None, groups: Optional[Dict[tuple, object]] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ "
                             "in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self._groups = groups

    def __repr__(self) -> str:
        kind = "abstract" if self._groups is None else f"rank {self.rank}"
        return f"Mesh({self.shape}, {kind})"

    @classmethod
    def over_process_group(cls, shape: Sequence[int], axis_names: Sequence[str]) -> "Mesh":
        """The mesh over the started default process group, whose size must
        be the mesh's.  Every rank creates one group per non-empty set of
        axes and per coordinate of the other axes, in the same order."""
        import torch.distributed as dist
        size, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(shape) != size:
            raise ValueError(f"mesh {tuple(shape)} holds {math.prod(shape)} ranks; the "
                             f"process group has {size}")
        names = tuple(axis_names)
        grid = torch.arange(size).reshape(tuple(shape))
        groups = {}
        for n in range(1, len(names) + 1):
            for sub in itertools.combinations(range(len(names)), n):
                if n == len(names):
                    groups[tuple(names[i] for i in sub)] = dist.group.WORLD
                    continue
                rest = [i for i in range(len(names)) if i not in sub]
                # the members of each group: all coordinates of ``sub`` at one
                # coordinate of the other axes, in ascending rank order
                moved = grid.permute(*rest, *sub).reshape(-1, math.prod(shape[i] for i in sub))
                for members in moved.tolist():
                    g = dist.new_group(members)
                    if rank in members:
                        groups[tuple(names[i] for i in sub)] = g
        return cls(shape, names, rank=rank, groups=groups)

    # ------------------------------------------------------------------ coordinates

    def coords(self) -> Dict[str, int]:
        if self.rank is None:
            raise ValueError("an abstract mesh has no rank")
        out, r = {}, self.rank
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _as_axes(axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (row-major over them, the first
        the major one), as ``jax.lax.axis_index``."""
        c, idx = self.coords(), 0
        for a in _as_axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes: Axes):
        if self._groups is None:
            raise ValueError("an abstract mesh has no process groups")
        key = tuple(a for a in self.axis_names if a in _as_axes(axes))
        return self._groups[key]

    def _member_order(self, axes: Tuple[str, ...]) -> list:
        """For the group over ``axes``: the block index (row-major over
        ``axes`` as given) of each member, in the group's rank order
        (ascending global rank: row-major over the axes in mesh order)."""
        in_mesh = [a for a in self.axis_names if a in axes]
        order = []
        for pos in itertools.product(*(range(self.shape[a]) for a in in_mesh)):
            c = dict(zip(in_mesh, pos))
            idx = 0
            for a in axes:
                idx = idx * self.shape[a] + c[a]
            order.append(idx)
        return order

    # ------------------------------------------------------------------ collectives

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Sum over the ranks of ``axes`` (``jax.lax.psum``)."""
        return _PSum.apply(x, self.group(axes))

    def pmax(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Elementwise max over the ranks of ``axes`` (``jax.lax.pmax``).
        Used only where the result is subtracted out again (a softmax's
        running max), so it carries no gradient."""
        import torch.distributed as dist
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group(axes))
        return y

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """Concatenate the ranks' blocks along ``dim`` in block order
        (``jax.lax.all_gather(..., tiled=True)``)."""
        axes = _as_axes(axes)
        return _AllGather.apply(x, self.group(axes), dim, self._member_order(axes))

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Send block i of dim 0 to rank i of ``axis`` and concatenate what
        arrives along dim 0 by source (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
        return _AllToAll.apply(x, self.group(axis))


def _blocks_to(x: torch.Tensor, order: list, inverse: bool) -> torch.Tensor:
    """Permute the equal blocks of dim 0 from group-rank order to block
    order (or back)."""
    if order == sorted(order):
        return x
    chunks = x.chunk(len(order))
    if inverse:
        return torch.cat([chunks[order[i]] for i in range(len(order))])
    out = [None] * len(order)
    for i, b in enumerate(order):
        out[b] = chunks[i]
    return torch.cat(out)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_gather_single(out, src, group) -> None:
    import torch.distributed as dist
    # newer torch names it all_gather_single; older releases only have
    # all_gather_into_tensor (same arguments)
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(
        out, src, group=group)


def _reduce_scatter_single(out, src, group) -> None:
    import torch.distributed as dist
    (getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor)(
        out, src, group=group)


def _gather(x: torch.Tensor, group, dim: int, order: list) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in block
    order: gathered stacked, (n, *x.shape) in x's own layout, then merged
    into ``dim`` (a view when the group has one member)."""
    n = len(order)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x.contiguous(), group)
    out = _blocks_to(out.view((n,) + tuple(x.shape)), order, inverse=False).movedim(0, dim)
    return out.reshape(x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])


def _scatter_sum(g: torch.Tensor, group, dim: int, order: list) -> torch.Tensor:
    """The sum of the group's ``g`` over its members, each keeping its block
    of ``dim`` (a reduce-scatter; the transpose of ``_gather``)."""
    n, d = len(order), dim
    stacked = g.reshape(g.shape[:d] + (n, g.shape[d] // n) + g.shape[d + 1:]).movedim(d, 0)
    src = _blocks_to(stacked.contiguous(), order, inverse=True).contiguous()
    out = src.new_empty(src.shape[1:])
    _reduce_scatter_single(out, src.view((n * src.shape[1],) + tuple(src.shape[2:])), group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, order):
        ctx.group, ctx.dim, ctx.order = group, dim, order
        return _gather(x, group, dim, order)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim, ctx.order), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """A sum over ``group`` whose gradient passes through (Megatron's g):
    every member holds the sum and its true gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, group, dim, order):
        ctx.group, ctx.dim, ctx.order = group, dim, order
        return _scatter_sum(x, group, dim, order)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim, ctx.order), None, None, None


class _WholeOf(torch.autograd.Function):
    """The blocks along ``dim`` gathered whole; the whole's gradient, true
    on every member, goes back as this member's block of it."""

    @staticmethod
    def forward(ctx, x, group, dim, order, index):
        ctx.dim, ctx.start, ctx.size = dim, index * x.shape[dim], x.shape[dim]
        return _gather(x, group, dim, order)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size).contiguous(), None, None, None, None


class _BlockOf(torch.autograd.Function):
    """This member's block of a whole tensor along ``dim``; the blocks'
    gradients are gathered whole, so the whole's is true on every member."""

    @staticmethod
    def forward(ctx, x, group, dim, order, index):
        n = len(order)
        ctx.group, ctx.dim, ctx.order = group, dim, order
        size = x.shape[dim] // n
        return x.narrow(dim, index * size, size)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.group, ctx.dim, ctx.order), None, None, None, None


# ----------------------------------------------------------------------------- regions

def _block(mesh: Mesh, shape, spec) -> Tuple[Tuple[int, int, int], ...]:
    """(dim, start, length) of this rank's block of a tensor of ``shape``
    under ``spec``, for every split dimension."""
    out = []
    for dim, entry in enumerate(spec):
        axes = _as_axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {axes} ({n})")
        size = shape[dim] // n
        out.append((dim, mesh.axis_index(axes) * size, size))
    return tuple(out)


def _narrow(x: torch.Tensor, block) -> torch.Tensor:
    for dim, start, size in block:
        x = x.narrow(dim, start, size)
    return x


class _Enter(torch.autograd.Function):
    """This rank's block of an input (whole, or under batch blocks the
    rank's batch block); its gradient (a share) is placed in a zero tensor
    of the input's shape and summed over ``group``: the whole mesh, or under
    batch blocks the axes other than the batch axes (None: no sum)."""

    @staticmethod
    def forward(ctx, x, block, group):
        ctx.shape, ctx.block, ctx.group = x.shape, block, group
        return _narrow(x, block).view_as(_narrow(x, block))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        if ctx.block and any(size != ctx.shape[d] for d, _, size in ctx.block):
            whole = g.new_zeros(ctx.shape)
            _narrow(whole, ctx.block).copy_(g)
        else:
            whole = g.contiguous().clone()
        if ctx.group is not None:
            dist.all_reduce(whole, group=ctx.group)
        return whole, None, None


class _Exit(torch.autograd.Function):
    """Gather a body output whole along the split dimensions of ``spec``
    (under batch blocks, all but a batch dim 0); its gradient goes back as
    this rank's block, to the rank at coordinate 0 of every axis the output
    is replicated over (zeros elsewhere)."""

    @staticmethod
    def forward(ctx, y, mesh, spec, owner):
        ctx.block = _block_of_output(mesh, y.shape, spec)
        ctx.owner = owner
        return _whole(mesh, y, spec)

    @staticmethod
    def backward(ctx, g):
        g = _narrow(g, ctx.block).contiguous()
        return (g if ctx.owner else torch.zeros_like(g)), None, None, None


def _whole(mesh: Mesh, y: torch.Tensor, spec) -> torch.Tensor:
    """A body output gathered along every split dimension of ``spec``."""
    out = y
    for dim, entry in enumerate(spec):
        axes = _as_axes(entry)
        if axes:
            out = _gather(out, mesh.group(axes), dim, mesh._member_order(axes))
    return out if out is not y else y.view_as(y)


def _block_of_output(mesh: Mesh, local_shape, spec):
    """(dim, start, length) of this rank's block in the whole output, from
    its local shape."""
    out = []
    for dim, entry in enumerate(spec):
        axes = _as_axes(entry)
        if axes:
            size = local_shape[dim]
            out.append((dim, mesh.axis_index(axes) * size, size))
    return tuple(out)


def _pad_spec(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _row_axes() -> Tuple[str, ...]:
    """The batch axes when the active context holds batch blocks, else ()."""
    ctx = current_ctx()
    return tuple(ctx.batch_axes) if ctx is not None and ctx.batch_blocks else ()


def _rows_cut(spec, rows: Tuple[str, ...]) -> tuple:
    """``spec`` with every entry that is exactly the batch axes ``rows``
    taken out (None): the dimensions a batch block already holds as the
    rank's block."""
    if not rows:
        return tuple(spec)
    return tuple(None if _as_axes(e) == rows else e for e in spec)


def _local_spec(spec, rows: Tuple[str, ...]) -> tuple:
    """A region argument's spec with dim 0 taken out when it is the batch
    axes of batch blocks (the argument is that block already)."""
    spec = tuple(spec)
    if rows and spec and _as_axes(spec[0]) == rows:
        return (None,) + spec[1:]
    return spec


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """The port of ``jax.shard_map`` (``check_vma=False``): a callable
    that runs ``fn`` on this rank's blocks of its tensor arguments (whole,
    or stored with the argument's ``in_spec``) and returns its outputs
    whole.  ``in_specs`` has one spec per argument; ``out_specs`` is one
    spec or a tuple of them, like ``fn``'s result.  Under batch blocks an
    argument whose spec puts dim 0 on the batch axes is the rank's block of
    that dim already, and such an output stays the rank's block.

    An input that needs no gradient enters as a view of the caller's
    tensor (of a stored one's block), so a body may write its block in
    place."""
    single = isinstance(out_specs, P)

    def call(*args):
        rows = _row_axes()
        rest = tuple(a for a in mesh.axis_names if a not in rows)   # an input's gradient sum
        group = mesh.group(rest) if rest else None
        local = []
        for a, spec in zip(args, in_specs):
            if isinstance(a, Stored):
                local.append(_enter_stored(mesh, a, _pad_spec(spec, a.ndim)))
                continue
            block = _block(mesh, a.shape, _local_spec(_pad_spec(spec, a.ndim), rows))
            if a.requires_grad and torch.is_grad_enabled():
                local.append(_Enter.apply(a, block, group))
            else:
                local.append(_narrow(a, block))
        outs = fn(*local)
        specs = (out_specs,) if single else out_specs
        outs = (outs,) if single else outs
        coords = mesh.coords()
        whole = []
        for y, spec in zip(outs, specs):
            spec = _pad_spec(spec, y.ndim)
            cut = _local_spec(spec, rows)
            if not (y.requires_grad and torch.is_grad_enabled()):
                whole.append(_whole(mesh, y, cut) if any(cut) else y)
                continue
            used = {a for e in spec for a in _as_axes(e)}
            owner = all(coords[a] == 0 for a in mesh.axis_names if a not in used)
            whole.append(_Exit.apply(y, mesh, cut, owner))
        return whole[0] if single else tuple(whole)

    return call


# ----------------------------------------------------------------------------- stored tensors

class Stored:
    """One leaf of the store: this rank's block (``local``) of a tensor of
    ``shape`` cut by ``spec`` on ``mesh``.  Indexing a leading dimension
    the spec leaves whole (a stacked layer) gives that layer's stored
    tensor, a view of the block."""

    __slots__ = ("local", "spec", "shape", "mesh")

    def __init__(self, local: torch.Tensor, spec, shape, mesh: Mesh):
        self.local, self.spec, self.mesh = local, P(*_pad_spec(spec, len(shape))), mesh
        self.shape = torch.Size(shape)

    def __repr__(self) -> str:
        return f"Stored({tuple(self.shape)}, {self.spec}, local {tuple(self.local.shape)})"

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __getitem__(self, i: int) -> "Stored":
        if not isinstance(i, int) or self.spec[0] is not None:
            raise TypeError(f"a stored tensor indexes only an unsplit leading dim, not {i!r} "
                            f"under {self.spec}")
        return Stored(self.local[i], self.spec[1:], self.shape[1:], self.mesh)

    def with_local(self, local: torch.Tensor) -> "Stored":
        """The same placement holding another block (an update's result)."""
        return Stored(local, self.spec, self.shape, self.mesh)

    def block(self) -> tuple:
        """(dim, start, length) of the block in the whole tensor."""
        return _block(self.mesh, self.shape, self.spec)

    def split_axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec splits a dimension over, in mesh order."""
        used = {a for e in self.spec for a in _as_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)


class _EnterStored(torch.autograd.Function):
    """A stored block entering a region as it is; its gradient (a share)
    is summed over the ranks that hold the same block: the axes the spec
    leaves whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        if ctx.group is None:
            return g, None
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _enter_stored(mesh: Mesh, a: Stored, spec) -> torch.Tensor:
    if tuple(a.spec) != tuple(spec):
        raise ValueError(f"a stored tensor cut by {a.spec} enters a region that takes {P(*spec)}")
    if not (a.local.requires_grad and torch.is_grad_enabled()):
        return a.local
    whole_over = tuple(n for n in mesh.axis_names if n not in a.split_axes())
    return _EnterStored.apply(a.local, mesh.group(whole_over) if whole_over else None)


class _Gather(torch.autograd.Function):
    """A stored block gathered whole, outside any region.  Without batch
    blocks the whole gradient there is the true one on every rank, so the
    block's gradient is its part of it.  Under batch blocks (``rows``, the
    batch axes) it is this rank's partial: summed over the batch axes (a
    reduce-scatter along a dimension split over them, an all-reduce over
    those the leaf is whole on), then cut to the block."""

    @staticmethod
    def forward(ctx, local, mesh, spec, block, rows):
        ctx.mesh, ctx.spec, ctx.block, ctx.rows = mesh, spec, block, rows
        return _whole(mesh, local, spec)

    @staticmethod
    def backward(ctx, g):
        if not ctx.rows:
            return _narrow(g, ctx.block).contiguous(), None, None, None, None
        return _sum_rows(g, ctx.mesh, ctx.spec, ctx.rows), None, None, None, None


def _sum_rows(g: torch.Tensor, mesh: Mesh, spec, rows: Tuple[str, ...]) -> torch.Tensor:
    """This rank's block (by ``spec``) of the sum of the partial gradients
    ``g`` (whole) over the batch axes ``rows``.  The ranks of a batch group
    share their other coordinates, so the dimensions split over other axes
    are cut first."""
    out, summed = g, set()
    for dim, entry in enumerate(spec):
        axes = _as_axes(entry)
        if axes and not set(axes) & set(rows):
            size = g.shape[dim] // mesh.axis_size(axes)
            out = out.narrow(dim, mesh.axis_index(axes) * size, size)
    for dim, entry in enumerate(spec):
        axes = _as_axes(entry)
        if not set(axes) & set(rows):
            continue
        if not set(axes) <= set(rows):
            raise ValueError(f"dim {dim} of a stored leaf is split over {axes}, batch and "
                             f"other axes together")
        out = _scatter_sum(out, mesh.group(axes), dim, mesh._member_order(axes))
        summed |= set(axes)
    rest = tuple(a for a in rows if a not in summed)
    if rest:
        import torch.distributed as dist
        out = out.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=mesh.group(rest))
    return out.contiguous()


def _drop_axes(entry, drop: Tuple[str, ...]):
    axes = tuple(a for a in _as_axes(entry) if a not in drop)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def gather(x, keep: Tuple[str, ...] = ()):
    """``x`` whole: a stored tensor gathered along every split dimension
    (an all-gather per split, even over one rank), anything else as it is.
    With ``keep`` (the model axis), the dimensions split over those axes
    stay this rank's block and only the others are gathered (FSDP's "data"
    gather of a tensor-parallel weight).  For a weight: under batch blocks
    its gradient sums the ranks' partials (``_Gather``)."""
    if not isinstance(x, Stored):
        return x
    if not keep:
        return _Gather.apply(x.local, x.mesh, x.spec, x.block(), _row_axes())
    spec = tuple(_drop_axes(e, keep) for e in x.spec)
    shape = tuple(n * x.mesh.axis_size(e) for n, e in zip(x.local.shape, spec))
    return _Gather.apply(x.local, x.mesh, spec, _block(x.mesh, shape, spec), _row_axes())


_WHOLE_CACHE = ("a whole (unstored) cache cannot serve batch blocks: store it by its "
                "cache specs (``sharding.stored_zeros`` / ``place``), or pass the batch whole")


def gather_rows(x):
    """A stored batch-major tensor (a cache leaf) as this rank uses it:
    gathered along every split dimension, except, under batch blocks, the
    batch dimension, which stays the rank's block.  Under batch blocks a
    whole tensor is refused (it holds every row, the activations one
    block)."""
    check_cache(x)
    if not isinstance(x, Stored):
        return x
    return _whole(x.mesh, x.local, _rows_cut(x.spec, _row_axes()))


def check_cache(x) -> None:
    """Refuse a whole (unstored) cache leaf under batch blocks."""
    if _row_axes() and not isinstance(x, Stored):
        raise ValueError(_WHOLE_CACHE)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def gather_tree(tree, keep: Tuple[str, ...] = ()):
    """A tree of dicts and lists with every stored leaf gathered whole,
    except the top-level entries named in ``keep`` (left as they are)."""
    if isinstance(tree, dict):
        return {k: v if k in keep else _map_leaves(gather, v) for k, v in tree.items()}
    return _map_leaves(gather, tree)


def write_back(dst: Stored, whole: torch.Tensor) -> None:
    """Copy this rank's block of ``whole`` (as ``gather_rows`` gave it:
    under batch blocks the batch dimension is the rank's block already)
    into ``dst``'s block."""
    part = _narrow(whole, _block(dst.mesh, dst.shape, _rows_cut(dst.spec, _row_axes())))
    if part.data_ptr() != dst.local.data_ptr() or part.stride() != dst.local.stride():
        dst.local.copy_(part)


@contextlib.contextmanager
def opened(tree):
    """A cache tree (dicts of tensors) with its stored leaves gathered
    (``gather_rows``: whole, under batch blocks the rank's rows), for code
    outside a region to read and write in place; on exit each rank's block
    of every stored leaf takes what was written."""
    stored = []

    def open_leaf(x):
        whole = gather_rows(x)
        if isinstance(x, Stored):
            stored.append((x, whole))
        return whole

    out = _map_leaves(open_leaf, tree)
    yield out
    for dst, whole in stored:
        write_back(dst, whole)


# ----------------------------------------------------------------------------- context

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: Mesh
    batch_axes: Tuple[str, ...] = ("data",)   # ("pod","data") on the multi-pod mesh
    model_axis: str = "model"
    seq_parallel: bool = True                 # shard residual-stream seq over model
    ep_mode: str = "gather"                   # MoE dispatch: "gather" | "tokengather" | "a2a" | "auto"
    mla_absorb: bool = False                  # weight-absorbed MLA decode
    remat_policy: str = "none"
    unroll: int = 1                           # scan unroll in the reference; a Python
                                              # loop has nothing to unroll
    paired_lg: bool = False                   # gemma2's (local, global) layer pairs in
                                              # the reference; the port's loop already
                                              # gives each layer a static window flag
    batch_blocks: bool = False                # activations hold this rank's block of
                                              # the global batch (see the module
                                              # docstring); the steps set it
    seq_blocks: bool = False                  # the residual stream holds this rank's
                                              # block of the sequence over "model";
                                              # models/model.py sets it

    @property
    def dp(self) -> int:
        return int(math.prod(self.mesh.shape[a] for a in self.batch_axes))

    @property
    def tp(self) -> int:
        return int(self.mesh.shape[self.model_axis])

    def batch_spec(self, *rest) -> P:
        return P(self.batch_axes, *rest)


_state = threading.local()


def current_ctx() -> Optional[ShardCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def shard_ctx(ctx: Optional[ShardCtx]):
    prev = current_ctx()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def divides(n: int, d: int) -> bool:
    return d > 0 and n % d == 0


def batch_axis(ctx: ShardCtx, b: int):
    """The batch axes if a batch of ``b`` rows splits over them, else None
    (replicated).  Under batch blocks ``b`` is the rank's block of a batch
    that split."""
    return ctx.batch_axes if ctx.batch_blocks or divides(b, ctx.dp) else None


def sum_blocks(x: torch.Tensor, ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """``x`` summed over the batch blocks (an all-reduce over the batch
    axes) under batch blocks, else ``x``: the global sum, held by every
    rank.  Its gradient passes through unsummed, since every rank holds
    the true gradient of that sum."""
    ctx = ctx if ctx is not None else current_ctx()
    if ctx is None or not ctx.batch_blocks:
        return x
    return _Reduce.apply(x, ctx.mesh.group(ctx.batch_axes))


def sum_partials(grads: Sequence[torch.Tensor], ctx: ShardCtx) -> list:
    """The true gradients of weights kept whole from this rank's partials:
    under batch blocks summed over the batch axes, one all-reduce a dtype
    for all of them; else as they are."""
    grads = list(grads)
    if not ctx.batch_blocks or not grads:
        return grads
    import torch.distributed as dist
    out = list(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=ctx.mesh.group(ctx.batch_axes))
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


# ----------------------------------------------------------------------------- the model axis

def _model(ctx: ShardCtx):
    """(group, block order, this rank's index) of the model axis."""
    ax = ctx.model_axis
    return ctx.mesh.group(ax), ctx.mesh._member_order((ax,)), ctx.mesh.axis_index(ax)


def copy_to_model(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the model axis: the entry of
    a value held whole over "model" into a layer that uses it per block."""
    return _CopyToModel.apply(x, ctx.mesh.group(ctx.model_axis))


def reduce_from_model(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over the model axis; the
    gradient passes through."""
    return _Reduce.apply(x, ctx.mesh.group(ctx.model_axis))


def gather_seq(x: torch.Tensor, ctx: ShardCtx, dim: int = 1) -> torch.Tensor:
    """The sequence blocks along ``dim`` gathered whole; the backward
    reduce-scatters the partial gradients back to the blocks."""
    group, order, _ = _model(ctx)
    return _AllGather.apply(x, group, dim, order)


def scatter_seq(x: torch.Tensor, ctx: ShardCtx, dim: int = 1) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over the model axis, this rank
    keeping its block along ``dim`` (a reduce-scatter); the backward
    gathers the blocks' gradients whole."""
    group, order, _ = _model(ctx)
    return _ScatterSeq.apply(x, group, dim, order)


def whole_of(x: torch.Tensor, ctx: ShardCtx, dim: int) -> torch.Tensor:
    """The blocks along ``dim`` gathered whole over the model axis, for a
    computation every rank repeats; the gradient goes back as the block."""
    group, order, index = _model(ctx)
    return _WholeOf.apply(x, group, dim, order, index)


def block_of(x: torch.Tensor, ctx: ShardCtx, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` whole over the model axis;
    the gradient of the whole is gathered from the blocks'."""
    group, order, index = _model(ctx)
    return _BlockOf.apply(x, group, dim, order, index)
