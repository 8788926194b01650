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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, order):
        ctx.group, ctx.dim, ctx.order = group, dim, order
        return _gather(x, group, dim, order)

    @staticmethod
    def backward(ctx, g):
        n, d = len(ctx.order), ctx.dim
        stacked = g.reshape(g.shape[:d] + (n, g.shape[d] // n) + g.shape[d + 1:]).movedim(d, 0)
        src = _blocks_to(stacked.contiguous(), ctx.order, inverse=True).contiguous()
        out = src.new_empty(src.shape[1:])
        _reduce_scatter_single(out, src.view((n * src.shape[1],) + tuple(src.shape[2:])),
                               ctx.group)
        return out, None, None, None


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
    """This rank's block of a whole input; its gradient (a share) is
    placed in a zero tensor of the whole shape and summed over the mesh."""

    @staticmethod
    def forward(ctx, x, block, world):
        ctx.shape, ctx.block, ctx.world = x.shape, block, world
        return _narrow(x, block).view_as(_narrow(x, block))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        if ctx.block and any(size != ctx.shape[d] for d, _, size in ctx.block):
            whole = g.new_zeros(ctx.shape)
            _narrow(whole, ctx.block).copy_(g)
        else:
            whole = g.contiguous().clone()
        dist.all_reduce(whole, group=ctx.world)
        return whole, None, None


class _Exit(torch.autograd.Function):
    """Gather a body output whole along its split dimensions; its whole
    gradient goes back as this rank's block, to the rank at coordinate 0
    of every axis the output is replicated over (zeros elsewhere)."""

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


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """The port of ``jax.shard_map`` (``check_vma=False``): a callable
    that runs ``fn`` on this rank's blocks of its tensor arguments (whole,
    or stored with the argument's ``in_spec``) and returns its outputs
    whole.  ``in_specs`` has one spec per argument; ``out_specs`` is one
    spec or a tuple of them, like ``fn``'s result.

    An input that needs no gradient enters as a view of the caller's
    tensor (of a stored one's block), so a body may write its block in
    place."""
    single = isinstance(out_specs, P)

    def call(*args):
        world = mesh.group(mesh.axis_names)
        local = []
        for a, spec in zip(args, in_specs):
            if isinstance(a, Stored):
                local.append(_enter_stored(mesh, a, _pad_spec(spec, a.ndim)))
                continue
            block = _block(mesh, a.shape, _pad_spec(spec, a.ndim))
            if a.requires_grad and torch.is_grad_enabled():
                local.append(_Enter.apply(a, block, world))
            else:
                local.append(_narrow(a, block))
        outs = fn(*local)
        specs = (out_specs,) if single else out_specs
        outs = (outs,) if single else outs
        coords = mesh.coords()
        whole = []
        for y, spec in zip(outs, specs):
            spec = _pad_spec(spec, y.ndim)
            if not (y.requires_grad and torch.is_grad_enabled()):
                whole.append(_whole(mesh, y, spec) if any(spec) else y)
                continue
            used = {a for e in spec for a in _as_axes(e)}
            owner = all(coords[a] == 0 for a in mesh.axis_names if a not in used)
            whole.append(_Exit.apply(y, mesh, spec, owner))
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
    """A stored block gathered whole, outside any region; the whole
    gradient there is the true one on every rank, so the block's gradient
    is its part of it."""

    @staticmethod
    def forward(ctx, local, mesh, spec, block):
        ctx.block = block
        return _whole(mesh, local, spec)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.block).contiguous(), None, None, None


def gather(x):
    """``x`` whole: a stored tensor gathered along every split dimension
    (an all-gather per split, even over one rank), anything else as it is."""
    if not isinstance(x, Stored):
        return x
    return _Gather.apply(x.local, x.mesh, x.spec, x.block())


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
    """Copy this rank's block of ``whole`` into ``dst``'s block."""
    part = _narrow(whole, dst.block())
    if part.data_ptr() != dst.local.data_ptr() or part.stride() != dst.local.stride():
        dst.local.copy_(part)


@contextlib.contextmanager
def opened(tree):
    """A cache tree (dicts of tensors) with its stored leaves gathered
    whole, for code outside a region to read and write in place; on exit
    each rank's block of every stored leaf takes what was written."""
    stored = []

    def open_leaf(x):
        if not isinstance(x, Stored):
            return x
        whole = gather(x)
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
    """The batch axes if ``b`` splits over them, else None (replicated)."""
    return ctx.batch_axes if divides(b, ctx.dp) else None
