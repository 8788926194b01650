"""Partition specs for every parameter, cache and input tree, per family,
ported from ``repro.distributed.sharding``.  Host code only: the specs
come from shapes (``models.model.abstract_params`` on the meta device,
``models.model.cache_shapes``), so nothing is allocated.

Strategy (the reference's):
  * model axis ("model")        — tensor parallelism: attention heads (or
    head_dim when heads don't divide), FFN hidden, MoE experts (EP), vocab.
  * data axes ("pod", "data")   — batch; weights are additionally FSDP-split
    over "data" on a large non-TP dim when it divides.
  * decode KV caches            — sequence dim split over "model"
    (sequence-parallel flash-decode).

Specs are the port's ``P``: a tuple with one entry per dimension, each
None, an axis name or a tuple of axis names.  Leading stack dims (the
scanned layers, a hybrid's double stack) are padded with None.  ``named``
turns a spec tree into DTensor placements.

The store: ``place`` cuts a tree of whole tensors by its spec tree, so each
rank keeps only its block of a leaf that a spec splits (a
``context.Stored``, its spec travelling with it) and a leaf no spec splits
stays whole; ``stored_zeros`` makes a zeroed stored tree (a cache) block by
block; ``gather`` (``context.gather``) is the inverse of ``place`` for
one leaf, and ``local_bytes`` what a rank holds.  The specs split a dimension only where
it divides (``context.divides``), so every block of a rank is even.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.context import (P, ShardCtx, Stored, _as_axes, _block,
                                             _narrow, batch_axis, block_of, copy_to_model,
                                             divides, gather)
from repro_torch.models.config import ModelConfig, ShapeCell


def _ax(n: int, size: int, name: str) -> Optional[str]:
    """Axis name if the dim divides over it, else None (replicate)."""
    return name if divides(n, size) else None


def _map_with_names(fn, tree, names: Tuple[str, ...] = ()):
    """``fn(names, leaf)`` over a tree of dicts and lists, the names being
    the dict keys and ``[i]`` list indices on the way to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_names(fn, v, names + (f"[{i}]",)) for i, v in enumerate(tree)]
    return fn(names, tree)


def _base_spec(names: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ModelConfig, ctx: ShardCtx) -> Tuple[P, int]:
    """(spec for the UNSTACKED leaf, base ndim).  Caller pads leading dims."""
    m, dp = ctx.tp, int(ctx.mesh.shape["data"])
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    t = shape  # trailing dims equal base shape

    # ---- norms / scalars ------------------------------------------------------
    if leaf in ("scale", "kv_norm", "q_norm", "conv_b", "A_log", "D", "dt_bias",
                "norm"):
        if leaf in ("A_log", "D", "dt_bias"):            # (h,)
            return P(_ax(t[-1], m, "model")), 1
        if leaf == "norm" and parent == "mamba":         # (di,)
            return P(_ax(t[-1], m, "model")), 1
        return P(None), 1

    # ---- embeddings -----------------------------------------------------------
    if leaf in ("embedding", "unembedding"):             # (V, d)
        v, d = t[-2], t[-1]
        if divides(v, m):
            return P("model", _ax(d, dp, "data")), 2
        return P(None, _ax(d, m, "model")), 2

    # ---- attention ------------------------------------------------------------
    if parent in ("attn", "cross", "shared_attn") or leaf.startswith(
            ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "wkv")):
        if leaf in ("wq", "wk", "wv"):
            if len(t) >= 3 and t[-3] == cfg.d_model:     # GQA (d, H, hd)
                d, h, hd = t[-3], t[-2], t[-1]
                if divides(h, m):
                    return P(_ax(d, dp, "data"), "model", None), 3
                if leaf == "wq" and divides(hd, m):
                    return P(_ax(d, dp, "data"), None, "model"), 3
                # kv heads below the TP degree: replicate over model
                return P(_ax(d, dp, "data"), None, None), 3
            # MLA wq (d, H, dn+dr)
            d, h, hd = t[-3], t[-2], t[-1]
            return P(_ax(d, dp, "data"), _ax(h, m, "model"), None), 3
        if leaf == "wo":                                  # (H, hd, d)
            h, hd, d = t[-3], t[-2], t[-1]
            if divides(h, m):
                return P("model", None, _ax(d, dp, "data")), 3
            if divides(hd, m):
                return P(None, "model", _ax(d, dp, "data")), 3
            return P(None, None, _ax(d, m, "model")), 3
        if leaf == "bq":                                  # (H, hd)
            h, hd = t[-2], t[-1]
            if divides(h, m):
                return P("model", None), 2
            if divides(hd, m):
                return P(None, "model"), 2
            return P(None, None), 2
        if leaf in ("bk", "bv"):                          # follow replicated k/v
            return P(None, None), 2
        if leaf == "wkv_a":                               # (d, r+dr) — small
            return P(_ax(t[-2], dp, "data"), None), 2
        if leaf == "wkv_b":                               # (r, H, dn+dv)
            return P(None, _ax(t[-2], m, "model"), None), 3
        if leaf == "wq_a":                                # (d, rq)
            return P(_ax(t[-2], dp, "data"), None), 2
        if leaf == "wq_b":                                # (rq, H, dn+dr)
            return P(None, _ax(t[-2], m, "model"), None), 3

    # ---- MoE --------------------------------------------------------------------
    if parent == "moe" or (parent == "shared" and len(names) >= 3 and names[-3] == "moe"):
        if leaf == "w_router":                            # (d, E) — FSDP over data
            return P(_ax(t[-2], dp, "data"), None), 2
        if parent == "moe" and leaf in ("w_gate", "w_up"):  # (E, d, f)
            e, d, f = t[-3], t[-2], t[-1]
            return P(_ax(e, m, "model"), None, _ax(f, dp, "data")), 3
        if parent == "moe" and leaf == "w_down":          # (E, f, d)
            e, f, d = t[-3], t[-2], t[-1]
            return P(_ax(e, m, "model"), _ax(f, dp, "data"), None), 3
        # moe.shared.* — dense FFN rules below

    # ---- dense FFN ---------------------------------------------------------------
    if leaf in ("w_gate", "w_up"):                        # (d, f)
        d, f = t[-2], t[-1]
        return P(_ax(d, dp, "data"), _ax(f, m, "model")), 2
    if leaf == "w_down":                                  # (f, d)
        f, d = t[-2], t[-1]
        return P(_ax(f, m, "model"), _ax(d, dp, "data")), 2

    # ---- mamba2 -------------------------------------------------------------------
    if parent == "mamba":
        if leaf == "w_in":                                # (d, 2di+2n+h) — replicated
            return P(_ax(t[-2], dp, "data"), None), 2     # over model
        if leaf == "conv_w":                              # (K, C)
            return P(None, None), 2
        if leaf == "w_out":                               # (di, d)
            return P(_ax(t[-2], m, "model"), _ax(t[-1], dp, "data")), 2

    # default: replicate
    return P(*([None] * len(shape))), len(shape)


def leaf_spec(x, names: Tuple[str, ...], cfg: ModelConfig, ctx: ShardCtx) -> P:
    """The spec of one weight as a layer takes it (unstacked): a stored
    leaf's own, else ``_base_spec``'s for its names (the trailing keys on
    the way to it, e.g. ``("attn", "wq")``) and shape."""
    if isinstance(x, Stored):
        return x.spec
    spec, nd = _base_spec(tuple(names), tuple(x.shape), cfg, ctx)
    return P(*([None] * (x.ndim - nd)), *spec)


def model_dim(spec, ctx: ShardCtx) -> Optional[int]:
    """The dimension a spec cuts over the model axis, None if it keeps the
    tensor whole over it."""
    return next((d for d, e in enumerate(spec) if ctx.model_axis in _as_axes(e)), None)


def model_block(x, dim: int, ctx: ShardCtx) -> torch.Tensor:
    """The rank's "model" block along ``dim`` of a weight its spec cuts
    there: a stored one's "data" split gathered (``gather(keep=)``), a
    whole one narrowed (``block_of``)."""
    if isinstance(x, Stored):
        return gather(x, keep=(ctx.model_axis,))
    return block_of(x, ctx, dim)


def tp_weight(x, names: Tuple[str, ...], cfg: ModelConfig, ctx: ShardCtx) -> torch.Tensor:
    """A weight as a rank computes on it inside a layer's model-axis
    section: its "model" block where its spec cuts it over "model"
    (``model_block``), else gathered whole and entered through
    ``copy_to_model``, so its partial gradient is summed over "model"."""
    dim = model_dim(leaf_spec(x, names, cfg, ctx), ctx)
    return copy_to_model(gather(x), ctx) if dim is None else model_block(x, dim, ctx)


def param_specs(cfg: ModelConfig, ctx: ShardCtx) -> Any:
    """Spec tree matching ``init_params(cfg)``'s structure."""
    from repro_torch.models import model as M
    def rule(names, leaf):
        spec, base_nd = _base_spec(names, tuple(leaf.shape), cfg, ctx)
        pad = leaf.ndim - base_nd
        return P(*([None] * pad), *spec) if pad > 0 else spec

    return _map_with_names(rule, M.abstract_params(cfg))


# =============================================================================
# caches
# =============================================================================

def _b_ax(ctx: ShardCtx, batch: int):
    return ctx.batch_axes if divides(batch, ctx.dp) else None


def cache_specs(cfg: ModelConfig, ctx: ShardCtx, batch: int, max_seq: int = 8) -> Any:
    """Spec tree matching ``init_cache(cfg, batch, max_seq)``.

    Decode KV: seq over "model" (flash-decode sequence parallelism) when
    max_seq divides the TP degree; batch over the data axes when divisible,
    else replicated (long_500k B=1)."""
    from repro_torch.models import model as M
    b_ax = _b_ax(ctx, batch)
    m = ctx.model_axis

    def rule(names, shape):
        leafname, nd = names[-1], len(shape)
        if leafname in ("k", "v"):
            # ((stack dims...), B, S, H, D)
            pad = nd - 4
            s_ax = m if divides(shape[pad + 1], ctx.tp) else None
            return P(*([None] * pad), b_ax, s_ax, None, None)
        if leafname in ("ckv", "krope"):
            # ((L,), B, S, R)
            pad = nd - 3
            s_ax = m if divides(shape[pad + 1], ctx.tp) else None
            return P(*([None] * pad), b_ax, s_ax, None)
        if leafname == "ssm":
            # ((stack...), B, H, P, N)
            pad = nd - 4
            return P(*([None] * pad), b_ax, _ax(shape[pad + 1], ctx.tp, m), None, None)
        if leafname == "conv":
            # ((stack...), B, K-1, C)
            pad = nd - 3
            return P(*([None] * pad), b_ax, None, None)
        if leafname == "memory":
            return P(b_ax, None, None)
        return P(*([None] * nd))

    return _map_with_names(rule, M.cache_shapes(cfg, batch, max_seq))


# =============================================================================
# inputs
# =============================================================================

def input_shardings(cfg: ModelConfig, ctx: ShardCtx, cell: ShapeCell,
                    specs: Dict[str, Any]) -> Dict[str, P]:
    """Specs of a step's inputs; ``specs`` maps input name -> its shape
    (a tuple, or anything with ``.shape``)."""
    b_ax = _b_ax(ctx, cell.global_batch)
    out: Dict[str, P] = {}
    for name, s in specs.items():
        shape = tuple(getattr(s, "shape", s))
        if name in ("tokens", "labels"):
            out[name] = P(b_ax, None)   # seq kept whole; blocks re-shard internally
        elif name == "cache_pos":
            out[name] = P(b_ax)
        elif name in ("vision_embeds", "frames"):
            out[name] = P(b_ax, None, None)
        else:
            out[name] = P(*([None] * len(shape)))
    return out


# =============================================================================
# activations
# =============================================================================
# The reference pins some activations with ``with_sharding_constraint``;
# these name the layout each takes (None where the reference pins nothing),
# and the model code computes on them: ``seq_spec`` decides where the
# residual stream is the rank's sequence block (``ShardCtx.seq_blocks``),
# ``head_spec`` whether attention runs on the rank's heads or, for a
# multi-token call whose heads do not divide the model axis, on its block
# of the query sequence, ``ssm_head_spec`` whether the SSD runs on the
# rank's heads.

def _shape(x) -> Tuple[int, ...]:
    """The shape of a tensor, or a shape given as a tuple."""
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def head_spec(ctx: ShardCtx, x, allow_seq: bool = False) -> Optional[P]:
    """Attention's (B, S, H, D) activations (a tensor or its shape): heads
    over the model axis when they divide it, else (``allow_seq``, a
    multi-token call) the query sequence."""
    shape = _shape(x)
    if len(shape) != 4:
        return None
    b_ax = batch_axis(ctx, shape[0])
    if divides(shape[2], ctx.tp):
        return P(b_ax, None, ctx.model_axis, None)
    if allow_seq and shape[1] > 1 and divides(shape[1], ctx.tp):
        return P(b_ax, ctx.model_axis, None, None)
    return None


def ssm_head_spec(ctx: ShardCtx, x, head_axis: int) -> Optional[P]:
    """An SSD operand (a tensor or its shape): the head dim over the model
    axis, the batch over the batch axes."""
    shape = _shape(x)
    if not divides(shape[head_axis], ctx.tp):
        return None
    spec = [None] * len(shape)
    spec[0] = batch_axis(ctx, shape[0])
    spec[head_axis] = ctx.model_axis
    return P(*spec)


def seq_spec(ctx: ShardCtx, x) -> Optional[P]:
    """The (B, S, d) residual stream between blocks (a tensor or its
    shape): S over the model axis (sequence parallelism) when
    ``ctx.seq_parallel``."""
    shape = _shape(x)
    if (not ctx.seq_parallel or len(shape) != 3 or shape[1] == 1
            or not divides(shape[1], ctx.tp)):
        return None
    return P(batch_axis(ctx, shape[0]), ctx.model_axis, None)


def placements_of(mesh, spec: P) -> tuple:
    """DTensor placements of one spec on ``mesh``: for each mesh axis,
    ``Shard(d)`` if the spec splits dim d over it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dims = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dims[a] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in mesh.axis_names)


def named(mesh, spec_tree) -> Any:
    """The spec tree as a tree of DTensor placement tuples on ``mesh``."""
    if isinstance(spec_tree, P):
        return placements_of(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    return spec_tree


# =============================================================================
# the store
# =============================================================================

def _zip_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and its congruent spec tree (dicts,
    lists and NamedTuples; a ``P`` is a leaf of the spec tree)."""
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_zip_specs(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_specs(fn, v, s) for v, s in zip(tree, specs))
    raise TypeError(f"no spec for a leaf {type(tree).__name__}")


def _splits(spec) -> bool:
    return any(_as_axes(e) for e in spec)


def _place_leaf(mesh, x: torch.Tensor, spec: P):
    spec = P(*(tuple(spec) + (None,) * (x.ndim - len(spec))))
    if not _splits(spec):
        return x.contiguous()
    block = _block(mesh, x.shape, spec)
    if all(size == x.shape[d] for d, _, size in block):     # axes of one rank
        return Stored(x.contiguous(), spec, x.shape, mesh)
    local = _narrow(x, block).clone(memory_format=torch.contiguous_format)
    return Stored(local, spec, x.shape, mesh)


def place(tree, specs, mesh):
    """The store of ``tree`` on ``mesh``: every leaf a spec splits becomes
    this rank's block (``Stored``: a copy of its own, or the tensor itself
    where the block is all of it), every other leaf stays the whole tensor
    (made contiguous: an expanded view gets storage of its size).  Raises
    where a split dimension does not divide evenly."""
    return _zip_specs(lambda x, spec: _place_leaf(mesh, x, spec), tree, specs)


def stored_zeros(shapes, specs, mesh, dtype, device):
    """A zeroed tree of ``shapes`` (dicts and lists with shape tuples as
    leaves, ``models.model.cache_shapes``) stored by ``specs``: each rank
    allocates its block only."""
    def leaf(shape, spec):
        spec = P(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
        local = list(shape)
        for dim, _, size in _block(mesh, shape, spec):
            local[dim] = size
        zeros = torch.zeros(local, dtype=dtype, device=device)
        return Stored(zeros, spec, shape, mesh) if _splits(spec) else zeros

    return _zip_specs(leaf, shapes, specs)


def local_of(x) -> torch.Tensor:
    """The tensor a rank holds for a leaf: its block, or the whole."""
    return x.local if isinstance(x, Stored) else x


def local_bytes(tree) -> int:
    """The bytes this rank holds for ``tree``'s tensor leaves."""
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in map(local_of, leaves(tree))
               if isinstance(t, torch.Tensor))


def is_stored(tree) -> bool:
    from repro_torch.tree import leaves
    return any(isinstance(x, Stored) for x in leaves(tree))
