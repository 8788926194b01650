"""Gradient compression, ported from ``repro.training.compression``: top-k
sparsification with error feedback and per-tensor int8 quantisation.

Both are pure functions of (grad, state) -> (compressed, new state) plus a
decompress.  ``quantize_int8`` is also what the paged KV cache stores its
int8 pages with.  Stochastic rounding draws from a ``torch.Generator``
where the reference takes a jax key, so its draws differ from the
reference's; its properties (unbiased, inside +-127) are what carries
over.  ``compressed_psum`` is the cross-pod reduce over a mesh axis of
``torch.distributed`` ranks, each rank holding its own gradients.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.context import current_ctx
from repro_torch.tree import leaves, map_tree, unflatten


class TopKState(NamedTuple):
    residual: Any                 # tree like grads, f32


def topk_init(grads_like: Any) -> TopKState:
    return TopKState(residual=map_tree(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def topk_compress(grads: Any, state: TopKState, frac: float = 0.05
                  ) -> Tuple[Any, TopKState]:
    """Returns (sparse grads (dense layout, zeros off-support), new state).
    Error feedback: the un-sent residual is added to the next step's grads.
    The threshold is the k-th largest |g|, and every entry at or above it is
    sent, so ties at the threshold are all kept, as with ``lax.top_k``."""
    def one(g, r):
        g32 = g.float() + r
        flat = g32.reshape(-1)
        k = max(1, int(flat.shape[0] * frac))
        thresh = torch.topk(flat.abs(), k).values[-1]
        sent = torch.where(flat.abs() >= thresh, flat, 0.0)
        return sent.reshape(g.shape).to(g.dtype), (flat - sent).reshape(g.shape)

    outs = [one(g, r) for g, r in zip(leaves(grads), leaves(state.residual))]
    return (unflatten(grads, [o[0] for o in outs]),
            TopKState(unflatten(grads, [o[1] for o in outs])))


def quantize_int8(g: torch.Tensor, generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): symmetric per-tensor scale
    max(|g|) / 127 (floored at 1e-12 / 127).  Round half to even, or, given
    a generator, stochastic rounding floor(x + U[0, 1)), which is unbiased."""
    scale = torch.clamp(torch.max(torch.abs(g.float())), min=1e-12) / 127.0
    x = g.float() / scale
    if generator is not None:
        x = torch.floor(x + torch.rand(g.shape, generator=generator,
                                       device=generator.device))
    else:
        x = torch.round(x)
    return torch.clamp(x, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(grads: Any, axis_name: str, frac: float = 0.0, int8: bool = False,
                    state: Optional[TopKState] = None, mesh=None):
    """Cross-pod gradient reduction with optional compression: the sum over
    the ranks of ``axis_name`` of each rank's gradients.  With ``frac > 0``
    (and a state) top-k with error feedback runs first; with ``int8`` each
    rank sends int8 quants, the int32 sum of the quants is scaled by the
    largest of the ranks' scales.  ``mesh`` defaults to the active shard
    context's.  Returns (reduced grads, new state)."""
    mesh = mesh if mesh is not None else current_ctx().mesh
    new_state = state
    if frac > 0 and state is not None:
        grads, new_state = topk_compress(grads, state, frac)
    if int8:
        def qd(g):
            q, s = quantize_int8(g)
            qsum = mesh.psum(q.to(torch.int32), axis_name)
            smax = mesh.pmax(s, axis_name)       # conservative shared scale
            return dequantize_int8(qsum, smax, g.dtype)
        grads = map_tree(qd, grads)
    else:
        grads = map_tree(lambda g: mesh.psum(g, axis_name), grads)
    return grads, new_state
