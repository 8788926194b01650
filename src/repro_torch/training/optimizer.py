"""AdamW with a configurable moment dtype, ported from
``repro.training.optimizer``.

The state is a NamedTuple ``(step, m, v)`` with ``m`` and ``v`` trees
congruent with the params.  The arithmetic is the reference's, step for
step: the clip scale cast to the gradient's dtype before the multiply (bf16
gradients are scaled in bf16), ``step + 1`` and the bias corrections in
f32, weight decay on matrices only (``ndim >= 2``), the new param cast
back to its dtype and the moments to ``moment_dtype``.  Leaves are walked
in the reference's flatten order (``repro_torch.tree``), which fixes
``global_norm``'s summation order.  On the store (``distributed/
sharding.py``) every leaf is updated on the rank's block, the moments
stored like their params, and ``global_norm`` sums each stored leaf's
squares over its block, then ``psum``s the sum over the axes the leaf is
split on (only those, so each element counts once).  Nothing is updated in place: as the
reference returns new arrays, ``adamw_update`` returns new tensors.
``abstract_adamw`` gives the state's shapes on the meta device (the dry
run's).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.distributed.context import Stored
from repro_torch.models.config import _DTYPES
from repro_torch.tree import leaves, map_tree, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0            # global-norm clip; 0 disables
    moment_dtype: str = "bfloat16"
    warmup_steps: int = 100
    decay_steps: int = 10_000         # cosine decay horizon
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor                # () int32
    m: Any                            # tree like params
    v: Any


def _on_block(fn, p):
    """``fn`` of a leaf's tensor: a stored leaf's block, stored alike."""
    return p.with_local(fn(p.local)) if isinstance(p, Stored) else fn(p)


def init_adamw(params: Any, cfg: AdamWConfig) -> AdamWState:
    dt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: _on_block(lambda t: torch.zeros(t.shape, dtype=dt, device=t.device), p)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=map_tree(zeros, params), v=map_tree(zeros, params))


def abstract_adamw(params_abstract: Any, cfg: AdamWConfig) -> AdamWState:
    """The state of ``init_adamw`` on the meta device (the dry run's)."""
    dt = _DTYPES[cfg.moment_dtype]
    meta = lambda p: torch.empty(p.shape, dtype=dt, device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=map_tree(meta, params_abstract), v=map_tree(meta, params_abstract))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_lr_frac * lr`` at ``decay_steps``; f32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _sum_squares(x) -> torch.Tensor:
    if not isinstance(x, Stored):
        return torch.sum(torch.square(x.float()))
    return x.mesh.psum(torch.sum(torch.square(x.local.float())), x.split_axes())


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the Python sum of per-leaf f32 sums of squares, in flatten
    order (a stored leaf's summed over the ranks of its blocks)."""
    sq = sum(_sum_squares(x) for x in leaves(tree))
    return torch.sqrt(sq)


UPDATE_CHUNK = 1 << 26   # elements of one leaf the update holds f32 temporaries for


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: AdamWState, cfg: AdamWConfig
                 ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step.  Returns (new params, new state, {"grad_norm", "lr"});
    ``grad_norm`` is the norm before clipping.  The clip scale is applied
    leaf by leaf inside the update (no clipped copy of the gradient tree),
    and a leaf above ``UPDATE_CHUNK`` elements is updated a flat slice at a
    time into its new tensors, so the f32 temporaries are one slice's: the
    update is elementwise, so the numbers are the same either way."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))
    mdt = _DTYPES[cfg.moment_dtype]

    def upd(p, g, m, v, decay: bool):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g32)
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    def leaf(p, g, m, v):
        decay = cfg.weight_decay > 0 and p.ndim >= 2        # decay matrices only
        n = p.numel()
        if n <= UPDATE_CHUNK:
            return upd(p, g, m, v, decay)
        outs = tuple(torch.empty(p.shape, dtype=dt, device=p.device)
                     for dt in (p.dtype, mdt, mdt))
        flat = [t.reshape(-1) for t in (p, g, m, v)]
        for i in range(0, n, UPDATE_CHUNK):
            part = upd(*(t[i:i + UPDATE_CHUNK] for t in flat), decay)
            for o, r in zip(outs, part):
                o.view(-1)[i:i + UPDATE_CHUNK] = r
        return outs

    def stored_leaf(p, g, m, v):
        if not isinstance(p, Stored):
            return leaf(p, g, m, v)
        outs = leaf(p.local, g.local, m.local, v.local)
        return tuple(p.with_local(o) for o in outs)

    out = [stored_leaf(p, g, m, v) for p, g, m, v in
           zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, m=new_m, v=new_v), {"grad_norm": gnorm, "lr": lr}
