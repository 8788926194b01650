"""Step functions (train / prefill / decode), ported from
``repro.launch.steps``.

Each ``make_*_step(cfg, ctx, cell)`` returns the reference's triple: the
step, its input specs and its output specs (``distributed/sharding.py``
spec trees).  Given a shard context (``make_ctx``) the step runs its body
under it, as the reference does, so the MoE layers take the
expert-parallel path and slot decodes the sequence-sharded ones, at any
world size, 1 included; the decode step passes ``ctx.mla_absorb``.  With
``ctx=None`` the step runs the plain single-device path and the specs are
None.  The train step differentiates with autograd; training reaches
none of the port's kernels.

A step takes the store (``distributed/sharding.py``) as well as whole
trees: given stored params, the prefill step builds a stored cache, every
step gathers its stored inputs whole where the model takes them, and the
outputs come back stored by the out specs (what a rank keeps of them).
``train_inputs``, ``abstract_cache`` and ``abstract_train_state`` give a
cell's inputs and state on the meta device (the dry run's).
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

from repro_torch.distributed.context import (P, ShardCtx, Stored, batch_axis, gather,
                                             shard_ctx)
from repro_torch.distributed.sharding import (cache_specs, input_shardings, is_stored,
                                              param_specs, place, stored_zeros)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.training.optimizer import (AdamWConfig, AdamWState, abstract_adamw,
                                            adamw_update)
from repro_torch.tree import leaves, unflatten


def make_ctx(mesh, **overrides) -> ShardCtx:
    """The shard context of ``mesh``: its "pod" and "data" axes batch."""
    batch_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return ShardCtx(mesh=mesh, batch_axes=batch_axes, **overrides)


def _batch_ax(ctx: ShardCtx, b: int):
    return batch_axis(ctx, b)


def _under(ctx: Optional[ShardCtx]):
    """The context to run a step's body in: ``ctx``'s, or whatever is
    active when there is none."""
    return shard_ctx(ctx) if ctx is not None else contextlib.nullcontext()


def _whole_batch(batch: dict) -> dict:
    return {k: gather(v) for k, v in batch.items()}


def placements_input(cfg: ModelConfig, device=None) -> Optional[torch.Tensor]:
    """(n_moe_layers, E) int32 expert placement slot map (slot -> logical
    expert), the identity layout training runs on; None for a model with no
    MoE layer."""
    if not cfg.is_moe:
        return None
    eye = torch.arange(cfg.num_experts, dtype=torch.int32, device=device)
    return eye.expand(cfg.num_moe_layers(), cfg.num_experts)


# =============================================================================
# loss
# =============================================================================

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) f32; labels (B, S) int.  Mean over (B, S) of
    logsumexp - gold logit.

    The gold logit is a ``gather``, where the reference contracts the
    logits with a one-hot (a layout choice for vocab-sharded logits): a sum
    of exact zeros and one product with 1.0 is the gold logit itself, so
    both give the same f32 value, and the gather saves a (B, S, V) f32
    one-hot (622 MB at qwen3's vocabulary and 8 x 128 tokens)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


# =============================================================================
# train step
# =============================================================================

def make_train_step(cfg: ModelConfig, ctx: Optional[ShardCtx] = None,
                    cell: Optional[ShapeCell] = None,
                    opt_cfg: Optional[AdamWConfig] = None, remat: bool = True):
    """Returns (train_step, (param specs, optimizer specs), (param specs,
    optimizer specs, metric specs)), the specs None without a context.
    ``train_step(params, opt_state, batch)`` -> (params,
    opt_state, {"loss", "grad_norm", "lr"}): the cross-entropy, plus for a
    MoE ``router_aux_coef * load_balance_loss + router_z_coef *
    router_z_loss``; a VLM's logits are sliced past its vision prefix.  The
    batch holds "tokens" and "labels" and, where the model takes them,
    "placements", "vision_embeds" and "frames".  With ``remat`` every stack
    unit is recomputed in the backward pass (``cfg.remat``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    tcfg = cfg.replace(remat=remat, remat_policy="none") if remat else cfg

    def loss_fn(p, batch):
        kw = {}
        if "vision_embeds" in batch:
            kw["vision_embeds"] = batch["vision_embeds"]
        if "frames" in batch:
            kw["frames"] = batch["frames"]
        logits, aux = M.forward_train(p, tcfg, batch["tokens"],
                                      placements=batch.get("placements"), **kw)
        if cfg.family == "vlm" and "vision_embeds" in batch:
            logits = logits[:, batch["vision_embeds"].shape[1]:, :]
        loss = cross_entropy(logits, batch["labels"])
        if cfg.is_moe:
            loss = loss + cfg.router_aux_coef * aux.get("load_balance_loss", 0.0) \
                + cfg.router_z_coef * aux.get("router_z_loss", 0.0)
        return loss

    def train_step(params, opt_state, batch):
        with _under(ctx):
            loss, grads = value_and_grad(loss_fn, params, _whole_batch(batch))
            params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
            return params, opt_state, {"loss": loss, **om}

    if ctx is None:
        return train_step, (None, None), (None, None, None)
    pspecs = param_specs(cfg, ctx)
    ospecs = AdamWState(step=P(), m=pspecs, v=pspecs)
    metric_specs = {"loss": P(), "grad_norm": P(), "lr": P()}
    return train_step, (pspecs, ospecs), (pspecs, ospecs, metric_specs)


def value_and_grad(loss_fn, params: Any, *args):
    """(loss, grads): ``loss_fn(params, *args)`` and its gradient with
    respect to every floating leaf of ``params``, as a tree like it (a leaf
    the loss does not reach gets zeros, as in JAX).  A stored leaf's
    gradient is stored like it: the gradient of its block."""
    def local(p):
        return p.local if isinstance(p, Stored) else p

    def like(p, t):
        return p.with_local(t) if isinstance(p, Stored) else t

    orig = leaves(params)
    flat = [local(p).detach().requires_grad_(local(p).is_floating_point()) for p in orig]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, [like(p, t) for p, t in zip(orig, flat)]), *args)
        wrt = [p for p in flat if p.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p, t in zip(orig, flat):
        g = next(got) if t.requires_grad else None
        grads.append(like(p, torch.zeros_like(t) if g is None else g))
    return loss.detach(), unflatten(params, grads)


# =============================================================================
# serving steps
# =============================================================================

def _total_seq(cfg: ModelConfig, cell: ShapeCell) -> int:
    return cell.seq_len + (cfg.vision_prefix_len if cfg.family == "vlm" else 0)


def _serve_specs(cfg: ModelConfig, ctx: Optional[ShardCtx], b: int, total_seq: int):
    """(cache specs, (next-token spec, cache specs)), None without a
    context."""
    if ctx is None:
        return None, (None, None)
    cspecs = cache_specs(cfg, ctx, b, total_seq)
    return cspecs, (P(_batch_ax(ctx, b)), cspecs)


def make_prefill_step(cfg: ModelConfig, ctx: Optional[ShardCtx] = None,
                      cell: Optional[ShapeCell] = None):
    """Returns (prefill_step, cache specs, out specs), the specs None
    without a context.  ``prefill_step(params, batch)`` -> (first greedy
    token (B,) int32, the cache it filled)."""
    b, total_seq = cell.global_batch, _total_seq(cfg, cell)

    cspecs, out_specs = _serve_specs(cfg, ctx, b, total_seq)

    @torch.no_grad()
    def prefill_step(params, batch):
        stored = ctx is not None and is_stored(params)
        with _under(ctx):
            batch = _whole_batch(batch)
            tokens = batch["tokens"]
            if stored:
                cache = stored_zeros(M.cache_shapes(cfg, b, total_seq), cspecs, ctx.mesh,
                                     cfg.adtype, tokens.device)
            else:
                cache = M.init_cache(cfg, b, total_seq, device=tokens.device)
            kw = {k: batch[k] for k in ("vision_embeds", "frames") if k in batch}
            logits, new_cache, _ = M.prefill(params, cfg, tokens, cache,
                                             placements=batch.get("placements"), **kw)
            first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            return (place(first, out_specs[0], ctx.mesh) if stored else first), new_cache

    return prefill_step, cspecs, out_specs


def make_decode_step(cfg: ModelConfig, ctx: Optional[ShardCtx] = None,
                     cell: Optional[ShapeCell] = None):
    """One new token against a cache of ``cell.seq_len`` positions.
    Returns (serve_step, cache specs, out specs), the specs None without a
    context.  ``serve_step(params, cache, batch)`` -> (next greedy token
    (B,) int32, the cache, written in place); MLA decodes absorbed when
    ``ctx.mla_absorb``."""
    absorb = ctx.mla_absorb if ctx is not None else False
    cspecs, out_specs = (_serve_specs(cfg, ctx, cell.global_batch, _total_seq(cfg, cell))
                         if cell is not None else (None, (None, None)))

    @torch.no_grad()
    def serve_step(params, cache, batch):
        stored = ctx is not None and is_stored(params)
        with _under(ctx):
            batch = _whole_batch(batch)
            logits, new_cache, _ = M.decode_step(params, cfg, batch["tokens"], cache,
                                                 batch["cache_pos"],
                                                 placements=batch.get("placements"),
                                                 mla_absorb=absorb)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if stored:
                nxt = place(nxt, P(_batch_ax(ctx, nxt.shape[0])), ctx.mesh)
            return nxt, new_cache

    return serve_step, cspecs, out_specs


# =============================================================================
# the dry run's stand-ins
# =============================================================================

def train_inputs(cfg: ModelConfig, ctx: ShardCtx, cell: ShapeCell, specs: dict):
    """(batch, batch specs) of a cell: ``specs`` (``configs.input_specs``)
    plus, for a MoE, the identity placements (replicated)."""
    batch = dict(specs)
    shardings = input_shardings(cfg, ctx, cell, specs)
    pl = placements_input(cfg, device=next(iter(specs.values())).device)
    if pl is not None:
        batch["placements"] = pl
        shardings["placements"] = P(None, None)
    return batch, shardings


def abstract_cache(cfg: ModelConfig, cell: ShapeCell) -> Any:
    """The decode cache of a cell on the meta device."""
    return M.init_cache(cfg, cell.global_batch, _total_seq(cfg, cell), device="meta")


def abstract_train_state(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None):
    """(params, AdamW state) on the meta device, with the reference's
    default optimizer (bf16 moments)."""
    opt_cfg = opt_cfg or AdamWConfig()
    aparams = M.abstract_params(cfg)
    return aparams, abstract_adamw(aparams, opt_cfg)
