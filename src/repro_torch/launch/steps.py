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
trees.  Given stored params, the prefill step builds a stored cache, and
stored weights are gathered whole where the model takes them.  A batch
that arrives stored (cut by ``input_shardings``, as ``launch.train`` and the
dry run place it) runs as batch blocks (``batch_view``): the step computes
on this rank's rows only, as the reference's GSPMD does from its input
shardings; the loss is the global mean, the gradients the global ones, and
the next tokens come back as the rank's block.  A whole batch runs whole
on every rank, and the outputs come back stored by the out specs where the
params are stored.  ``train_inputs``, ``abstract_cache`` and
``abstract_train_state`` give a cell's inputs and state on the meta device
(the dry run's).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.distributed.context import (P, ShardCtx, Stored, _as_axes, batch_axis,
                                             current_ctx, gather, reduce_from_model,
                                             shard_ctx, sum_blocks, sum_partials, whole_of)
from repro_torch.distributed.sharding import (cache_specs, input_shardings, is_stored,
                                              param_specs, place, stored_zeros)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.training.optimizer import (AdamWConfig, AdamWState, abstract_adamw,
                                            adamw_update)
from repro_torch.tree import leaves, unflatten


def make_ctx(mesh, **overrides) -> ShardCtx:
    """The shard context of ``mesh``: its "pod" and "data" axes batch
    (unless ``overrides`` names the batch axes)."""
    overrides.setdefault("batch_axes", tuple(a for a in mesh.axis_names if a in ("pod", "data")))
    return ShardCtx(mesh=mesh, **overrides)


def _batch_ax(ctx: ShardCtx, b: int):
    return batch_axis(ctx, b)


def _under(ctx: Optional[ShardCtx]):
    """The context to run a step's body in: ``ctx``'s, or whatever is
    active when there is none."""
    return shard_ctx(ctx) if ctx is not None else contextlib.nullcontext()


def batch_view(ctx: Optional[ShardCtx], batch: dict):
    """(the context a step's body runs under, the batch as it computes on
    it).  A batch whose tokens arrive stored runs as batch blocks: each
    stored input (cut on dim 0 over the batch axes, nothing else) gives its
    block, and the context says so (``ShardCtx.batch_blocks``).  Otherwise
    every stored input is gathered whole and ``ctx`` is returned as it is."""
    if ctx is None or not isinstance(batch.get("tokens"), Stored):
        return ctx, {k: gather(v) for k, v in batch.items()}
    rows, out = tuple(ctx.batch_axes), {}
    for k, v in batch.items():
        if k == "placements":
            out[k] = gather(v)
        elif not isinstance(v, Stored):
            raise ValueError(f"the batch arrives stored, but its {k!r} is whole")
        elif _as_axes(v.spec[0]) != rows or any(_as_axes(e) for e in v.spec[1:]):
            raise ValueError(f"a batch input {k!r} cut by {v.spec} is no block of rows over "
                             f"the batch axes {rows}")
        else:
            out[k] = v.local
    return dataclasses.replace(ctx, batch_blocks=True), out


def _rows_out(x: torch.Tensor, ctx: ShardCtx) -> Stored:
    """This rank's block of a per-row output, stored by ``P(batch axes)``."""
    return Stored(x, P(ctx.batch_axes), (x.shape[0] * ctx.dp,), ctx.mesh)


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

def cross_entropy(logits, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) f32, or the rank's vocab block of them
    (``models.model.VocabBlock``); labels (B, S) int.  Mean over (B, S) of
    logsumexp - gold logit; under batch blocks over the global batch.

    The gold logit is a ``gather``, where the reference contracts the
    logits with a one-hot (a layout choice for vocab-sharded logits): a sum
    of exact zeros and one product with 1.0 is the gold logit itself, so
    both give the same f32 value, and the gather saves a (B, S, V) f32
    one-hot (622 MB at qwen3's vocabulary and 8 x 128 tokens).  On a vocab
    block the loss is vocab-parallel (``_vocab_parallel``)."""
    if isinstance(logits, M.VocabBlock):
        lse, gold = _vocab_parallel(logits, labels, current_ctx())
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ctx = current_ctx()
    if ctx is not None and ctx.batch_blocks:
        # the global mean: the blocks' sums over the global count
        return sum_blocks(torch.sum(lse - gold), ctx) / (lse.numel() * ctx.dp)
    return torch.mean(lse - gold)


def _vocab_parallel(logits, labels: torch.Tensor, ctx: ShardCtx):
    """(logsumexp, gold logit), each (B, S) and whole over "model", of
    logits held as the rank's vocab block: the row max by a pmax, the sum
    of the shifted exponentials and the gold logit (a gather on the rank
    that holds it, 0 elsewhere) by sums over "model" whose gradient passes
    through, so only the rank's block of the logits takes a gradient."""
    local, n = logits.local, logits.local.shape[-1]
    m = ctx.mesh.pmax(local.amax(-1), ctx.model_axis)
    sumexp = reduce_from_model(torch.exp(local - m[..., None]).sum(-1), ctx)
    ids = labels.long() - logits.start
    mine = (ids >= 0) & (ids < n)
    gold = torch.gather(local, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    return torch.log(sumexp) + m, reduce_from_model(gold * mine, ctx)


def _last_logits(logits) -> torch.Tensor:
    """The last position's logits (B, V), whole: a vocab block's gathered
    over "model"."""
    if isinstance(logits, M.VocabBlock):
        return whole_of(logits.local[:, -1], current_ctx(), 1)
    return logits[:, -1, :]


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
                                      placements=batch.get("placements"), vocab_blocks=True,
                                      **kw)
        if cfg.family == "vlm" and "vision_embeds" in batch:
            n = batch["vision_embeds"].shape[1]
            logits = (logits._replace(local=logits.local[:, n:])
                      if isinstance(logits, M.VocabBlock) else logits[:, n:, :])
        loss = cross_entropy(logits, batch["labels"])
        if cfg.is_moe:
            loss = loss + cfg.router_aux_coef * aux.get("load_balance_loss", 0.0) \
                + cfg.router_z_coef * aux.get("router_z_loss", 0.0)
        return loss

    def train_step(params, opt_state, batch):
        body_ctx, batch = batch_view(ctx, batch)
        with _under(body_ctx):
            loss, grads = value_and_grad(loss_fn, params, batch, ctx=body_ctx)
            params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
            return params, opt_state, {"loss": loss, **om}

    if ctx is None:
        return train_step, (None, None), (None, None, None)
    pspecs = param_specs(cfg, ctx)
    ospecs = AdamWState(step=P(), m=pspecs, v=pspecs)
    metric_specs = {"loss": P(), "grad_norm": P(), "lr": P()}
    return train_step, (pspecs, ospecs), (pspecs, ospecs, metric_specs)


def value_and_grad(loss_fn, params: Any, *args, ctx: Optional[ShardCtx] = None):
    """(loss, grads): ``loss_fn(params, *args)`` and its gradient with
    respect to every floating leaf of ``params``, as a tree like it (a leaf
    the loss does not reach gets zeros, as in JAX).  A stored leaf's
    gradient is stored like it: the gradient of its block.  Under a
    context with batch blocks, a leaf kept whole has its partial gradient
    summed over the batch axes (``context.sum_partials``)."""
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
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in ((t, next(got) if t.requires_grad else None) for t in flat)]
    if ctx is not None:
        whole = [i for i, (p, t) in enumerate(zip(orig, flat))
                 if t.requires_grad and not isinstance(p, Stored)]
        for i, g in zip(whole, sum_partials([grads[i] for i in whole], ctx)):
            grads[i] = g
    return loss.detach(), unflatten(params, [like(p, g) for p, g in zip(orig, grads)])


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
    token (B,) int32, the cache it filled); on the store (stored params or
    batch) the cache is stored, and under batch blocks the tokens are the
    rank's block, stored by ``P(batch axes)``."""
    b, total_seq = cell.global_batch, _total_seq(cfg, cell)

    cspecs, out_specs = _serve_specs(cfg, ctx, b, total_seq)

    @torch.no_grad()
    def prefill_step(params, batch):
        body_ctx, batch = batch_view(ctx, batch)
        blocks = body_ctx is not None and body_ctx.batch_blocks
        stored = ctx is not None and (blocks or is_stored(params))
        with _under(body_ctx):
            tokens = batch["tokens"]
            if stored:
                cache = stored_zeros(M.cache_shapes(cfg, b, total_seq), cspecs, ctx.mesh,
                                     cfg.adtype, tokens.device)
            else:
                cache = M.init_cache(cfg, b, total_seq, device=tokens.device)
            kw = {k: batch[k] for k in ("vision_embeds", "frames") if k in batch}
            logits, new_cache, _ = M.prefill(params, cfg, tokens, cache,
                                             placements=batch.get("placements"),
                                             vocab_blocks=True, **kw)
            first = torch.argmax(_last_logits(logits), dim=-1).to(torch.int32)
            if blocks:
                return _rows_out(first, ctx), new_cache
            return (place(first, out_specs[0], ctx.mesh) if stored else first), new_cache

    return prefill_step, cspecs, out_specs


def make_decode_step(cfg: ModelConfig, ctx: Optional[ShardCtx] = None,
                     cell: Optional[ShapeCell] = None):
    """One new token against a cache of ``cell.seq_len`` positions.
    Returns (serve_step, cache specs, out specs), the specs None without a
    context.  ``serve_step(params, cache, batch)`` -> (next greedy token
    (B,) int32, the cache, written in place); MLA decodes absorbed when
    ``ctx.mla_absorb``.  Under batch blocks the cache must be stored and
    the tokens come back as the rank's block, stored by ``P(batch
    axes)``."""
    absorb = ctx.mla_absorb if ctx is not None else False
    cspecs, out_specs = (_serve_specs(cfg, ctx, cell.global_batch, _total_seq(cfg, cell))
                         if cell is not None else (None, (None, None)))

    @torch.no_grad()
    def serve_step(params, cache, batch):
        body_ctx, batch = batch_view(ctx, batch)
        blocks = body_ctx is not None and body_ctx.batch_blocks
        stored = ctx is not None and is_stored(params)
        with _under(body_ctx):
            logits, new_cache, _ = M.decode_step(params, cfg, batch["tokens"], cache,
                                                 batch["cache_pos"],
                                                 placements=batch.get("placements"),
                                                 mla_absorb=absorb)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if blocks:
                return _rows_out(nxt, ctx), new_cache
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
