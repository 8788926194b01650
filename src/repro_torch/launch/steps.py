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
none of the port's kernels.  The dry-run half (``train_inputs``,
``abstract_cache``, ``abstract_train_state``) waits for the last slice of
the port (ROADMAP.md, Queue 1 item 16e).
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

from repro_torch.distributed.context import P, ShardCtx, batch_axis, shard_ctx
from repro_torch.distributed.sharding import cache_specs, param_specs
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_update
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
            loss, grads = value_and_grad(loss_fn, params, batch)
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
    the loss does not reach gets zeros, as in JAX)."""
    flat = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), *args)
        wrt = [p for p in flat if p.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in flat:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
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

    @torch.no_grad()
    def prefill_step(params, batch):
        with _under(ctx):
            tokens = batch["tokens"]
            cache = M.init_cache(cfg, b, total_seq, device=tokens.device)
            kw = {k: batch[k] for k in ("vision_embeds", "frames") if k in batch}
            logits, new_cache, _ = M.prefill(params, cfg, tokens, cache,
                                             placements=batch.get("placements"), **kw)
            first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            return first, new_cache

    cspecs, out_specs = _serve_specs(cfg, ctx, b, total_seq)
    return prefill_step, cspecs, out_specs


def make_decode_step(cfg: ModelConfig, ctx: Optional[ShardCtx] = None,
                     cell: Optional[ShapeCell] = None):
    """One new token against a cache of ``cell.seq_len`` positions.
    Returns (serve_step, cache specs, out specs), the specs None without a
    context.  ``serve_step(params, cache, batch)`` -> (next greedy token
    (B,) int32, the cache, written in place); MLA decodes absorbed when
    ``ctx.mla_absorb``."""
    absorb = ctx.mla_absorb if ctx is not None else False

    @torch.no_grad()
    def serve_step(params, cache, batch):
        with _under(ctx):
            logits, new_cache, _ = M.decode_step(params, cfg, batch["tokens"], cache,
                                                 batch["cache_pos"],
                                                 placements=batch.get("placements"),
                                                 mla_absorb=absorb)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            return nxt, new_cache

    if cell is None:
        return serve_step, None, (None, None)
    cspecs, out_specs = _serve_specs(cfg, ctx, cell.global_batch, _total_seq(cfg, cell))
    return serve_step, cspecs, out_specs
