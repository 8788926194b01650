"""Step functions (train / prefill / decode), ported from
``repro.launch.steps`` for one device.

Each ``make_*_step`` keeps the reference's return shape, with ``None`` in
place of the partition specs: the shardings, ``make_ctx`` and the dry-run
half (``train_inputs``, ``abstract_cache``, ``abstract_train_state``) wait
for the sharding slice (ROADMAP.md, Queue 1 item 16), so ``ctx`` must be
None.  The train step differentiates with autograd: training runs the
forward with its default dense dispatch, so it launches none of the
port's kernels.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.tree import leaves, unflatten


def _no_ctx(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError("sharded steps wait for the sharding slice "
                                  "(ROADMAP.md, Queue 1 item 16); pass ctx=None")


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

def make_train_step(cfg: ModelConfig, ctx=None, cell: Optional[ShapeCell] = None,
                    opt_cfg: Optional[AdamWConfig] = None, remat: bool = True):
    """Returns (train_step, (param specs, optimizer specs), out specs), the
    specs None.  ``train_step(params, opt_state, batch)`` -> (params,
    opt_state, {"loss", "grad_norm", "lr"}): the cross-entropy, plus for a
    MoE ``router_aux_coef * load_balance_loss + router_z_coef *
    router_z_loss``; a VLM's logits are sliced past its vision prefix.  The
    batch holds "tokens" and "labels" and, where the model takes them,
    "placements", "vision_embeds" and "frames".  With ``remat`` every stack
    unit is recomputed in the backward pass (``cfg.remat``)."""
    _no_ctx(ctx)
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
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step, (None, None), (None, None, None)


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


def make_prefill_step(cfg: ModelConfig, ctx=None, cell: Optional[ShapeCell] = None):
    """Returns (prefill_step, cache specs, out specs), the specs None.
    ``prefill_step(params, batch)`` -> (first greedy token (B,) int32, the
    cache it filled)."""
    _no_ctx(ctx)
    b, total_seq = cell.global_batch, _total_seq(cfg, cell)

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache = M.init_cache(cfg, b, total_seq, device=tokens.device)
        kw = {k: batch[k] for k in ("vision_embeds", "frames") if k in batch}
        logits, new_cache, _ = M.prefill(params, cfg, tokens, cache,
                                         placements=batch.get("placements"), **kw)
        first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return first, new_cache

    return prefill_step, None, (None, None)


def make_decode_step(cfg: ModelConfig, ctx=None, cell: Optional[ShapeCell] = None):
    """One new token against a cache of ``cell.seq_len`` positions.
    Returns (serve_step, cache specs, out specs), the specs None.
    ``serve_step(params, cache, batch)`` -> (next greedy token (B,) int32,
    the cache, written in place)."""
    _no_ctx(ctx)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        logits, new_cache, _ = M.decode_step(params, cfg, batch["tokens"], cache,
                                             batch["cache_pos"],
                                             placements=batch.get("placements"))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, new_cache

    return serve_step, None, (None, None)
