"""Expert-parallel MoE over ``torch.distributed``, ported from
``repro.models.moe_sharded`` (the reference's ``shard_map`` path).

Layout (the reference's): experts split over the "model" mesh axis (EP),
the expert FFN hidden dim additionally FSDP-split over "data"; activations
split over the batch ("pod", "data") axes and replicated over "model" on
entry.  The region runs through ``distributed.context.shard_map``: each
rank gets its block of the tokens and of the expert weights (a stored
weight's block as the store holds it, so the FSDP gather over "data"
starts from the rank's shard), and the body's collectives run over the
mesh's process groups.

Bodies:
  * "gather": activations are replicated over the model axis, so every EP
    rank already holds all tokens of its data shard; dispatch is a local
    gather of the tokens routed to the rank's slots (the FSDP-split weights
    are all-gathered over "data" first), and the combine is one ``psum``
    over "model".
  * "tokengather": the weights stay f-split; the (small) token set is
    all-gathered over the batch axes and the partial down-projections are
    summed over ("model", *batch axes); each data rank keeps its slice.
  * "a2a": the tokens are also split over the model axis; ranks exchange
    routed tokens with ``all_to_all``, compute, and exchange back.  Taken
    only when the token shard divides the model axis (the reference's
    rule); otherwise "a2a" runs the gather body.
  * "auto": token-gather when its bytes are below the weight gather's.

Under batch blocks (``ShardCtx.batch_blocks``) ``x`` is this rank's block
of the global batch, which the region takes as it is.  The router
statistics are the global ones, as the reference computes them on the
global tokens: the per-expert probability sums, selection counts and
squared log-normalizers are summed over the batch blocks
(``context.sum_blocks``) before ``E * sum(me * ce)``, and a selection's
replica is chosen by its global token index.

The placement maps S = E + R physical slots to logical experts; slot s
lives on EP rank s // (S / tp).  The per-rank combine is the fixed order
of ``models/moe.py``'s: each token gathers its k gated rows (a
selection routed to another rank, or dropped, reads a zero row) and sums
them in f32 in selection order, where the reference scatter-adds in
``x.dtype``; on the card a bf16 scatter-add is atomic and unordered.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.context import P, ShardCtx, batch_axis, divides, shard_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ffn_layer
from repro_torch.models.moe import (ExpertPlacement, _capacity, _combine,
                                    _dispatch_tables, _expert_ffn, _token_table,
                                    router_aux, router_probs, top_k_gating)


def _fsdp_gather(mesh, w: torch.Tensor, axis: int, sharded: bool) -> torch.Tensor:
    if not sharded:
        return w
    return mesh.all_gather(w, "data", dim=axis)


def _use_token_gather(cfg: ModelConfig, ctx: ShardCtx, t_loc: int,
                      f_sharded: bool) -> bool:
    """The cheaper EP communication pattern for a layer: the weight
    gather (3 * E_loc * d * f bytes over "data"), right for train and
    prefill, or the token gather (the token set over "data" and a psum),
    right for decode.  "tokengather" always picks the token gather, "auto"
    compares bytes."""
    if ctx.ep_mode == "tokengather":
        return True
    if ctx.ep_mode != "auto" or not f_sharded:
        return False
    dp = int(ctx.mesh.shape["data"])
    e_loc = cfg.num_experts // ctx.tp
    weight_bytes = 3 * e_loc * cfg.d_model * cfg.moe_d_ff * 2
    token_bytes = 2 * (t_loc * dp) * cfg.d_model * 2     # gather + psum
    return token_bytes < weight_bytes


def moe_apply_sharded(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      placement: Optional[ExpertPlacement], ctx: ShardCtx,
                      return_stats: bool = False):
    """x: (B, S, d), whole on every rank (under batch blocks, the rank's
    block).  Returns (y, aux) like ``moe_apply``; ``dropped_frac`` is the
    constant 0.0, as in the reference.  The shared experts' leaves may be
    stored (``layers.ffn_layer`` takes them on their "model" blocks)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    mesh, tp = ctx.mesh, ctx.tp
    dev = x.device
    if placement is None:
        placement = ExpertPlacement.identity(e, device=dev)
    ns = placement.num_slots                  # S = E + R physical expert slots
    assert divides(ns, tp), f"model axis {tp} must divide expert slots {ns}"
    e_loc = ns // tp                          # slots owned per EP rank

    bdim = ctx.dp
    b_ax = batch_axis(ctx, b)
    b_loc = b if ctx.batch_blocks else (b // bdim if b_ax else b)   # rows a region body sees
    t_loc = b_loc * s
    f_sharded = divides(cfg.moe_d_ff, int(mesh.shape["data"]))
    token_gather = b_ax is not None and _use_token_gather(cfg, ctx, t_loc, f_sharded)
    t_disp = t_loc * (bdim if token_gather else 1)   # tokens seen by dispatch
    cap = _capacity(cfg, t_disp)

    # --- router in logical-expert space (replicated over model) -------------
    xf = x.reshape(b * s, d)
    logits = xf.float() @ params["w_router"]
    probs = router_probs(logits)
    gates, expert_ids = top_k_gating(probs, k)
    first = mesh.axis_index(ctx.batch_axes) * b * s if ctx.batch_blocks else 0
    slot_idx = placement.dispatch_slots(expert_ids, first)     # replica-split slots
    gates = gates.to(x.dtype)

    wg_spec = P("model", None, "data" if f_sharded else None)
    wd_spec = P("model", "data" if f_sharded else None, None)

    def body_a2a(xb, slots, gt, wg, wu, wd):
        """Tokens also split over the model axis, routed to their slots'
        owners with all_to_all, computed, and sent back."""
        r = mesh.axis_index("model")
        tl = xb.shape[0] * xb.shape[1]
        assert tl % tp == 0, "token count must divide the model axis for a2a"
        tc = tl // tp
        # this rank keeps its token chunk (the router ran replicated over model)
        xr = xb.reshape(tl, d)[r * tc:(r + 1) * tc]
        sr = slots.reshape(tl, k)[r * tc:(r + 1) * tc]
        gr = gt.reshape(tl, k)[r * tc:(r + 1) * tc]
        wg_ = _fsdp_gather(mesh, wg, 2, f_sharded)
        wu_ = _fsdp_gather(mesh, wu, 2, f_sharded)
        wd_ = _fsdp_gather(mesh, wd, 1, f_sharded)

        cap_c = _capacity(cfg, tc)                       # per-chunk capacity
        pos, keep = _dispatch_tables(sr, ns, cap_c)
        table = _token_table(sr, pos, keep, ns, cap_c)
        valid = table < tc
        safe = table.clamp(max=tc - 1).long()
        xe_send = torch.where(valid[..., None], xr[safe], 0).to(xb.dtype)
        # (S, C, d) -> (tp, e_loc, C, d): destination-major, exchange tokens
        xe_recv = mesh.all_to_all(xe_send.reshape(tp, e_loc, cap_c, d), "model")
        # received (src, e_loc, C, d): group by this rank's slots
        xe = xe_recv.permute(1, 0, 2, 3).reshape(e_loc, tp * cap_c, d)
        ye = _expert_ffn({"w_gate": wg_, "w_up": wu_, "w_down": wd_}, xe)
        ye = ye.reshape(e_loc, tp, cap_c, d).permute(1, 0, 2, 3).contiguous()
        ye_back = mesh.all_to_all(ye, "model").reshape(ns, cap_c, d)   # my tokens' rows
        row_idx = torch.where(keep, sr.long() * cap_c + pos.long(), ns * cap_c)
        yr = _combine(ye_back, row_idx, gr, xb.dtype)
        # restore model-replication of the residual stream
        return mesh.all_gather(yr, "model", dim=0).reshape(xb.shape)

    def body(xb, slots, gt, wg, wu, wd):
        # xb: (B_loc, S, d) replicated over model; slots/gt: (B_loc, S, k)
        r = mesh.axis_index("model")
        tl = xb.shape[0] * xb.shape[1]
        xfl = xb.reshape(tl, d)
        slots = slots.reshape(tl, k)
        gt = gt.reshape(tl, k)
        if token_gather:
            # weights stationary (f stays split over "data"); gather the small
            # token set instead and partial-sum the down-projection
            xfl = mesh.all_gather(xfl, ctx.batch_axes, dim=0)
            slots = mesh.all_gather(slots, ctx.batch_axes, dim=0)
            gt = mesh.all_gather(gt, ctx.batch_axes, dim=0)
            tl = xfl.shape[0]
        else:
            wg = _fsdp_gather(mesh, wg, 2, f_sharded)
            wu = _fsdp_gather(mesh, wu, 2, f_sharded)
            wd = _fsdp_gather(mesh, wd, 1, f_sharded)

        pos, keep = _dispatch_tables(slots, ns, cap)
        # token-index table over ALL slots, then this rank's slots
        table = _token_table(slots, pos, keep, ns, cap)[r * e_loc:(r + 1) * e_loc]
        valid = table < tl
        safe = table.clamp(max=tl - 1).long()
        xe = torch.where(valid[..., None], xfl[safe], 0).to(xb.dtype)
        ye = _expert_ffn({"w_gate": wg, "w_up": wu, "w_down": wd}, xe)

        local = slots.long() - r * e_loc
        mine = keep & (local >= 0) & (local < e_loc)
        row_idx = torch.where(mine, local * cap + pos.long(), e_loc * cap)
        y = _combine(ye, row_idx, gt, xb.dtype)
        if token_gather:
            # combine over experts (model) and partial-f products (data),
            # then keep this data rank's token slice
            y = mesh.psum(y, ("model",) + tuple(ctx.batch_axes))
            my = mesh.axis_index(ctx.batch_axes)
            t_own = xb.shape[0] * xb.shape[1]
            y = y[my * t_own:(my + 1) * t_own]
        else:
            y = mesh.psum(y, "model")
        return y.reshape(xb.shape)

    fn = body_a2a if (ctx.ep_mode == "a2a" and not token_gather
                      and divides(t_loc, tp)) else body
    tok = P(b_ax, None, None)
    y = shard_map(fn, mesh, in_specs=(tok, tok, tok, wg_spec, wg_spec, wd_spec),
                  out_specs=tok)(x, slot_idx.reshape(b, s, k), gates.reshape(b, s, k),
                                 params["w_gate"], params["w_up"], params["w_down"])

    y = y.reshape(b * s, d)
    if cfg.num_shared_experts > 0:
        # the shared experts: the dense FFN's rules, on the tokens whole
        y = y + ffn_layer(params["shared"], cfg, xf, ("moe", "shared"), seq=False)

    aux = router_aux(probs, logits, expert_ids, k, ctx, return_stats)
    if return_stats:
        aux["expert_ids"] = expert_ids.reshape(b, s, k).to(torch.int32)
        aux["dropped_frac"] = torch.zeros((), dtype=torch.float32, device=dev)
    return y.reshape(b, s, d), aux
