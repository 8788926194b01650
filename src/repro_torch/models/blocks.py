"""Per-layer blocks, ported from ``repro.models.blocks``: the attention
block (pre-norm -> attention (GQA or MLA) -> residual -> pre-norm ->
FFN/MoE -> residual), the mamba block (pre-norm -> Mamba2 mixer ->
residual, no FFN), whisper's decoder block (self-attention, cross-
attention over the encoder memory, FFN) and its non-causal encoder block.
Block params are plain dicts; a stack of L layers is the same dict with a
leading L axis (models/model.py).  Under a shard context whose model axis
divides the expert count, a MoE layer takes the expert-parallel path
(``models/moe_sharded.py``), which ignores ``dispatch_mode``, as the
reference's does.

A block's stored weights (``distributed/sharding.py``'s store) are taken
by its layers as they compute on them: under a context each layer takes
the rank's "model" blocks and gathers the rest whole
(``sharding.tp_weight``), a sharded MoE region takes the experts as they
are stored; without a context the block gathers its weights whole.  A
full-sequence or mamba block opens its stored cache whole and writes each
rank's block back (``context.opened``); an attention decode takes its
stored cache itself.  Under a context the residual stream ``x`` is in its
layout (the rank's sequence block when ``ShardCtx.seq_blocks``): the
pre-norms run on it (``layers.residual_norm``), each layer returns its
output in it, and the MoE region, which takes its tokens whole over
"model", gathers the sequence on entry and keeps the rank's block on exit.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import tracing
from repro_torch.distributed.context import (block_of, current_ctx, gather_tree, opened,
                                             whole_of)
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ffn_layer, init_ffn, init_rms_norm,
                                       residual_norm)
from repro_torch.models.moe_sharded import moe_apply_sharded


def _moe(p, cfg: ModelConfig, h, placement, dispatch_mode: str, stats: bool):
    """The expert-parallel path when a shard context is active and its
    model axis divides the experts, else the single-device MoE; both take
    the tokens whole over "model"."""
    ctx = current_ctx()
    seq = ctx is not None and ctx.seq_blocks
    if seq:
        h = whole_of(h, ctx, 1)
    if ctx is not None and cfg.num_experts % ctx.tp == 0:
        y, aux = moe_apply_sharded(gather_tree(p, keep=_SHARDED), cfg, h, placement, ctx,
                                   stats)
    else:
        y, aux = moe_lib.moe_apply(gather_tree(p), cfg, h, placement, dispatch_mode, stats)
    return (block_of(y, ctx, 1) if seq else y), aux


_SHARDED = ("w_gate", "w_up", "w_down", "shared")    # the region's and the shared FFN's


def _weights(p: dict) -> dict:
    """Without a context, the block's weights whole; under one each layer
    takes its own."""
    return gather_tree(p) if current_ctx() is None else p


def _opened(cache):
    return opened(cache) if cache is not None else contextlib.nullcontext()


def init_block(gen: torch.Generator, cfg: ModelConfig, is_moe_layer: bool,
               mixer: str = "attn") -> dict:
    """mixer: 'attn' | 'mamba' (a mamba block has no FFN); ``gen`` draws on
    the target device."""
    if mixer == "mamba":
        return {"mamba_norm": init_rms_norm(cfg.d_model, cfg.adtype, gen.device),
                "mamba": m2.init_mamba2(gen, cfg)}
    p = {
        "attn_norm": init_rms_norm(cfg.d_model, cfg.adtype, gen.device),
        "attn": attn.init_attention(gen, cfg),
        "ffn_norm": init_rms_norm(cfg.d_model, cfg.adtype, gen.device),
    }
    if is_moe_layer:
        p["moe"] = moe_lib.init_moe(gen, cfg)
    else:
        p["ffn"] = init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.adtype)
    return p


def init_cross_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Whisper decoder block: self-attention + cross-attention + FFN."""
    dev = gen.device
    return {
        "attn_norm": init_rms_norm(cfg.d_model, cfg.adtype, dev),
        "attn": attn.init_gqa(gen, cfg),
        "cross_norm": init_rms_norm(cfg.d_model, cfg.adtype, dev),
        "cross": attn.init_gqa(gen, cfg),
        "ffn_norm": init_rms_norm(cfg.d_model, cfg.adtype, dev),
        "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.adtype),
    }


def _norm(p: dict, name: str, cfg: ModelConfig, x):
    return residual_norm(x, p[name]["scale"], cfg.norm_eps)


def _ffn_half(p: dict, cfg: ModelConfig, x, is_moe_layer: bool, placement,
              dispatch_mode: str, stats: bool):
    """The block's second half: pre-norm, MoE or FFN, residual; its span
    (``moe`` or ``ffn``) holds all three."""
    with tracing.span("moe" if is_moe_layer else "ffn"):
        h = _norm(p, "ffn_norm", cfg, x)
        aux = {}
        if is_moe_layer:
            y, aux = _moe(p["moe"], cfg, h, placement, dispatch_mode, stats)
        else:
            y = ffn_layer(p["ffn"], cfg, h)
        return x + y, aux


def attn_block_full(p: dict, cfg: ModelConfig, x, positions, is_local: bool, cache,
                    is_moe_layer: bool, placement, dispatch_mode: str, stats: bool):
    p = _weights(p)
    with tracing.span("attention"):
        h = _norm(p, "attn_norm", cfg, x)
        with _opened(cache) as c:
            a, _ = attn.attention_full(p["attn"], cfg, h, positions, is_local, c)
        x = x + a
    x, aux = _ffn_half(p, cfg, x, is_moe_layer, placement, dispatch_mode, stats)
    return x, cache, aux


def attn_block_decode(p: dict, cfg: ModelConfig, x, cache, cache_pos,
                      is_local: bool, is_moe_layer: bool, placement,
                      dispatch_mode: str, stats: bool, mla_absorb: bool = False):
    """One decode step of a block against one layer's slot cache."""
    p = _weights(p)
    with tracing.span("attention"):
        h = _norm(p, "attn_norm", cfg, x)
        a, new_cache = attn.attention_decode(p["attn"], cfg, h, cache, cache_pos, is_local,
                                             mla_absorb=mla_absorb)
        x = x + a
    x, aux = _ffn_half(p, cfg, x, is_moe_layer, placement, dispatch_mode, stats)
    return x, new_cache, aux


def attn_block_decode_paged(p: dict, cfg: ModelConfig, x, cache, block_tables,
                            lengths, is_local: bool, is_moe_layer: bool, placement,
                            dispatch_mode: str, stats: bool,
                            use_kernel: bool = False):
    """One decode step of a block against one layer's paged KV pool (GQA
    only: the paged layout rejects the other families up front); its
    attention runs whole."""
    p = _weights(p)
    with tracing.span("attention"):
        h = _norm(p, "attn_norm", cfg, x)
        a, new_cache = attn.gqa_decode_paged(gather_tree(p["attn"]), cfg, h, cache,
                                             block_tables, lengths, is_local, use_kernel)
        x = x + a
    x, aux = _ffn_half(p, cfg, x, is_moe_layer, placement, dispatch_mode, stats)
    return x, new_cache, aux


# --- mamba block ---------------------------------------------------------------------

def mamba_block_full(p: dict, cfg: ModelConfig, x, cache):
    p = _weights(p)
    h = _norm(p, "mamba_norm", cfg, x)
    with _opened(cache) as c:
        y, _ = m2.mamba2_full(p["mamba"], cfg, h, c)
    return x + y, cache


def mamba_block_decode(p: dict, cfg: ModelConfig, x, cache):
    p = _weights(p)
    h = _norm(p, "mamba_norm", cfg, x)
    with _opened(cache) as c:
        y, _ = m2.mamba2_decode(p["mamba"], cfg, h, c)
    return x + y, cache


# --- whisper decoder block ----------------------------------------------------------

def cross_block_full(p: dict, cfg: ModelConfig, x, positions, memory, cache):
    p = _weights(p)
    h = _norm(p, "attn_norm", cfg, x)
    with _opened(cache) as c:
        a, _ = attn.gqa_full(p["attn"], cfg, h, positions, False, c)
    x = x + a
    h = _norm(p, "cross_norm", cfg, x)
    x = x + attn.cross_attention(p["cross"], cfg, h, memory)
    h = _norm(p, "ffn_norm", cfg, x)
    return x + ffn_layer(p["ffn"], cfg, h), cache


def cross_block_decode(p: dict, cfg: ModelConfig, x, cache, cache_pos, memory):
    p = _weights(p)
    h = _norm(p, "attn_norm", cfg, x)
    a, new_cache = attn.gqa_decode(p["attn"], cfg, h, cache, cache_pos, False)
    x = x + a
    h = _norm(p, "cross_norm", cfg, x)
    x = x + attn.cross_attention(p["cross"], cfg, h, memory)
    h = _norm(p, "ffn_norm", cfg, x)
    return x + ffn_layer(p["ffn"], cfg, h), new_cache


# --- whisper encoder block (non-causal, no rope) ---------------------------------------

def encoder_block_full(p: dict, cfg: ModelConfig, x):
    p = _weights(p)
    h = _norm(p, "attn_norm", cfg, x)
    x = x + attn.encoder_attention(p["attn"], cfg, h)
    h = _norm(p, "ffn_norm", cfg, x)
    return x + ffn_layer(p["ffn"], cfg, h)
