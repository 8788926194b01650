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

A block's stored weights (``distributed/sharding.py``'s store) are gathered
whole when the block runs and freed after it, except the experts a
sharded MoE region takes as they are stored; a full-sequence or mamba
block opens its stored cache whole and writes each rank's block back
(``context.opened``); an attention decode takes its stored cache itself.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed.context import current_ctx, gather_tree, opened
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ffn_apply, init_ffn, init_rms_norm, rms_norm
from repro_torch.models.moe_sharded import moe_apply_sharded


def _moe(p, cfg: ModelConfig, h, placement, dispatch_mode: str, stats: bool):
    """The expert-parallel path when a shard context is active and its
    model axis divides the experts, else the single-device MoE."""
    ctx = current_ctx()
    if ctx is not None and cfg.num_experts % ctx.tp == 0:
        return moe_apply_sharded(gather_tree(p, keep=_EXPERTS), cfg, h, placement, ctx,
                                 stats)
    return moe_lib.moe_apply(gather_tree(p), cfg, h, placement, dispatch_mode, stats)


_EXPERTS = ("w_gate", "w_up", "w_down")


def _weights(p: dict) -> dict:
    """The block's weights whole; the MoE's stay as stored for ``_moe``."""
    return gather_tree(p, keep=("moe",))


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


def _ffn_half(p: dict, cfg: ModelConfig, x, is_moe_layer: bool, placement,
              dispatch_mode: str, stats: bool):
    h = rms_norm(x, p["ffn_norm"]["scale"], cfg.norm_eps)
    aux = {}
    if is_moe_layer:
        y, aux = _moe(p["moe"], cfg, h, placement, dispatch_mode, stats)
    else:
        y = ffn_apply(p["ffn"], h)
    return x + y, aux


def attn_block_full(p: dict, cfg: ModelConfig, x, positions, is_local: bool, cache,
                    is_moe_layer: bool, placement, dispatch_mode: str, stats: bool):
    p = _weights(p)
    h = rms_norm(x, p["attn_norm"]["scale"], cfg.norm_eps)
    with _opened(cache) as c:
        a, _ = attn.attention_full(p["attn"], cfg, h, positions, is_local, c)
    x, aux = _ffn_half(p, cfg, x + a, is_moe_layer, placement, dispatch_mode, stats)
    return x, cache, aux


def attn_block_decode(p: dict, cfg: ModelConfig, x, cache, cache_pos,
                      is_local: bool, is_moe_layer: bool, placement,
                      dispatch_mode: str, stats: bool, mla_absorb: bool = False):
    """One decode step of a block against one layer's slot cache."""
    p = _weights(p)
    h = rms_norm(x, p["attn_norm"]["scale"], cfg.norm_eps)
    a, new_cache = attn.attention_decode(p["attn"], cfg, h, cache, cache_pos, is_local,
                                         mla_absorb=mla_absorb)
    x, aux = _ffn_half(p, cfg, x + a, is_moe_layer, placement, dispatch_mode, stats)
    return x, new_cache, aux


def attn_block_decode_paged(p: dict, cfg: ModelConfig, x, cache, block_tables,
                            lengths, is_local: bool, is_moe_layer: bool, placement,
                            dispatch_mode: str, stats: bool,
                            use_kernel: bool = False):
    """One decode step of a block against one layer's paged KV pool (GQA
    only: the paged layout rejects the other families up front)."""
    p = _weights(p)
    h = rms_norm(x, p["attn_norm"]["scale"], cfg.norm_eps)
    a, new_cache = attn.gqa_decode_paged(p["attn"], cfg, h, cache, block_tables,
                                         lengths, is_local, use_kernel)
    x, aux = _ffn_half(p, cfg, x + a, is_moe_layer, placement, dispatch_mode, stats)
    return x, new_cache, aux


# --- mamba block ---------------------------------------------------------------------

def mamba_block_full(p: dict, cfg: ModelConfig, x, cache):
    p = _weights(p)
    h = rms_norm(x, p["mamba_norm"]["scale"], cfg.norm_eps)
    with _opened(cache) as c:
        y, _ = m2.mamba2_full(p["mamba"], cfg, h, c)
    return x + y, cache


def mamba_block_decode(p: dict, cfg: ModelConfig, x, cache):
    p = _weights(p)
    h = rms_norm(x, p["mamba_norm"]["scale"], cfg.norm_eps)
    with _opened(cache) as c:
        y, _ = m2.mamba2_decode(p["mamba"], cfg, h, c)
    return x + y, cache


# --- whisper decoder block ----------------------------------------------------------

def cross_block_full(p: dict, cfg: ModelConfig, x, positions, memory, cache):
    p = _weights(p)
    h = rms_norm(x, p["attn_norm"]["scale"], cfg.norm_eps)
    with _opened(cache) as c:
        a, _ = attn.gqa_full(p["attn"], cfg, h, positions, False, c)
    x = x + a
    h = rms_norm(x, p["cross_norm"]["scale"], cfg.norm_eps)
    x = x + attn.cross_attention(p["cross"], cfg, h, memory)
    h = rms_norm(x, p["ffn_norm"]["scale"], cfg.norm_eps)
    return x + ffn_apply(p["ffn"], h), cache


def cross_block_decode(p: dict, cfg: ModelConfig, x, cache, cache_pos, memory):
    p = _weights(p)
    h = rms_norm(x, p["attn_norm"]["scale"], cfg.norm_eps)
    a, new_cache = attn.gqa_decode(p["attn"], cfg, h, cache, cache_pos, False)
    x = x + a
    h = rms_norm(x, p["cross_norm"]["scale"], cfg.norm_eps)
    x = x + attn.cross_attention(p["cross"], cfg, h, memory)
    h = rms_norm(x, p["ffn_norm"]["scale"], cfg.norm_eps)
    return x + ffn_apply(p["ffn"], h), new_cache


# --- whisper encoder block (non-causal, no rope) ---------------------------------------

def encoder_block_full(p: dict, cfg: ModelConfig, x):
    p = _weights(p)
    h = rms_norm(x, p["attn_norm"]["scale"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wv"])
    a = attn._sdpa_auto(cfg, q, k, v, 0, causal=False)
    x = x + torch.einsum("bshk,hkd->bsd", a, p["attn"]["wo"])
    h = rms_norm(x, p["ffn_norm"]["scale"], cfg.norm_eps)
    return x + ffn_apply(p["ffn"], h)
