"""Language model of the port: init / prefill / slot and paged decode for
homogeneous GQA stacks, ported from ``repro.models.model``: MoE (qwen3) and
dense (gemma2's local/global alternation and softcaps, qwen2's QKV bias,
granite's GQA and MQA), and a VLM's language model (internvl2), whose stub
vision frontend's embeddings prefix the tokens at prefill.

Parameters keep the reference's stacked layout: ``params["blocks"]`` holds
every layer's tensors with a leading L axis, so a layer is ``a[l]`` of every
leaf and relocating experts is a gather on the expert axis.  A Python loop
over layers replaces ``lax.scan``, so each layer's local/global flag is a
Python bool and only its own attention branch runs (the reference's scan
computes both branches and selects).  The other families (prologue /
interleaved MoE, SSM, hybrid, MLA, encoder-decoder) are later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch import device as devlib
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_apply, init_embed, init_rms_norm,
                                       rms_norm, unembed_apply)
from repro_torch.models.moe import ExpertPlacement


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.attention_type != "gqa" or cfg.is_ssm or cfg.is_hybrid
            or cfg.is_encoder_decoder
            or (cfg.is_moe and (cfg.first_k_dense != 0 or cfg.moe_every != 1))):
        raise NotImplementedError(
            f"{cfg.name}: the port runs homogeneous GQA stacks only so far; "
            "first_k_dense / interleaved MoE, SSM and hybrid stacks, MLA and "
            "encoder-decoder models wait for ROADMAP.md Queue 1 items 12-14")


def _stack(trees: List[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, l: int):
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


# =============================================================================
# init
# =============================================================================

def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Seeded random parameters on ``device`` (the card by default), drawn
    from the same distributions as the reference's init (not the same
    numbers: bridge the reference's weights with ``models.convert``)."""
    _check_supported(cfg)
    dev = devlib.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.adtype,
                            cfg.tie_embeddings),
        "final_norm": init_rms_norm(cfg.d_model, cfg.adtype, dev),
    }
    params["blocks"] = _stack([B.init_block(gen, cfg, cfg.layer_is_moe(i))
                               for i in range(cfg.num_layers)])
    return params


# =============================================================================
# caches
# =============================================================================

def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """The shape of every leaf of ``init_cache``'s tree, allocating nothing."""
    _check_supported(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": {"k": shape, "v": shape}}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """Contiguous per-layer K/V cache {"layers": {"k": (L,B,S,Hkv,D), "v"}}:
    the slot layout's cache, and the prefill output the paged cache copies
    its pages from."""
    dev = devlib.resolve(device)
    dt = dtype or cfg.adtype
    return {"layers": {name: torch.zeros(shape, dtype=dt, device=dev)
                       for name, shape in cache_shapes(cfg, batch, max_seq)["layers"].items()}}


# =============================================================================
# forward passes
# =============================================================================

def _placement_stack(cfg: ModelConfig, placements, device) -> Optional[torch.Tensor]:
    """placements: None | (L, S) int32 slot-map array, S = E + R."""
    if placements is None or not cfg.is_moe:
        return None
    return torch.as_tensor(placements, dtype=torch.int32, device=device)


def _placement(cfg: ModelConfig, pstack, l: int) -> Optional[ExpertPlacement]:
    if pstack is None:
        return None
    return ExpertPlacement.from_slot_map(pstack[l], cfg.num_experts)


def _agg_aux(auxs: List[dict]) -> dict:
    """Sum the router losses over layers; stack every other stat (L, ...)."""
    out = {}
    if not auxs or not auxs[0]:
        return out
    for k in auxs[0]:
        v = torch.stack([a[k] for a in auxs])
        out[k] = v.sum() if k in ("load_balance_loss", "router_z_loss") else v
    return out


def _head(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    w = (params["embed"]["embedding"] if cfg.tie_embeddings
         else params["embed"]["unembedding"])
    return unembed_apply({"unembedding": w}, x, cfg.final_logit_softcap)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, cache=None,
            vision_embeds: Optional[torch.Tensor] = None, placements=None,
            dispatch_mode: str = "dense", stats: bool = False):
    """Full-sequence forward (train-forward with cache=None, prefill with a
    cache, which is written in place).  For a VLM, ``vision_embeds``
    (B, P, d) precede the token embeddings, cast to their dtype, and the
    positions, logits and cache cover the P + S positions.  Returns
    (logits (B,P+S,V) f32, cache, aux)."""
    _check_supported(cfg)
    x = embed_apply(params["embed"], tokens)
    if cfg.family == "vlm" and vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    pstack = _placement_stack(cfg, placements, x.device)
    auxs = []
    for l in range(cfg.num_layers):
        c = _layer(cache["layers"], l) if cache is not None else None
        x, _, aux = B.attn_block_full(_layer(params["blocks"], l), cfg, x, positions,
                                      cfg.layer_is_local(l), c, cfg.layer_is_moe(l),
                                      _placement(cfg, pstack, l), dispatch_mode, stats)
        auxs.append(aux)
    return _head(params, cfg, x), cache, _agg_aux(auxs)


def prefill(params, cfg: ModelConfig, tokens, cache, **kw):
    return forward(params, cfg, tokens, cache=cache, **kw)


def decode_step(params, cfg: ModelConfig, token, cache, cache_pos, *,
                placements=None, dispatch_mode: str = "dense", stats: bool = False):
    """One decode step against the slot cache (serving/kvcache.SlotKVCache).

    token: (B, 1) int; cache: {"layers": {"k": (L,B,S,Hkv,D), "v": ...}},
    updated IN PLACE; cache_pos: (B,) next write position per row.  Returns
    (logits (B,V), cache, aux)."""
    _check_supported(cfg)
    x = embed_apply(params["embed"], token)
    pstack = _placement_stack(cfg, placements, x.device)
    auxs = []
    for l in range(cfg.num_layers):
        x, _, aux = B.attn_block_decode(
            _layer(params["blocks"], l), cfg, x, _layer(cache["layers"], l), cache_pos,
            cfg.layer_is_local(l), cfg.layer_is_moe(l), _placement(cfg, pstack, l),
            dispatch_mode, stats)
        auxs.append(aux)
    return _head(params, cfg, x)[:, -1], cache, _agg_aux(auxs)


def decode_step_paged(params, cfg: ModelConfig, token, pages, block_tables,
                      lengths, *, placements=None, dispatch_mode: str = "dense",
                      stats: bool = False, use_kernel: bool = False):
    """One decode step against a paged KV pool (serving/kvcache.PagedKVCache).

    token: (B, 1) int; pages: {"k": (L,P,BS,Hkv,D), "v": ..., optional
    "k_scale"/"v_scale": (L,P)}, updated IN PLACE; block_tables: (B, NB)
    int32; lengths: (B,) tokens resident per row.  Returns (logits (B,V),
    pages, aux)."""
    _check_supported(cfg)
    x = embed_apply(params["embed"], token)
    pstack = _placement_stack(cfg, placements, x.device)
    auxs = []
    for l in range(cfg.num_layers):
        x, _, aux = B.attn_block_decode_paged(
            _layer(params["blocks"], l), cfg, x, _layer(pages, l), block_tables,
            lengths, cfg.layer_is_local(l), cfg.layer_is_moe(l),
            _placement(cfg, pstack, l), dispatch_mode, stats, use_kernel)
        auxs.append(aux)
    return _head(params, cfg, x)[:, -1], pages, _agg_aux(auxs)
