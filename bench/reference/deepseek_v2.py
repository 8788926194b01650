"""Plain float32 forward of DeepSeek-V2 as the configuration file states it
(``bench/configs/deepseek-v2-236b-d4.json``): multi-head latent attention
(queries through a ``q_lora_rank`` latent, keys and values decompressed
from a ``kv_lora_rank`` latent plus one shared ``qk_rope_head_dim`` rotary
key), ``first_k_dense_replace`` leading dense layers, then routed experts
(top-``num_experts_per_tok`` of a softmax) beside ``n_shared_experts``
shared ones, one SwiGLU of their summed width.

The configuration file records the port's routing and positions where they
differ from the published model: one group (``n_group`` 1), greedy top-k,
renormalised gates, no routed scaling and no YaRN rotary scaling.  See
``common.py`` for the others.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from bench import spec, weights
from bench.reference.common import (Precision, attn_scale, causal_attention, ffn, moe,
                                    no_tf32, prompt_capacity, rms_norm, rope)


def attention(h: torch.Tensor, w: dict, config: dict, p: Precision) -> torch.Tensor:
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    rkv = config["kv_lora_rank"]
    dn, dr = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    s, heads = h.shape[0], config["num_attention_heads"]
    pos = torch.arange(s, device=h.device)
    xa = p.act(rms_norm(h, w["attn_norm"], eps))
    cq = rms_norm(xa @ p.weight(w["wq_a"]), w["q_norm"], eps)
    q = torch.einsum("sr,rhk->shk", p.act(cq), p.weight(w["wq_b"], 3))
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, theta)], dim=-1)
    kv = xa @ p.weight(w["wkv_a"])
    ckv = rms_norm(kv[:, :rkv], w["kv_norm"], eps)
    krope = rope(kv[:, None, rkv:], pos, theta)
    kvb = torch.einsum("sr,rhk->shk", p.act(ckv), p.weight(w["wkv_b"], 3))
    k = torch.cat([kvb[..., :dn], krope.expand(s, heads, dr)], dim=-1)
    o = causal_attention(q, k, kvb[..., dn:], attn_scale(dn + dr))
    o = p.act(o.reshape(s, -1)).reshape(o.shape)
    return torch.einsum("shk,hkd->sd", o, p.weight(w["wo"], 3))


def block(h: torch.Tensor, w: dict, config: dict, p: Precision, prompt_len: int,
          is_moe: bool, dropped=None) -> torch.Tensor:
    h = h + attention(h, w, config, p)
    x = rms_norm(h, w["ffn_norm"], config["rms_norm_eps"])
    if not is_moe:
        return h + ffn(x, w["ffn_w_gate"], w["ffn_w_up"], w["ffn_w_down"], p)
    shared = ffn(x, w["shared_w_gate"], w["shared_w_up"], w["shared_w_down"], p)
    cap = prompt_capacity(config, prompt_len)
    return h + moe(x, w, config, p, prompt_len, cap, dropped) + shared


def final_hidden(config: dict, seed: int, seqs: List[Tuple[torch.Tensor, int]], device,
                 p: Precision, drops=None) -> List[torch.Tensor]:
    """As ``qwen3_moe.final_hidden`` (``drops`` by MoE layer: the dense
    prologue has none)."""
    no_tf32()
    lay = spec.layout_module(config)
    emb = weights.draw(lay.global_leaves(config)[0], seed, None, device).float()
    hs = [emb[t] for t, _ in seqs]
    del emb
    for l in range(config["num_hidden_layers"]):
        w = weights.layer(config, seed, l, device, torch.float32)
        moe_layer = lay.is_moe_layer(config, l)
        m = l - lay.first_dense(config)
        hs = [block(h, w, config, p, n, moe_layer,
                    None if drops is None or not moe_layer else drops[i].get(m))
              for i, (h, (_, n)) in enumerate(zip(hs, seqs))]
        del w
    return hs
