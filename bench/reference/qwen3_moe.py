"""Plain float32 forward of Qwen3-MoE as the configuration file states it
(``bench/configs/qwen3-30b-a3b-d4.json``): pre-norm blocks of grouped-query
attention (``num_key_value_heads`` K/V heads, rotary embedding) and routed
experts (top-``num_experts_per_tok`` of a softmax, renormalised, SwiGLU).

Departure from the published model, as the port runs it: no RMS norm on
the queries and keys of each head (Qwen3's ``q_norm`` / ``k_norm``).  See
``common.py`` for the others.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from bench import spec, weights
from bench.reference.common import (Precision, attn_scale, causal_attention, moe, no_tf32,
                                    prompt_capacity, rms_norm, rope)


def block(h: torch.Tensor, w: dict, config: dict, p: Precision, prompt_len: int,
          dropped=None) -> torch.Tensor:
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    s = h.shape[0]
    pos = torch.arange(s, device=h.device)
    xa = p.act(rms_norm(h, w["attn_norm"], eps))
    q = rope(torch.einsum("sd,dhk->shk", xa, p.weight(w["wq"], 3)), pos, theta)
    k = rope(torch.einsum("sd,dhk->shk", xa, p.weight(w["wk"], 3)), pos, theta)
    v = torch.einsum("sd,dhk->shk", xa, p.weight(w["wv"], 3))
    k, v = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    o = causal_attention(q, k, v, attn_scale(q.shape[-1]))
    o = p.act(o.reshape(s, -1)).reshape(o.shape)
    h = h + torch.einsum("shk,hkd->sd", o, p.weight(w["wo"], 3))
    x = rms_norm(h, w["ffn_norm"], eps)
    return h + moe(x, w, config, p, prompt_len, prompt_capacity(config, prompt_len), dropped)


def final_hidden(config: dict, seed: int, seqs: List[Tuple[torch.Tensor, int]], device,
                 p: Precision, drops=None) -> List[torch.Tensor]:
    """The residual stream after the last block of each (tokens, prompt
    length) sequence, the layers' weights drawn one layer at a time;
    ``drops[i]`` the decode steps' dropped experts of sequence i by MoE
    layer and position (``common.moe``)."""
    no_tf32()
    emb_leaf = spec.layout_module(config).global_leaves(config)[0]
    emb = weights.draw(emb_leaf, seed, None, device).float()
    hs = [emb[t] for t, _ in seqs]
    del emb
    for l in range(config["num_hidden_layers"]):
        w = weights.layer(config, seed, l, device, torch.float32)
        hs = [block(h, w, config, p, n, None if drops is None else drops[i].get(l))
              for i, (h, (_, n)) in enumerate(zip(hs, seqs))]
        del w
    return hs
