"""The layer parts more than one layout has, as the port's blocks hold them
(``repro_torch/models/blocks.py``): RMS norms, grouped-query attention,
the SwiGLU FFN and SwiGLU routed experts beside shared ones.  Each part
gives its leaves, its place in the block's tree and its operations a
token."""
from __future__ import annotations

from typing import Dict, List

import torch

from bench.weights import NORM_STD, Leaf, dtype

# file keys of the routed experts -> ModelConfig fields
MOE_WIDTHS = {"moe_intermediate_size": "moe_d_ff", "num_experts_per_tok": "moe_top_k",
              "moe_capacity_factor": "capacity_factor"}
GQA_KEYS = ("wq", "wk", "wv", "wo")


def head_leaves(config: dict) -> List[Leaf]:
    """An untied embedding and unembedding and the final norm."""
    d, v, dt = config["hidden_size"], config["vocab_size"], dtype(config)
    return [Leaf("embedding", (v, d), d ** -0.5, dt),
            Leaf("unembedding", (v, d), d ** -0.5, dt),
            Leaf("final_norm", (d,), NORM_STD, dt)]


def head_tree(g: Dict[str, torch.Tensor]) -> dict:
    return {"embed": {"embedding": g["embedding"], "unembedding": g["unembedding"]},
            "final_norm": {"scale": g["final_norm"]}}


def norm_leaves(config: dict) -> List[Leaf]:
    d, dt = config["hidden_size"], dtype(config)
    return [Leaf("attn_norm", (d,), NORM_STD, dt), Leaf("ffn_norm", (d,), NORM_STD, dt)]


def gqa_leaves(config: dict) -> List[Leaf]:
    d, dt = config["hidden_size"], dtype(config)
    h, hkv, hd = config["num_attention_heads"], config["num_key_value_heads"], config["head_dim"]
    return [Leaf("wq", (d, h, hd), d ** -0.5, dt), Leaf("wk", (d, hkv, hd), d ** -0.5, dt),
            Leaf("wv", (d, hkv, hd), d ** -0.5, dt),
            Leaf("wo", (h, hd, d), (h * hd) ** -0.5, dt)]


def gqa_flops(config: dict, span) -> float:
    d, h = config["hidden_size"], config["num_attention_heads"]
    hkv, hd = config["num_key_value_heads"], config["head_dim"]
    proj = d * (h + 2 * hkv) * hd + h * hd * d
    return 2 * proj + 4 * h * hd * span


def ffn_leaves(config: dict) -> List[Leaf]:
    d, f, dt = config["hidden_size"], config["intermediate_size"], dtype(config)
    return [Leaf("ffn_w_gate", (d, f), d ** -0.5, dt), Leaf("ffn_w_up", (d, f), d ** -0.5, dt),
            Leaf("ffn_w_down", (f, d), f ** -0.5, dt)]


def ffn_flops(config: dict) -> float:
    return 6 * config["hidden_size"] * config["intermediate_size"]


def moe_leaves(config: dict, experts: int) -> List[Leaf]:
    """The router (float32, as the port keeps it), ``experts`` routed experts
    and ``n_shared_experts`` shared ones as one SwiGLU of their summed width."""
    d, f, dt = config["hidden_size"], config["moe_intermediate_size"], dtype(config)
    out = [Leaf("w_router", (d, experts), d ** -0.5, torch.float32),
           Leaf("w_gate", (experts, d, f), d ** -0.5, dt),
           Leaf("w_up", (experts, d, f), d ** -0.5, dt),
           Leaf("w_down", (experts, f, d), f ** -0.5, dt)]
    fs = f * config.get("n_shared_experts", 0)
    if fs:
        out += [Leaf("shared_w_gate", (d, fs), d ** -0.5, dt),
                Leaf("shared_w_up", (d, fs), d ** -0.5, dt),
                Leaf("shared_w_down", (fs, d), fs ** -0.5, dt)]
    return out


def moe_flops(config: dict, experts: int) -> float:
    """The router, ``num_experts_per_tok`` routed experts and the shared ones."""
    d, f, k = config["hidden_size"], config["moe_intermediate_size"], config["num_experts_per_tok"]
    return 2 * d * experts + 6 * d * f * (k + config.get("n_shared_experts", 0))


def swiglu_launches(config: dict):
    """``moe_gemm``'s launches a SwiGLU MoE layer: gate and up (d -> f), down
    (f -> d)."""
    return 3, config["hidden_size"], config["moe_intermediate_size"]


def block(w: Dict[str, torch.Tensor], attn_keys, moe: bool) -> dict:
    """A layer's (or a stack's) leaves as the port's block: norms, ``attn``
    of ``attn_keys``, and the routed experts or the dense FFN."""
    p = {"attn_norm": {"scale": w["attn_norm"]}, "attn": {k: w[k] for k in attn_keys},
         "ffn_norm": {"scale": w["ffn_norm"]}}
    if moe:
        p["moe"] = {k: w[k] for k in ("w_router", "w_gate", "w_up", "w_down")}
        if "shared_w_gate" in w:
            p["moe"]["shared"] = {k: w["shared_" + k] for k in ("w_gate", "w_up", "w_down")}
    else:
        p["ffn"] = {k: w["ffn_" + k] for k in ("w_gate", "w_up", "w_down")}
    return p
