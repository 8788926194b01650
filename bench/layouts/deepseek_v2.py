"""DeepSeek-V2 as the port runs it (``bench/configs/deepseek-v2-236b-d9.json``):
multi-head latent attention in every layer; ``first_k_dense_replace``
leading layers with a dense SwiGLU FFN (``params["prologue"]``, one tree a
layer), then SwiGLU routed experts beside shared ones, stacked as
``params["blocks"]``; an untied unembedding.  Latent attention decodes on
the slot cache only, never on ``flash_decode_paged``."""
from __future__ import annotations

from bench.layouts import common
from bench.weights import NORM_STD, Leaf, dtype

MLA_KEYS = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")
WIDTHS = {"num_key_value_heads": "num_kv_heads", "intermediate_size": "d_ff",
          "n_routed_experts": "num_experts", "n_shared_experts": "num_shared_experts",
          "first_k_dense_replace": "first_k_dense", "q_lora_rank": "q_lora_rank",
          "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
          "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
          **common.MOE_WIDTHS}
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, intermediate_size=128,
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=2,
            moe_intermediate_size=32, vocab_size=128, num_hidden_layers=3)


def first_dense(config: dict) -> int:
    return config.get("first_k_dense_replace", 0)


def n_experts(config: dict) -> int:
    return config["n_routed_experts"]


def is_moe_layer(config: dict, l: int) -> bool:
    return n_experts(config) > 0 and l >= first_dense(config)


def global_leaves(config: dict):
    return common.head_leaves(config)


def layer_leaves(config: dict, l: int):
    d, dt, h = config["hidden_size"], dtype(config), config["num_attention_heads"]
    rq, rkv = config["q_lora_rank"], config["kv_lora_rank"]
    dn, dr, dv = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    out = common.norm_leaves(config) + [
        Leaf("wq_a", (d, rq), d ** -0.5, dt), Leaf("q_norm", (rq,), NORM_STD, dt),
        Leaf("wq_b", (rq, h, dn + dr), rq ** -0.5, dt),
        Leaf("wkv_a", (d, rkv + dr), d ** -0.5, dt), Leaf("kv_norm", (rkv,), NORM_STD, dt),
        Leaf("wkv_b", (rkv, h, dn + dv), rkv ** -0.5, dt),
        Leaf("wo", (h, dv, d), (h * dv) ** -0.5, dt)]
    if is_moe_layer(config, l):
        return out + common.moe_leaves(config, n_experts(config))
    return out + common.ffn_leaves(config)


def program_params(config: dict, draw) -> dict:
    params = common.head_tree(draw.globals_())
    n_pro, n = first_dense(config), config["num_hidden_layers"]
    if n_pro:
        params["prologue"] = [common.block(draw.layer(l), MLA_KEYS, moe=False)
                              for l in range(n_pro)]
    params["blocks"] = common.block(draw.stack(range(n_pro, n)), MLA_KEYS, moe=True)
    return params


def window(config: dict, l: int):
    return None


def layer_flops(config: dict, l: int, span) -> float:
    """Latent attention counts the decompression of the token's own latent;
    cached keys and values are not decompressed again (the absorbed form
    does not need it)."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    rq, rkv = config["q_lora_rank"], config["kv_lora_rank"]
    dn, dr, dv = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    proj = d * rq + rq * h * (dn + dr) + d * (rkv + dr) + rkv * h * (dn + dv) + h * dv * d
    attn = 2 * proj + 2 * h * (dn + dr) * span + 2 * h * dv * span
    if is_moe_layer(config, l):
        return attn + common.moe_flops(config, n_experts(config))
    return attn + common.ffn_flops(config)


def paged_heads(config: dict, l: int):
    return None


def moe_launches(config: dict, l: int):
    return common.swiglu_launches(config)
