"""The model's needed operations (2 a multiply-add) for one token, from the
configuration file's widths: the projections, attention over the positions
the token attends to, ``num_experts_per_tok`` routed experts (the router
and the shared experts too) or the dense FFN, and the unembedding only
where a token is sampled.  Padding, free decode rows and experts computed
for capacity slots are not counted.  Latent attention counts the
decompression of the token's own latent (cached keys and values are not
decompressed again: that is work the absorbed form does not need)."""
from __future__ import annotations

from bench import weights


def _attn(config: dict, ctx: int) -> float:
    d, h = config["hidden_size"], config["num_attention_heads"]
    if config["architecture"] == "deepseek_v2":
        rq, rkv = config["q_lora_rank"], config["kv_lora_rank"]
        dn, dr, dv = (config["qk_nope_head_dim"], config["qk_rope_head_dim"],
                      config["v_head_dim"])
        proj = d * rq + rq * h * (dn + dr) + d * (rkv + dr) + rkv * h * (dn + dv) + h * dv * d
        return 2 * proj + 2 * h * (dn + dr) * ctx + 2 * h * dv * ctx
    hkv, hd = config["num_key_value_heads"], config["head_dim"]
    proj = d * (h + 2 * hkv) * hd + h * hd * d
    return 2 * proj + 4 * h * hd * ctx


def _ffn(config: dict, l: int) -> float:
    d = config["hidden_size"]
    if not weights.is_moe_layer(config, l):
        return 6 * d * config["intermediate_size"]
    f, k = config["moe_intermediate_size"], config["num_experts_per_tok"]
    shared = config.get("n_shared_experts", 0)
    return 2 * d * weights.n_experts(config) + 6 * d * f * (k + shared)


def token(config: dict, ctx: int, sampled: bool) -> float:
    """One token that attends to ``ctx`` positions (itself included)."""
    n = config["num_hidden_layers"]
    f = sum(_attn(config, ctx) + _ffn(config, l) for l in range(n))
    return f + (2 * config["hidden_size"] * config["vocab_size"] if sampled else 0)


def prefill(config: dict, prompt_len: int) -> float:
    """A prompt of ``prompt_len`` tokens, causal, sampling its last."""
    n = config["num_hidden_layers"]
    per_tok = sum(_attn(config, 0) + _ffn(config, l) for l in range(n))
    ctx_sum = prompt_len * (prompt_len + 1) / 2
    return (prompt_len * per_tok + (_attn(config, ctx_sum) - _attn(config, 0)) * n
            + 2 * config["hidden_size"] * config["vocab_size"])


def decode(config: dict, lengths) -> float:
    """One decode step of the active rows, each attending to ``length``
    positions."""
    return sum(token(config, int(c), True) for c in lengths)
