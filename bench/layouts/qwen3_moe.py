"""Qwen3-MoE as the port runs it (``bench/configs/qwen3-30b-a3b-d36.json``):
every layer grouped-query attention over all positions and SwiGLU routed
experts, the layers stacked whole as ``params["blocks"]``; an untied
unembedding."""
from __future__ import annotations

from bench.layouts import common

WIDTHS = {"num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "num_experts": "num_experts", **common.MOE_WIDTHS}
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            intermediate_size=128, num_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=32, vocab_size=128, num_hidden_layers=2)


def global_leaves(config: dict):
    return common.head_leaves(config)


def layer_leaves(config: dict, l: int):
    return (common.norm_leaves(config) + common.gqa_leaves(config)
            + common.moe_leaves(config, n_experts(config)))


def program_params(config: dict, draw) -> dict:
    params = common.head_tree(draw.globals_())
    params["blocks"] = common.block(draw.stack(range(config["num_hidden_layers"])),
                                    common.GQA_KEYS, moe=True)
    return params


def is_moe_layer(config: dict, l: int) -> bool:
    return True


def n_experts(config: dict) -> int:
    return config["num_experts"]


def window(config: dict, l: int):
    return None


def layer_flops(config: dict, l: int, span) -> float:
    return common.gqa_flops(config, span) + common.moe_flops(config, n_experts(config))


def paged_heads(config: dict, l: int):
    return config["num_attention_heads"], config["num_key_value_heads"], config["head_dim"]


def moe_launches(config: dict, l: int):
    return common.swiglu_launches(config)
