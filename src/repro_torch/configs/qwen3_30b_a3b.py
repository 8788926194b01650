"""qwen3-30b-a3b — the paper's evaluation model (arXiv:2505.09388; hf).

48L d_model=2048 32H (GQA kv=4, head_dim 128) vocab=151936,
128 routed experts top-8, expert d_ff=768.  The same values as
``repro.configs.qwen3_30b_a3b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=6144,                 # unused (all layers MoE); kept for completeness
    vocab_size=151936,
    attention_type="gqa",
    num_experts=128,
    num_shared_experts=0,
    moe_top_k=8,
    moe_d_ff=768,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, num_experts=8, moe_top_k=2, moe_d_ff=32,
        dtype="float32")
