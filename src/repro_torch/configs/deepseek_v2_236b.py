"""deepseek-v2-236b — MoE with Multi-head Latent Attention (arXiv:2405.04434; hf).

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400, 160 routed experts top-6
+ 2 shared, MLA kv_lora=512.  First layer uses a dense FFN (12288), per the
HF reference config (first_k_dense_replace=1).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: logical heads; the cache is the compressed latent
    head_dim=128,
    d_ff=12288,                # dense FFN width for the first_k_dense layers
    vocab_size=102400,
    attention_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    first_k_dense=1,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        num_experts=8, num_shared_experts=2, moe_top_k=2, moe_d_ff=32,
        first_k_dense=1, dtype="float32")
