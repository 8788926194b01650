"""zamba2-1.2b — Mamba2 backbone with shared attention blocks
(arXiv:2411.15242; hf).

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.  A single
shared attention+FFN block is applied every 6 Mamba2 layers (Zamba2's
shared-transformer design); its weights are reused at every invocation.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    attention_type="gqa",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,           # 64 ssm heads (d_inner=4096)
    ssm_conv=4,
    ssm_chunk=256,
    shared_attn_every=6,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        shared_attn_every=2, dtype="float32")
