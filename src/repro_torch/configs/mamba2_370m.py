"""mamba2-370m — pure SSM, SSD (state-space duality) (arXiv:2405.21060; unverified).

48L d_model=1024 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2048 (expand 2), 32 SSD heads of head_dim 64.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention_type="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, vocab_size=128, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, dtype="float32")
