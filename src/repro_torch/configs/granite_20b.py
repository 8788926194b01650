"""granite-20b — dense MQA code model (arXiv:2405.04324; hf).

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,            # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    attention_type="gqa",
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=128, dtype="float32")
