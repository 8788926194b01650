"""internvl2-26b — InternViT frontend (STUB) + InternLM2-20B LM backbone
(arXiv:2404.16821; hf).

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The vision frontend
is a stub: precomputed patch embeddings (a 256-position prefix) reach the
language model through ``forward``/``prefill``'s ``vision_embeds``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    attention_type="gqa",
    vision_prefix_len=256,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, vision_prefix_len=4, dtype="float32")
