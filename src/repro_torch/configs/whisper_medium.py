"""whisper-medium — encoder-decoder audio model (arXiv:2212.04356; unverified).

24L (decoder) + 24L encoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
The conv audio frontend is a stub that provides precomputed frame embeddings
(B, frames, d_model); encoder memory is the fixed 1500-frame layout of 30 s
audio (``models.model.prefill(frames=)``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    attention_type="gqa",
    is_encoder_decoder=True,
    encoder_len=1500,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128, encoder_len=8,
        dtype="float32")
