"""gemma2-2b — dense, alternating local/global attention + logit softcaps
(arXiv:2408.00118; hf).

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.  head_dim=256 (gemma2
uses a fixed per-head width, H*head_dim != d_model).  Odd layers are global,
even layers local with a 4096 sliding window; attn softcap 50, final softcap 30.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attention_type="gqa",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, sliding_window=8, dtype="float32")
