"""llama4-maverick-400b-a17b — interleaved MoE, top-1 routing
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048, 128 routed
experts top-1 + 1 shared.  MoE on every other layer (interleave step 2, as in
the HF reference) reconciles the 400B-total / 17B-active parameter budget.
Early fusion is a modality-frontend property; the text backbone built here is
what the shape cells exercise (spec: frontends are stubs).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,                # dense FFN width on non-MoE layers
    vocab_size=202048,
    attention_type="gqa",
    num_experts=128,
    num_shared_experts=1,
    moe_top_k=1,
    moe_d_ff=8192,
    first_k_dense=0,
    moe_every=2,               # interleaved MoE: layers 0, 2, 4, ...
    rope_theta=500_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, num_experts=8, num_shared_experts=1,
        moe_top_k=1, moe_d_ff=32, moe_every=2, dtype="float32")
