"""Model configuration, ported from ``repro.models.config``.

The same frozen dataclass and field names as the reference, so one config
file reads the same in both packages; ``adtype`` returns a torch dtype.  The
parameter counts the simulator's cost model reads are the reference's.  The
shape cells are the reference's table, and ``cell_applicable`` says which
of them apply to an arch (the dry run's rule).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # --- identity -----------------------------------------------------------
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio

    # --- core transformer dims ----------------------------------------------
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // num_heads
    d_ff: int = 512            # dense FFN width (for MoE archs: width of any dense layers)
    vocab_size: int = 1000
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # --- attention variants ---------------------------------------------------
    attention_type: str = "gqa"        # gqa | mla | none
    qkv_bias: bool = False             # qwen2
    attn_logit_softcap: float = 0.0    # gemma2 (0 = off)
    final_logit_softcap: float = 0.0   # gemma2 (0 = off)
    sliding_window: int = 0            # window size for local layers (0 = off)
    local_global_period: int = 0       # gemma2: layer i is local iff i % period != period-1

    # --- MLA (deepseek-v2) ----------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE -------------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                  # per-expert FFN width
    first_k_dense: int = 0             # leading layers that use a dense FFN instead
    moe_every: int = 1                 # layer i is MoE iff i >= first_k_dense and i % moe_every == 0
    capacity_factor: float = 1.25      # dispatch capacity
    router_aux_coef: float = 0.01      # load-balance aux loss
    router_z_coef: float = 1e-3

    # --- SSM (mamba2 / SSD) -----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2) ---------------------------------------------------------
    shared_attn_every: int = 0

    # --- encoder-decoder (whisper) -------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_len: int = 1500

    # --- VLM (internvl) -------------------------------------------------------------
    vision_prefix_len: int = 0

    # --- numerics ----------------------------------------------------------------------
    dtype: str = "bfloat16"            # activations/weights dtype
    remat: bool = False
    remat_policy: str = "none"

    # -----------------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # ---- derived helpers ---------------------------------------------------------------
    @property
    def adtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and self.attention_type == "none"

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.shared_attn_every > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def layer_is_moe(self, i: int) -> bool:
        if not self.is_moe:
            return False
        return i >= self.first_k_dense and (i - self.first_k_dense) % self.moe_every == 0

    def num_moe_layers(self) -> int:
        """MoE layers of the stack — the leading dim of the placement stack."""
        return sum(self.layer_is_moe(i) for i in range(self.num_layers))

    def layer_is_local(self, i: int) -> bool:
        """gemma2-style alternation: with period p, layers i % p != p-1 are local."""
        if self.local_global_period <= 0 or self.sliding_window <= 0:
            return False
        return i % self.local_global_period != self.local_global_period - 1

    @property
    def q_head_dim(self) -> int:
        """Per-head query dim (MLA splits into nope+rope)."""
        if self.attention_type == "mla":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    @property
    def o_head_dim(self) -> int:
        if self.attention_type == "mla":
            return self.v_head_dim
        return self.head_dim

    def kv_bytes_per_token(self) -> int:
        """Per-token KV-cache bytes — the 'KV usage' signal of Alg. 1."""
        itemsize = self.adtype.itemsize
        n_attn = self.num_attention_layers()
        if self.attention_type == "mla":
            per_layer = self.kv_lora_rank + self.qk_rope_head_dim
        else:
            per_layer = 2 * self.num_kv_heads * self.head_dim
        return n_attn * per_layer * itemsize

    def num_attention_layers(self) -> int:
        if self.attention_type == "none":
            return 0
        if self.is_hybrid:
            return self.num_layers // max(self.shared_attn_every, 1)
        return self.num_layers

    def active_params(self) -> int:
        """Approximate activated parameter count (per token)."""
        return _param_count(self, active_only=True)

    def total_params(self) -> int:
        return _param_count(self, active_only=False)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0
    # attention
    if cfg.attention_type == "mla":
        q_in = cfg.q_lora_rank if cfg.q_lora_rank else d
        per_layer += (d * cfg.q_lora_rank if cfg.q_lora_rank else 0)
        per_layer += q_in * cfg.num_heads * cfg.q_head_dim
        per_layer += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        per_layer += cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
        per_layer += cfg.num_heads * cfg.v_head_dim * d
    elif cfg.attention_type == "gqa":
        per_layer += d * cfg.num_heads * cfg.head_dim          # Q
        per_layer += 2 * d * cfg.num_kv_heads * cfg.head_dim   # K,V
        per_layer += cfg.num_heads * cfg.head_dim * d          # O
    # ffn / experts
    ffn_dense = 3 * d * cfg.d_ff  # gated (swiglu)
    if cfg.is_moe:
        expert = 3 * d * cfg.moe_d_ff
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
        n_dense = cfg.num_layers - n_moe
        shared = cfg.num_shared_experts * expert
        if active_only:
            moe_part = n_moe * (cfg.moe_top_k * expert + shared)
        else:
            moe_part = n_moe * (cfg.num_experts * expert + shared)
        total_layers = moe_part + n_dense * ffn_dense + cfg.num_layers * per_layer
    elif cfg.is_ssm or cfg.is_hybrid:
        di, nh, ns = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
        ssm = d * (2 * di + 2 * ns + nh) + di * d + cfg.ssm_conv * (di + 2 * ns)
        total_layers = cfg.num_layers * ssm
        if cfg.is_hybrid:
            shared_blk = per_layer + ffn_dense
            total_layers += shared_blk  # weights shared across invocations
    else:
        total_layers = cfg.num_layers * (per_layer + ffn_dense)
    if cfg.is_encoder_decoder:
        # encoder self-attn + ffn, decoder cross-attn
        enc = cfg.num_encoder_layers * (per_layer + ffn_dense)
        cross = cfg.num_layers * per_layer
        total_layers += enc + cross
    return int(emb + total_layers)


# Input shape cells assigned to every architecture -------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


# Archs for which long_500k is runnable (sub-quadratic sequence handling).
LONG_CONTEXT_ARCHS = ("mamba2-370m", "zamba2-1.2b")


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Whether a shape cell applies to an arch, with the reason if not."""
    if cell.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
        return False, "full-attention KV at 524288 is quadratic-family; skipped per spec"
    return True, ""
