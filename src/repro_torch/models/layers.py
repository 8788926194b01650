"""Shared primitive layers: RMSNorm, RoPE, gated FFN, embedding.

Ported from ``repro.models.layers`` with its conventions kept: RMSNorm
scales by ``1 + scale`` (zero init), RoPE rotates the two halves of each
head, SwiGLU takes SiLU in f32, and the unembedding returns f32 logits with
the optional softcap.  Parameters are plain dicts of tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


# --- RoPE -------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim // 2,) float32


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(head_dim, theta)).to(x.device)
    angles = positions[..., :, None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- gated FFN (SwiGLU) -------------------------------------------------------

def ffn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = torch.einsum("...d,df->...f", x, params["w_gate"])
    up = torch.einsum("...d,df->...f", x, params["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    return torch.einsum("...f,fd->...d", act, params["w_down"])


# tensors of more elements are drawn one slice of the leading axis at a
# time; every tensor of the homogeneous families (the largest, qwen2-72b's
# embedding, has 1.25e9 elements) is drawn whole, as before
CHUNKED_DRAW_ELEMENTS = 1 << 31


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """Seeded N(0, std^2) draw on the generator's device, cast to ``dtype``.
    Above ``CHUNKED_DRAW_ELEMENTS`` the tensor is allocated once and filled
    a slice of the leading axis at a time, so the f32 transients are one
    slice, not two copies of the whole tensor (one (128, 5120, 8192) expert
    tensor of llama4 would need ~43 GB of them)."""
    shape = tuple(shape)
    if gen.device.type == "meta":                  # shapes only: nothing to draw
        return torch.empty(shape, dtype=dtype, device="meta")
    if math.prod(shape) <= CHUNKED_DRAW_ELEMENTS:
        return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=gen, device=gen.device) * std
    return out


def init_ffn(gen: torch.Generator, d: int, f: int, dtype) -> dict:
    s_in, s_out = d ** -0.5, f ** -0.5
    return {
        "w_gate": normal(gen, (d, f), s_in, dtype),
        "w_up": normal(gen, (d, f), s_in, dtype),
        "w_down": normal(gen, (f, d), s_out, dtype),
    }


# --- embeddings ----------------------------------------------------------------

def embed_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def unembed_apply(params: dict, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = torch.einsum("...d,vd->...v", x, params["unembedding"]).float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def init_embed(gen: torch.Generator, vocab: int, d: int, dtype, tie: bool) -> dict:
    emb = normal(gen, (vocab, d), d ** -0.5, dtype)
    if tie:
        return {"embedding": emb}
    return {"embedding": emb,
            "unembedding": normal(gen, (vocab, d), d ** -0.5, dtype)}


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return torch.tanh(x / cap) * cap
