"""Shared primitive layers: RMSNorm, RoPE, gated FFN, embedding.

Ported from ``repro.models.layers`` with its conventions kept: RMSNorm
scales by ``1 + scale`` (zero init), RoPE rotates the two halves of each
head, SwiGLU takes SiLU in f32, and the unembedding returns f32 logits with
the optional softcap.  Parameters are plain dicts of tensors.

Under a shard context the layers compute on their "model" blocks
(``distributed/context.py``'s model axis): ``enter`` takes a layer's input
from the residual stream's layout into its section (the whole sequence,
the gradient summed over "model"), ``leave`` reduces the partial output
back into that layout, ``replicated`` runs a layer every rank repeats
whole, ``residual_norm`` is the pre-norm on the residual stream, and
``ffn_layer`` is the dense FFN column-parallel in ``w_gate``/``w_up`` and
row-parallel in ``w_down``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.context import (block_of, copy_to_model, current_ctx,
                                             gather, gather_seq, gather_tree,
                                             reduce_from_model, scatter_seq, whole_of)
from repro_torch.distributed.sharding import leaf_spec, model_dim, tp_weight


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             mean_sq: Optional[Callable] = None) -> torch.Tensor:
    """RMS norm over the last dim; ``mean_sq`` (of the f32 ``x``) takes the
    place of its mean square, for an ``x`` whose last dim is split."""
    dt = x.dtype
    x = x.float()
    var = (torch.mean(torch.square(x), dim=-1, keepdim=True) if mean_sq is None
           else mean_sq(x))
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


# --- the model axis --------------------------------------------------------------

def enter(h: torch.Tensor, ctx, seq: bool) -> torch.Tensor:
    """A layer's input, in the residual stream's layout (the rank's block
    of the sequence on dim 1 when ``seq``), made whole for the layer's
    model-axis section; its partial gradient is summed over "model"."""
    return gather_seq(h, ctx, 1) if seq else copy_to_model(h, ctx)


def leave(y: torch.Tensor, ctx, seq: bool) -> torch.Tensor:
    """The ranks' partial outputs of a section summed over "model", into
    the residual stream's layout."""
    return scatter_seq(y, ctx, 1) if seq else reduce_from_model(y, ctx)


def replicated(fn, h: torch.Tensor, ctx, seq: bool):
    """``fn`` on the whole of ``h``, every rank repeating it (a layer whose
    weights stay whole over "model"); its output in ``h``'s layout."""
    if not seq:
        return fn(h)
    return block_of(fn(whole_of(h, ctx, 1)), ctx, 1)


def residual_norm(x: torch.Tensor, scale, eps: float) -> torch.Tensor:
    """The pre-norm of a block on the residual stream; on the rank's block
    of the sequence the scale's gradient is summed over "model"."""
    ctx = current_ctx()
    scale = gather(scale)
    if ctx is not None and ctx.seq_blocks:
        scale = copy_to_model(scale, ctx)
    return rms_norm(x, scale, eps)


def ffn_layer(params: dict, cfg, x: torch.Tensor, names=("ffn",),
              seq: bool = None) -> torch.Tensor:
    """The gated FFN on ``x`` in the residual layout (``seq``: the rank's
    sequence block, by default the context's).  Under a context whose
    model axis the spec cuts ``w_gate`` over, gate/up run on their column
    block and ``w_down`` on its row block, then the partial sums are
    reduced; else every rank runs it whole."""
    ctx = current_ctx()
    if ctx is None:
        return ffn_apply(gather_tree(params), x)
    seq = ctx.seq_blocks if seq is None else seq
    names = tuple(names)
    if model_dim(leaf_spec(params["w_gate"], names + ("w_gate",), cfg, ctx), ctx) is None:
        return replicated(lambda h: ffn_apply(gather_tree(params), h), x, ctx, seq)
    w = {k: tp_weight(v, names + (k,), cfg, ctx) for k, v in params.items()}
    return leave(ffn_apply(w, enter(x, ctx, seq)), ctx, seq)


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
