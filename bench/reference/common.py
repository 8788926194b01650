"""The plain layers both references share: RMS norm, rotary embedding,
causal attention in blocks of queries, the SwiGLU FFN and the routed
experts.  Everything computes in float32 with TF32 off; ``Precision``
puts the float8 control in the reference's place (section "control" of
PERF.md): every matrix product's weight and input rounded to float8 e4m3
with one scale per weight matrix and per input row.

Departures of the port from the published models that the references
follow, so that they compute what the configuration file states:
the RMS norm multiplies by ``1 + scale``; rotary embedding rotates the two
halves of a head (not interleaved pairs); the router keeps the top-k of a
softmax and renormalises them; the prompt's tokens are held to the
expert capacity of the prefill the port runs (see ``moe``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bench import spec

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """float32, or with ``fp8`` every product's operands rounded to e4m3."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    @staticmethod
    def _round(x: torch.Tensor, dims) -> torch.Tensor:
        s = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12) / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def weight(self, w: torch.Tensor, matrix_dims=2) -> torch.Tensor:
        """A weight whose trailing ``matrix_dims`` dims are one matrix (a
        (E, d, f) expert stack is E matrices; (d, H, D) is one)."""
        if not self.fp8:
            return w
        return self._round(w, tuple(range(w.ndim - matrix_dims, w.ndim)))

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self._round(x, (-1,)) if self.fp8 else x


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, D); the two halves of each head rotated by the angle of
    frequency ``theta ** (-2i / D)``."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = positions.double()[:, None] * freqs[None]
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     block: int = 512) -> torch.Tensor:
    """q, k: (S, H, Dq); v: (S, H, Dv) -> (S, H, Dv), queries in blocks."""
    s = q.shape[0]
    out = torch.empty(s, q.shape[1], v.shape[2], dtype=q.dtype, device=q.device)
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        b = min(a + block, s)
        sc = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        sc = sc.masked_fill(keys[None, None, :b] > keys[a:b, None][None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, dim=-1), v[:b])
    return out


def ffn(x: torch.Tensor, w_gate, w_up, w_down, p: Precision) -> torch.Tensor:
    xa = p.act(x)
    h = F.silu(xa @ p.weight(w_gate)) * (xa @ p.weight(w_up))
    return p.act(h) @ p.weight(w_down)


def capacity(num_tokens: int, k: int, num_experts: int, factor: float, multiple: int) -> int:
    """Slots an expert keeps in a call of ``num_tokens`` tokens: the
    capacity rule the configuration states."""
    c = int(factor * k * num_tokens / num_experts) + 1
    return max(multiple, -(-c // multiple) * multiple)


def moe(x: torch.Tensor, w: dict, config: dict, p: Precision, capped: int,
        cap: Optional[int], dropped: Optional[dict] = None) -> torch.Tensor:
    """The routed experts on x (S, d).  The first ``capped`` tokens (the
    prompt, which the port prefills in one call) keep a selection only
    while fewer than ``cap`` earlier selections, token-major, went to the
    same expert.  A later token (one a decode step, batched with other
    requests' rows) loses the experts ``dropped[position]`` names: the
    decode step's capacity decisions, which depend on the whole batch, are
    the program's (``check.py``).  Gates: the top-k of the router's
    softmax, renormalised."""
    k = config["num_experts_per_tok"]
    e = w["w_gate"].shape[0]
    probs = torch.softmax(p.act(x) @ p.weight(w["w_router"]), dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.ones_like(ids, dtype=torch.bool)
    if capped and cap is not None:
        flat = ids[:capped].reshape(-1)
        onehot = F.one_hot(flat, e)
        pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1).reshape(capped, k)
        keep[:capped] = pos < cap
    for t, experts in (dropped or {}).items():
        for e_id in experts:
            keep[t] &= ids[t] != e_id
    y = torch.zeros_like(x)
    for ex in torch.unique(ids[keep]).tolist():
        t, j = torch.nonzero((ids == ex) & keep, as_tuple=True)
        h = ffn(x[t], w["w_gate"][ex], w["w_up"][ex], w["w_down"][ex], p)
        y.index_add_(0, t, h * gates[t, j, None])
    return y


def expert_capacity(config: dict, tokens: int) -> int:
    """The configuration's capacity of an expert in a call of ``tokens``."""
    e = spec.layout_module(config).n_experts(config)
    return capacity(tokens, config["num_experts_per_tok"], e,
                    config["moe_capacity_factor"], config["moe_capacity_multiple"])


def prompt_capacity(config: dict, prompt_len: int) -> int:
    """The capacity of the port's prefill of a ``prompt_len``-token prompt,
    padded to its power-of-two bucket."""
    bucket = config["engine"]["prefill_bucket_min"]
    while bucket < prompt_len:
        bucket *= 2
    return expert_capacity(config, bucket)


def head(h: torch.Tensor, g: dict, config: dict, p: Precision) -> torch.Tensor:
    """Final norm and unembedding: (S, d) -> (S, V) f32 logits."""
    x = rms_norm(h, g["final_norm"], config["rms_norm_eps"])
    return p.act(x) @ p.weight(g["unembedding"]).T


def embed(tokens: torch.Tensor, g: dict) -> torch.Tensor:
    return g["embedding"][tokens]


def attn_scale(dim: int) -> float:
    return 1.0 / math.sqrt(dim)
