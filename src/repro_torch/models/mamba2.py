"""Mamba2's SSD mixer (state-space duality, arXiv:2405.21060), ported from
``repro.models.mamba2``.

Chunked SSD for prefill (O(L·Q) with chunk Q) and the O(1) recurrent step
for decode.  Layout: x (B, L, H, P) heads x head dim; state (B, H, P, N);
one B/C group, as in the reference.

What differs from the reference, with the numerics kept:

* The cache is written IN PLACE (``copy_`` into the given tensors, which
  are per-layer views of the model's stacked cache), where the reference
  returns new arrays.  The state is stored in the cache's dtype and widened
  to f32 on read, so a bf16 cache rounds the state once a step, as the
  reference's does.
* ``ssd_chunked``'s 4- and 5-operand einsums are contracted by hand as
  two-operand products, with dt folded into x first, so that no
  intermediate is larger than (B, nc, H, Q, Q) (``torch.einsum`` contracts
  left to right and would build (B, nc, H, Q, Q, P) tensors).  All in f32.
* The conv tail a prefill leaves is the pre-conv input it already holds
  (the reference recomputes the input projection for it: the same product).
* The reference's head-sharding constraints move no value and are left
  out (the port keeps activations whole on every rank);
  ``distributed/sharding.py`` keeps their choice of layout.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal, rms_norm


def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Seeded weights from the reference's distributions; the deterministic
    leaves (A_log, D, dt_bias, norm, conv_b) are the reference's values."""
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n                      # x, B, C all pass the causal conv
    dt, dev = cfg.adtype, gen.device
    return {
        # in_proj -> [z (di), xBC (di + 2n), dt (h)]
        "w_in": normal(gen, (d, 2 * di + 2 * n + h), d ** -0.5, dt),
        "conv_w": normal(gen, (cfg.ssm_conv, conv_ch), 0.1, dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((di,), dtype=dt, device=dev),
        "w_out": normal(gen, (di, d), di ** -0.5, dt),
    }


def cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    """One layer's decode state: the SSM state and the last K-1 pre-conv
    xBC inputs."""
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return {"ssm": (batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
            "conv": (batch, cfg.ssm_conv - 1, di + 2 * n)}


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device=None) -> dict:
    return {k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in cache_shapes(cfg, batch).items()}


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with out[..., i, j] = sum_{j < s <= i} x_s,
    -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def _split_proj(params: dict, cfg: ModelConfig, u: torch.Tensor):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    proj = u @ params["w_in"]
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _conv_full(params: dict, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, L, C) with kernel (K, C), summed tap
    by tap in xbc's dtype as the reference sums it."""
    k, l = params["conv_w"].shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:l] * params["conv_w"][0]
    for i in range(1, k):
        out = out + pad[:, i:i + l] * params["conv_w"][i]
    return F.silu((out + params["conv_b"]).float()).to(xbc.dtype)


def ssd_chunked(x, dt, A, B_, C, chunk: int, initial_state=None):
    """SSD chunked scan.
    x: (B,L,H,P)  dt: (B,L,H)  A: (H,)  B_, C: (B,L,N)  (single group).
    Returns (y (B,L,H,P), final_state (B,H,P,N)).

    Ragged L is padded up to a chunk multiple with dt=0 positions (decay
    exp(0)=1, update dt*x*B=0), which leaves the carried state exact."""
    b, l, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, l)
    l0 = l
    if l % q:
        pad = q - l % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        l += pad
    nc = l // q

    xdt = (x * dt[..., None]).reshape(b, nc, q, h, p)         # dt folded into x
    bc = B_.reshape(b, nc, q, n)
    cc = C.reshape(b, nc, q, n)

    dA = (dt.reshape(b, nc, q, h) * A).permute(0, 3, 1, 2)   # (B,H,nc,Q)
    dA_cs = torch.cumsum(dA, dim=-1)                          # (B,H,nc,Q)

    # intra-chunk (diagonal blocks): (C B^T ∘ L) @ (x dt), per chunk and head
    L = torch.exp(_segsum(dA)).permute(0, 2, 1, 3, 4)         # (B,nc,H,Q,Q)
    scores = (cc @ bc.transpose(-1, -2))[:, :, None] * L      # (B,nc,H,Q,Q)
    y_diag = scores @ xdt.permute(0, 1, 3, 2, 4)               # (B,nc,H,Q,P)

    # chunk states: sum_l B[l] ⊗ (x dt decay)[l]
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)         # (B,H,nc,Q)
    w = xdt * decay_states.permute(0, 2, 3, 1)[..., None]     # (B,nc,Q,H,P)
    states = (w.reshape(b, nc, q, h * p).transpose(-1, -2) @ bc
              ).reshape(b, nc, h, p, n)

    # inter-chunk recurrence
    chunk_decay = dA_cs[..., -1]                              # (B,H,nc)
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    decay_chunk = torch.exp(_segsum(F.pad(chunk_decay, (1, 0))))   # (B,H,nc+1,nc+1)
    states_all = torch.cat([initial_state[:, None].to(states.dtype), states], dim=1)
    new_states = (decay_chunk @ states_all.permute(0, 2, 1, 3, 4).reshape(b, h, nc + 1, p * n)
                  ).reshape(b, h, nc + 1, p, n).permute(0, 2, 1, 3, 4)   # (B,nc+1,H,P,N)
    prev_states = new_states[:, :-1]                          # state entering each chunk
    final_state = new_states[:, -1]

    # contribution of the carried-in state
    state_decay = torch.exp(dA_cs).permute(0, 2, 3, 1)        # (B,nc,Q,H)
    y_off = (cc @ prev_states.reshape(b, nc, h * p, n).transpose(-1, -2)
             ).reshape(b, nc, q, h, p) * state_decay[..., None]

    y = (y_diag.permute(0, 1, 3, 2, 4) + y_off).reshape(b, l, h, p)
    return y[:, :l0], final_state


def _gate_out(params: dict, cfg: ModelConfig, y, z, dtype):
    y = y.to(dtype)
    y = rms_norm(y * F.silu(z.float()).to(dtype), params["norm"], cfg.norm_eps)
    return y @ params["w_out"]


def mamba2_full(params: dict, cfg: ModelConfig, u: torch.Tensor,
                cache: Optional[dict] = None):
    """Prefill pass.  u: (B, L, d).  With a cache ({"ssm": (B,H,P,N),
    "conv": (B,K-1,CC)}), the final state and the last K-1 pre-conv xBC
    inputs are written into it IN PLACE.  Returns (out, cache_or_None).

    For L < K-1 the tail is L rows long, as in the reference, and fills the
    first L rows of the window; the engine never gets there (its smallest
    prompt bucket is 16 tokens)."""
    di, n, h, p = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    b, l, _ = u.shape
    z, xbc_raw, dt_raw = _split_proj(params, cfg, u)
    xbc = _conv_full(params, xbc_raw)
    x = xbc[..., :di].reshape(b, l, h, p)
    B_ = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    y, final_state = ssd_chunked(x.float(), dt, A, B_.float(), C.float(), cfg.ssm_chunk)
    y = y + x.float() * params["D"][None, None, :, None]
    out = _gate_out(params, cfg, y.reshape(b, l, di), z, u.dtype)

    if cache is not None:
        tail = xbc_raw[:, -(cfg.ssm_conv - 1):]
        cache["ssm"].copy_(final_state)
        cache["conv"][:, :tail.shape[1]].copy_(tail)
    return out, cache


def mamba2_decode(params: dict, cfg: ModelConfig, u: torch.Tensor, cache: dict):
    """One-token recurrent step.  u: (B,1,d); cache {"ssm": (B,H,P,N),
    "conv": (B,K-1,CC)}, advanced IN PLACE.  Returns (out (B,1,d), cache)."""
    di, n, h, p = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    b = u.shape[0]
    z, xbc_new, dt_raw = _split_proj(params, cfg, u)          # (B,1,·)
    # causal conv over [cached K-1 inputs ++ new input]; cat makes a new
    # tensor, so the shifted copy below reads the old window
    window = torch.cat([cache["conv"].to(u.dtype), xbc_new], dim=1)   # (B,K,CC)
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"]) + params["conv_b"]
    xbc = F.silu(conv_out.float()).to(u.dtype)                # (B,CC)
    x = xbc[..., :di].reshape(b, h, p).float()
    B_ = xbc[..., di:di + n].float()
    C = xbc[..., di + n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])  # (B,H)
    A = -torch.exp(params["A_log"])

    decay = torch.exp(dt * A)[..., None, None]                 # (B,H,1,1)
    upd = (dt[..., None] * x)[..., None] * B_[:, None, None, :]
    h_new = cache["ssm"].float() * decay + upd                 # (B,H,P,N)
    y = (h_new @ C[:, None, :, None])[..., 0]                  # (B,H,P)
    y = y + x * params["D"][None, :, None]
    out = _gate_out(params, cfg, y.reshape(b, 1, di), z, u.dtype)
    cache["ssm"].copy_(h_new)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
