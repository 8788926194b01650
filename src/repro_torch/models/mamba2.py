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
* Under a shard context whose model axis divides the SSD heads (the
  reference's ``_head_constraint``, ``ssm_head_spec``), the mixer runs on
  the rank's heads: ``w_in`` stays whole over "model" (its spec) and only
  its columns of the rank's ``z``/``x``/``dt`` and the shared B/C are
  computed; ``conv_w``/``conv_b`` take the rank's x channels and B/C (both
  whole weights enter through ``copy_to_model``); ``A_log``/``D``/
  ``dt_bias`` and the gated ``norm`` are the rank's blocks, the norm's RMS
  over the whole ``d_inner`` from one psum of the partial sums of squares;
  ``w_out`` is row-parallel, its partial sums reduced.  The cache holds
  every head and channel: the new state and conv window are gathered whole
  over the heads before they are written.  Heads that do not divide run
  the mixer whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import current_ctx, gather_tree, whole_of
from repro_torch.distributed.sharding import ssm_head_spec, tp_weight
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import enter, leave, normal, replicated, rms_norm


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


def _split_proj(params: dict, di: int, n: int, u: torch.Tensor):
    """(z, xBC, dt) of the input projection, ``di`` the inner width the
    weights hold (the rank's, on its heads)."""
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


def _gate_out(params: dict, cfg: ModelConfig, y, z, dtype, ctx=None):
    """The gated RMS norm and ``w_out``.  The mean square is over the whole
    ``d_inner``: on the rank's heads (``ctx``) the partial sums of squares
    are psummed over "model" (their gradient summed back, each rank's block
    taking its share)."""
    y = y.to(dtype)
    g = y * F.silu(z.float()).to(dtype)

    def mean_sq(gf):
        ss = torch.sum(torch.square(gf), dim=-1, keepdim=True)
        if ctx is not None:
            ss = ctx.mesh.psum(ss, ctx.model_axis)
        return ss / cfg.ssm_d_inner

    return rms_norm(g, params["norm"], cfg.norm_eps, mean_sq) @ params["w_out"]


def _local(params: dict, cfg: ModelConfig, ctx) -> dict:
    """The mixer's weights on the rank's heads: ``w_in``, ``conv_w`` and
    ``conv_b`` whole over "model" (through ``copy_to_model``) cut to the
    rank's columns, the per-head and per-channel leaves the rank's blocks,
    ``w_out`` its row block."""
    w = {k: tp_weight(v, ("mamba", k), cfg, ctx) for k, v in params.items()}
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    tp, r = ctx.tp, ctx.mesh.axis_index(ctx.model_axis)
    dev = w["w_in"].device
    dl, hl = di // tp, h // tp
    mine = torch.arange(r * dl, (r + 1) * dl, device=dev)
    bc = torch.arange(2 * n, device=dev)
    conv = torch.cat([mine, di + bc])                     # the rank's x channels, B, C
    w["w_in"] = w["w_in"].index_select(1, torch.cat([
        mine, di + conv, 2 * di + 2 * n + torch.arange(r * hl, (r + 1) * hl, device=dev)]))
    w["conv_w"] = w["conv_w"].index_select(1, conv)
    w["conv_b"] = w["conv_b"].index_select(0, conv)
    return w


def _on_heads(ctx, cfg: ModelConfig) -> bool:
    """Whether the mixer runs on the rank's SSD heads under ``ctx``
    (``ssm_head_spec`` of its (B, L, H, P) operands)."""
    return ctx is not None and ssm_head_spec(ctx, (1, 1, cfg.ssm_heads, 1), 2) is not None


def _layout(params: dict, cfg: ModelConfig):
    """(ctx, weights, d_inner, heads) of the mixer as this rank runs it:
    the rank's heads under a context whose model axis divides them, else
    the whole mixer (ctx None)."""
    ctx = current_ctx()
    if not _on_heads(ctx, cfg):
        return None, gather_tree(params), cfg.ssm_d_inner, cfg.ssm_heads
    return ctx, _local(params, cfg, ctx), cfg.ssm_d_inner // ctx.tp, cfg.ssm_heads // ctx.tp


def _whole_channels(t: torch.Tensor, dl: int, ctx) -> torch.Tensor:
    """(..., dl + 2n) conv inputs of the rank's channels -> every channel."""
    if ctx is None:
        return t
    return torch.cat([whole_of(t[..., :dl].contiguous(), ctx, t.ndim - 1), t[..., dl:]], -1)


def mamba2_full(params: dict, cfg: ModelConfig, u: torch.Tensor,
                cache: Optional[dict] = None):
    """Prefill pass.  u: (B, L, d).  With a cache ({"ssm": (B,H,P,N),
    "conv": (B,K-1,CC)}), the final state and the last K-1 pre-conv xBC
    inputs are written into it IN PLACE.  Returns (out, cache_or_None).
    Under a context ``u`` and ``out`` are in the residual layout.

    For L < K-1 the tail is L rows long, as in the reference, and fills the
    first L rows of the window; the engine never gets there (its smallest
    prompt bucket is 16 tokens)."""
    ctx = current_ctx()
    if ctx is None:
        return _mamba2_full_on(params, cfg, u, cache), cache
    seq = ctx.seq_blocks
    if not _on_heads(ctx, cfg):
        return replicated(lambda h: _mamba2_full_on(params, cfg, h, cache), u, ctx,
                          seq), cache
    return leave(_mamba2_full_on(params, cfg, enter(u, ctx, seq), cache), ctx, seq), cache


def _mamba2_full_on(params: dict, cfg: ModelConfig, u: torch.Tensor, cache) -> torch.Tensor:
    ctx, w, di, h = _layout(params, cfg)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    b, l, _ = u.shape
    z, xbc_raw, dt_raw = _split_proj(w, di, n, u)
    xbc = _conv_full(w, xbc_raw)
    x = xbc[..., :di].reshape(b, l, h, p)
    B_ = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + w["dt_bias"])
    A = -torch.exp(w["A_log"])

    y, final_state = ssd_chunked(x.float(), dt, A, B_.float(), C.float(), cfg.ssm_chunk)
    y = y + x.float() * w["D"][None, None, :, None]
    out = _gate_out(w, cfg, y.reshape(b, l, di), z, u.dtype, ctx)

    if cache is not None:
        tail = _whole_channels(xbc_raw[:, -(cfg.ssm_conv - 1):], di, ctx)
        cache["ssm"].copy_(final_state if ctx is None else whole_of(final_state, ctx, 1))
        cache["conv"][:, :tail.shape[1]].copy_(tail)
    return out


def mamba2_decode(params: dict, cfg: ModelConfig, u: torch.Tensor, cache: dict):
    """One-token recurrent step.  u: (B,1,d); cache {"ssm": (B,H,P,N),
    "conv": (B,K-1,CC)}, advanced IN PLACE.  Returns (out (B,1,d), cache).
    Under a context whose model axis divides the heads, on the rank's
    heads (see the module docstring)."""
    ctx, w, di, h = _layout(params, cfg)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    b = u.shape[0]
    z, xbc_new, dt_raw = _split_proj(w, di, n, u if ctx is None else enter(u, ctx, False))
    conv = cache["conv"]
    if ctx is not None:                                         # the rank's channels
        conv = torch.cat([conv[..., ctx.mesh.axis_index(ctx.model_axis) * di:][..., :di],
                          conv[..., cfg.ssm_d_inner:]], -1)
    # causal conv over [cached K-1 inputs ++ new input]; cat makes a new
    # tensor, so the shifted copy below reads the old window
    window = torch.cat([conv.to(u.dtype), xbc_new], dim=1)     # (B,K,CC)
    conv_out = torch.einsum("bkc,kc->bc", window, w["conv_w"]) + w["conv_b"]
    xbc = F.silu(conv_out.float()).to(u.dtype)                # (B,CC)
    x = xbc[..., :di].reshape(b, h, p).float()
    B_ = xbc[..., di:di + n].float()
    C = xbc[..., di + n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + w["dt_bias"])       # (B,H)
    A = -torch.exp(w["A_log"])

    state = cache["ssm"]
    if ctx is not None:
        state = state.narrow(1, ctx.mesh.axis_index(ctx.model_axis) * h, h)
    decay = torch.exp(dt * A)[..., None, None]                 # (B,H,1,1)
    upd = (dt[..., None] * x)[..., None] * B_[:, None, None, :]
    h_new = state.float() * decay + upd                        # (B,H,P,N)
    y = (h_new @ C[:, None, :, None])[..., 0]                  # (B,H,P)
    y = y + x * w["D"][None, :, None]
    out = _gate_out(w, cfg, y.reshape(b, 1, di), z, u.dtype, ctx)
    if ctx is not None:
        out = leave(out, ctx, False)
        h_new = whole_of(h_new, ctx, 1)
    cache["ssm"].copy_(h_new)
    cache["conv"].copy_(_whole_channels(window[:, 1:], di, ctx))
    return out, cache
