"""GQA, cross and MLA attention, ported from ``repro.models.attention``.

* Full-sequence call (prefill): q over the whole sequence, causal mask;
  plain PyTorch (einsum + softmax, chunked over queries for long inputs),
  as the reference computes it outside any kernel.
* Slot decode call: one new token per row written into a contiguous
  per-slot cache (``serving.kvcache.SlotKVCache``), then plain attention
  over the cache with a ``j <= cache_pos`` mask, as the reference computes it.
* Paged decode call: one new token per row appended into a paged KV pool
  (``serving.kvcache.PagedKVCache``), then paged flash-decode.

* Cross attention (whisper's decoder): queries over the encoder memory,
  no mask, no rope.
* MLA (deepseek-v2): a compressed cache {"ckv": (B,S,R), "krope": (B,S,Dr)};
  prefill decompresses and attends, decode either decompresses every
  cached step (``absorb=False``) or scores in latent space
  (``absorb=True``, what the serving backend runs).  Plain PyTorch, as the
  reference computes it.

Conventions kept from the reference: the finite ``NEG_INF`` mask, the
``CHUNK_THRESHOLD`` / ``Q_CHUNK`` switch to chunked prefill, the kernel
called with ``lengths + 1`` after the append, and the monotone int8 page
scale.

Under a shard context (``distributed/context.py``) whose model axis
divides the cache length, a slot decode (GQA and MLA) takes the reference's
sequence-sharded flash-decode: each rank of the model axis attends over
its chunk of the cache and the partial softmax statistics are combined
with ``pmax`` / ``psum``.  The region writes the new row into this rank's
chunk only (the reference's guarded write).  A stored cache (the store of
``distributed/sharding.py``) holds just that chunk, so nothing more is
written; a whole cache is written on every rank as well, which is what
gathering the chunks back would give.  Any other decode opens a stored
cache whole and writes each rank's block back.  Under batch blocks
(``ShardCtx.batch_blocks``) ``x`` and ``cache_pos`` are this rank's rows,
a stored cache's region block (or opened view) holds the same rows, and a
whole cache, which holds every row, is refused.

The model axis (the reference's ``_head_constraint``, ``head_spec`` of
``distributed/sharding.py``): under a context, a layer takes its input in
the residual stream's layout and returns its output in it.  Where the
query heads divide the model axis, q/k/v are computed on the rank's head
block (k/v kept whole where the kv heads do not divide, each rank taking
the kv heads of its query heads: the Megatron GQA recipe), attention runs
on those heads, and ``wo`` is row-parallel, its partial sums reduced
(``layers.enter`` / ``leave``).  Where they do not divide and the residual
is the rank's block of the sequence, attention is context-parallel: q on
that block, k/v over the whole sequence, materialized scores as the
reference's ``_sdpa_auto`` takes them, and ``wo`` whole.  A decode makes
q, k_new and v_new whole over the heads before the sequence-sharded region
(its in-specs replicate them) and applies ``wo`` to the rank's heads
after.  MLA follows the same rules over ``wq_b``/``wkv_b``'s heads; a layer
whose heads do not divide otherwise runs whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.distributed.context import (P, Stored, batch_axis, block_of, check_cache,
                                             copy_to_model, current_ctx, divides, gather,
                                             gather_seq, gather_tree, opened,
                                             reduce_from_model, shard_map, whole_of)
from repro_torch.distributed.sharding import head_spec, tp_weight
from repro_torch.kernels.ops import paged_decode_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, enter, leave, normal, replicated,
                                       rms_norm, softcap)

NEG_INF = -2.0 ** 30  # large-but-finite: keeps masked softmax NaN-free in bf16

# materialize full (Sq, Skv) score tensors only below this element count;
# larger sequences take the chunked-query path
CHUNK_THRESHOLD = 1 << 22
Q_CHUNK = 512


def init_gqa(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d ** -0.5
    dt = cfg.adtype
    p = {
        "wq": normal(gen, (d, hq, hd), s, dt),
        "wk": normal(gen, (d, hkv, hd), s, dt),
        "wv": normal(gen, (d, hkv, hd), s, dt),
        "wo": normal(gen, (hq, hd, d), (hq * hd) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        for name, h in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((h, hd), dtype=dt, device=gen.device)
    return p


def _proj(params: dict, cfg: ModelConfig, x: torch.Tensor, name: str) -> torch.Tensor:
    """One of the q/k/v projections ("q", "k", "v"), with its bias."""
    out = torch.einsum("bsd,dhk->bshk", x, params["w" + name])
    return out + params["b" + name] if cfg.qkv_bias else out


def _qkv(params: dict, cfg: ModelConfig, x: torch.Tensor):
    return tuple(_proj(params, cfg, x, n) for n in "qkv")


def _expand_kv(k: torch.Tensor, hq: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,Hq,D) by repeating each KV head over its Q group."""
    hkv = k.shape[2]
    if hkv != hq:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
    return k


def _mode(ctx, heads: int, x: torch.Tensor) -> Optional[str]:
    """How a layer with ``heads`` query heads runs on ``x`` (in the
    residual layout) under ``ctx``, from ``head_spec``'s layout of its
    (B, S, H, D) activations: None (no context), "heads" (on the rank's
    heads), "seq" (context-parallel on the rank's block of the sequence,
    where the residual stream is that block) or "whole" (every rank repeats
    it)."""
    if ctx is None:
        return None
    s = x.shape[1] * (ctx.tp if ctx.seq_blocks else 1)
    spec = head_spec(ctx, (x.shape[0], s, heads, 1), allow_seq=ctx.seq_blocks)
    if spec is None:
        return "whole"
    return "heads" if spec[2] is not None else "seq"


def _head_weights(params: dict, cfg: ModelConfig, ctx) -> dict:
    """The projections on the rank's head blocks (``sharding.tp_weight``);
    a kv bias kept whole is cut to the kv heads of a kv block."""
    w = {k: tp_weight(v, ("attn", k), cfg, ctx) for k, v in params.items()}
    if "bk" in w and w["wk"].shape[1] != w["bk"].shape[0]:
        hkv, r = w["wk"].shape[1], ctx.mesh.axis_index(ctx.model_axis)
        w["bk"] = w["bk"].narrow(0, r * hkv, hkv)
        w["bv"] = w["bv"].narrow(0, r * hkv, hkv)
    return w


def _kv_for(cfg: ModelConfig, k: torch.Tensor, hq: int) -> torch.Tensor:
    """k or v (B,S,Hk,D) for ``hq`` query heads: the plain repeat when they
    are the whole heads or matching blocks, else (kv whole, q the rank's
    block of heads) the kv head of each of the rank's query heads."""
    if k.shape[2] * cfg.num_heads == cfg.num_kv_heads * hq:
        return _expand_kv(k, hq)
    ctx = current_ctx()
    group = cfg.num_heads // cfg.num_kv_heads
    first = ctx.mesh.axis_index(ctx.model_axis) * hq
    idx = (first + torch.arange(hq, device=k.device)) // group
    return k.index_select(2, idx)


def _sdpa(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """q: (B,Sq,Hq,D)  k,v: (B,Skv,Hkv,D)  mask: broadcastable to (B,Sq,Skv)."""
    d = q.shape[-1]
    hq = q.shape[2]
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (d ** -0.5)
    if cfg.attn_logit_softcap > 0:
        scores = softcap(scores, cfg.attn_logit_softcap)
    scores = torch.where(mask[:, None, :, :], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _causal_mask(sq: int, skv: int, window: int, device) -> torch.Tensor:
    i = torch.arange(sq, device=device)[:, None] + (skv - sq)  # absolute query positions
    j = torch.arange(skv, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (j > (i - window))
    return m[None]  # (1, Sq, Skv)


def _sdpa_chunked(cfg: ModelConfig, q, k, v, window: int, causal: bool = True,
                  q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Memory-bounded full-sequence attention: loop over query chunks so
    only a (q_chunk, Skv) score block is live at a time."""
    b, sq, hq, dh = q.shape
    skv = k.shape[1]
    qc = min(q_chunk, sq)
    if sq % qc != 0:
        qc = sq  # ragged: fall back to one chunk
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    scale = dh ** -0.5
    j = torch.arange(skv, device=q.device)[None, :]
    outs = []
    for ci in range(sq // qc):
        qb = q[:, ci * qc:(ci + 1) * qc]
        scores = torch.einsum("bqhd,bkhd->bhqk", qb, k).float() * scale
        if cfg.attn_logit_softcap > 0:
            scores = softcap(scores, cfg.attn_logit_softcap)
        i = (ci * qc + torch.arange(qc, device=q.device))[:, None] + (skv - sq)
        m = (j <= i) if causal else torch.ones((qc, skv), dtype=torch.bool,
                                               device=q.device)
        if window > 0:
            m = m & (j > (i - window))
        bias = torch.where(m, 0.0, NEG_INF).to(torch.float32)
        scores = scores + bias[None, None]
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", w, v))
    return torch.cat(outs, dim=1)


def _seq_mask(s_loc: int, first: int, skv: int, window: int, causal: bool,
              device) -> torch.Tensor:
    """(1, s_loc, Skv) mask of the queries at positions [first, first +
    s_loc) of a sequence of Skv."""
    i = first + torch.arange(s_loc, device=device)[:, None]
    j = torch.arange(skv, device=device)[None, :]
    if not causal:
        return torch.ones((1, s_loc, skv), dtype=torch.bool, device=device)
    m = j <= i
    if window > 0:
        m = m & (j > (i - window))
    return m[None]


def _sdpa_auto(cfg: ModelConfig, q, k, v, window: int, causal: bool = True,
               first: Optional[int] = None):
    """Pick chunked vs. materialized scores by footprint.  ``first``: q is
    the block of the query sequence from that position (context-parallel
    attention under a shard context whose model axis does not divide the
    heads), which the reference attends with materialized scores, whatever
    their size."""
    if first is not None:
        mask = _seq_mask(q.shape[1], first, k.shape[1], window, causal, q.device)
        return _sdpa(cfg, q, k, v, mask)
    if q.shape[1] * k.shape[1] > CHUNK_THRESHOLD and q.shape[1] > 1:
        return _sdpa_chunked(cfg, q, k, v, window, causal)
    mask = (_causal_mask(q.shape[1], k.shape[1], window, q.device) if causal else
            torch.ones((1, q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device))
    return _sdpa(cfg, q, k, v, mask)


def _write_prefix(cache: Optional[dict], names, vals, ctx) -> None:
    """Write [0, S) of each cache leaf in place; a value on the rank's head
    block (dim 2) is gathered whole over the heads first."""
    if cache is None:
        return
    for name, val in zip(names, vals):
        if val.ndim == 4 and ctx is not None and val.shape[2] != cache[name].shape[2]:
            val = whole_of(val, ctx, 2)
        cache[name][:, :val.shape[1]] = val.to(cache[name].dtype)


def gqa_full(params: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, local: bool, cache: Optional[dict] = None):
    """Prefill attention.  Returns (out, cache_or_None); the given cache
    ({"k": (B,S_max,Hkv,D), "v": ...}) is written in place at positions
    [0, S) — one fewer copy than the reference's functional update.  Under
    a context ``x`` and ``out`` are in the residual layout (see the module
    docstring) and ``positions`` cover the whole sequence."""
    ctx = current_ctx()
    mode = _mode(ctx, cfg.num_heads, x)
    window = cfg.sliding_window if local else 0
    seq = ctx is not None and ctx.seq_blocks
    if mode in (None, "whole"):
        return _gqa_full_on(gather_tree(params), cfg, x, positions, window, cache, ctx), cache
    if mode == "seq":
        # context-parallel: q on the rank's sequence block, k/v whole
        w = {k: copy_to_model(gather(v), ctx) for k, v in params.items()}
        first = ctx.mesh.axis_index(ctx.model_axis) * x.shape[1]
        hf = gather_seq(x, ctx, 1)
        k, v = _proj(w, cfg, hf, "k"), _proj(w, cfg, hf, "v")
        q = apply_rope(_proj(w, cfg, x, "q"), positions[:, first:first + x.shape[1]],
                       cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        _write_prefix(cache, ("k", "v"), (k, v), ctx)
        out = _sdpa_auto(cfg, q, k, v, window, causal=True, first=first)
        return torch.einsum("bshk,hkd->bsd", out, w["wo"]), cache
    out = _gqa_full_on(_head_weights(params, cfg, ctx), cfg, enter(x, ctx, seq), positions,
                       window, cache, ctx)
    return leave(out, ctx, seq), cache


def _gqa_full_on(w: dict, cfg: ModelConfig, h, positions, window: int, cache, ctx):
    """Attention of the whole sequence ``h`` on the heads of ``w`` (whole,
    or the rank's head blocks): the output before any sum over "model"."""
    q, k, v = _qkv(w, cfg, h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    _write_prefix(cache, ("k", "v"), (k, v), ctx)
    out = _sdpa_auto(cfg, q, _kv_for(cfg, k, q.shape[2]), _kv_for(cfg, v, q.shape[2]),
                     window, causal=True)
    return torch.einsum("bshk,hkd->bsd", out, w["wo"])


def encoder_attention(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder self-attention: non-causal, no rope; under a
    context on the rank's heads (or whole on every rank)."""
    ctx = current_ctx()
    mode = _mode(ctx, cfg.num_heads, x)
    seq = ctx is not None and ctx.seq_blocks
    if mode in ("whole", "seq"):
        return replicated(lambda h: _encoder_plain(gather_tree(params), cfg, h), x, ctx, seq)
    w = gather_tree(params) if mode is None else _head_weights(params, cfg, ctx)
    out = _encoder_plain(w, cfg, x if mode is None else enter(x, ctx, seq))
    return out if mode is None else leave(out, ctx, seq)


def _encoder_plain(w: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", h, w["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, w["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, w["wv"])
    a = _sdpa_auto(cfg, q, k, v, 0, causal=False)
    return torch.einsum("bshk,hkd->bsd", a, w["wo"])


def gqa_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               cache_pos: torch.Tensor, local: bool):
    """One-token decode against one layer's slot cache.  x: (B,1,d); cache:
    {"k": (B,S,Hkv,D), "v": ...}; cache_pos: (B,) int32 write positions.
    The new K/V are written IN PLACE (the reference returns new arrays);
    returns (out, cache).  Under a shard context whose model axis divides
    the cache length, the sequence-sharded decode runs instead; q, k_new
    and v_new are made whole over the heads for it, and ``wo`` runs on the
    rank's heads (see the module docstring)."""
    ctx = current_ctx()
    heads = _mode(ctx, cfg.num_heads, x) == "heads"
    w = _head_weights(params, cfg, ctx) if heads else gather_tree(params)
    q, k_new, v_new = _qkv(w, cfg, enter(x, ctx, False) if heads else x)
    q = apply_rope(q, cache_pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, cache_pos[:, None], cfg.rope_theta)
    if heads:
        q, k_new, v_new = (t if t.shape[2] == n else whole_of(t, ctx, 2) for t, n in
                           ((q, cfg.num_heads), (k_new, cfg.num_kv_heads),
                            (v_new, cfg.num_kv_heads)))
    out = _gqa_decode_attend(cfg, q, k_new, v_new, cache, cache_pos, local, ctx)
    return _heads_out(out, w["wo"], ctx, heads), cache


def _heads_out(out: torch.Tensor, wo: torch.Tensor, ctx, heads: bool) -> torch.Tensor:
    """A decode's output projection: whole, or on the rank's heads of the
    whole ``out`` with the partial sums reduced over "model"."""
    if not heads:
        return torch.einsum("bshk,hkd->bsd", out, wo)
    out = block_of(out, ctx, 2)
    return reduce_from_model(torch.einsum("bshk,hkd->bsd", out, wo), ctx)


def _gqa_decode_attend(cfg: ModelConfig, q, k_new, v_new, cache: dict, cache_pos,
                       local: bool, ctx) -> torch.Tensor:
    """The new row written into the cache and attention over it, all heads:
    (B,1,Hq,D)."""
    pos = cache_pos.long()
    rows = torch.arange(q.shape[0], device=q.device)
    if ctx is not None and divides(cache["k"].shape[1], ctx.tp):
        check_cache(cache["k"])
        out = _gqa_decode_seqsharded(cfg, q, k_new, v_new, cache, cache_pos, local, ctx)
        if not isinstance(cache["k"], Stored):
            cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
            cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
        return out

    with opened(cache) as c:
        c["k"][rows, pos] = k_new[:, 0].to(c["k"].dtype)
        c["v"][rows, pos] = v_new[:, 0].to(c["v"].dtype)
        s_max = c["k"].shape[1]
        j = torch.arange(s_max, device=q.device)[None, :]
        mask = j <= pos[:, None]
        if local and cfg.sliding_window > 0:
            mask &= j > (pos[:, None] - cfg.sliding_window)
        return _sdpa(cfg, q, c["k"].to(q.dtype), c["v"].to(q.dtype), mask[:, None, :])


def _write_row_guarded(c: torch.Tensor, new: torch.Tensor, lp_safe, in_range) -> None:
    """Write ``new`` (B, ...) into row ``lp_safe`` of each batch row of the
    chunk ``c`` (B, S_loc, ...) in place where ``in_range``; elsewhere the
    row is re-written with what it holds (a one-row read and write, not a
    select over the whole chunk)."""
    rows = torch.arange(c.shape[0], device=c.device)
    cur = c[rows, lp_safe]
    ok = in_range.reshape((-1,) + (1,) * (cur.ndim - 1))
    c[rows, lp_safe] = torch.where(ok, new.to(c.dtype), cur)


def _seq_chunk(mesh, axis: str, s_loc: int, pos: torch.Tensor):
    """(start, in-range, clamped local position) of this rank's chunk of
    ``s_loc`` cache positions along ``axis``, for write positions ``pos``."""
    start = mesh.axis_index(axis) * s_loc
    lp = pos.long() - start
    return start, (lp >= 0) & (lp < s_loc), lp.clamp(0, s_loc - 1)


def _gqa_decode_seqsharded(cfg: ModelConfig, q, k_new, v_new, cache, cache_pos,
                           local: bool, ctx) -> torch.Tensor:
    """Flash-decode with the KV cache split over the model axis on the
    sequence: each rank writes the new row into its chunk (when the row
    falls there), attends over the chunk, and the partial softmax
    statistics are combined with ``pmax`` / ``psum``, the collective form
    of flash attention's online softmax.

    q: (B,1,Hq,D); k_new/v_new: (B,1,Hkv,D); cache k/v: (B,S,Hkv,D).
    Returns out (B,1,Hq,D)."""
    mesh, ax = ctx.mesh, ctx.model_axis
    b_ax = batch_axis(ctx, q.shape[0])
    window = cfg.sliding_window if local else 0

    def body(qb, kn, vn, kc, vc, pos):
        s_loc = kc.shape[1]
        start, in_range, lp_safe = _seq_chunk(mesh, ax, s_loc, pos)
        _write_row_guarded(kc, kn[:, 0], lp_safe, in_range)
        _write_row_guarded(vc, vn[:, 0], lp_safe, in_range)

        hq, dh = qb.shape[2], qb.shape[3]
        hkv = kc.shape[2]
        qg = qb.reshape(qb.shape[0], 1, hkv, hq // hkv, dh)
        kcq, vcq = kc.to(qb.dtype), vc.to(qb.dtype)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kcq).float() * (dh ** -0.5)
        if cfg.attn_logit_softcap > 0:
            scores = softcap(scores, cfg.attn_logit_softcap)
        jg = start + torch.arange(s_loc, device=qb.device)
        p64 = pos.long()[:, None]
        mask = jg[None, :] <= p64
        if window > 0:
            mask = mask & (jg[None, :] > (p64 - window))
        scores = scores.masked_fill(~mask[:, None, None, None, :], NEG_INF)

        m = mesh.pmax(scores.amax(-1, keepdim=True), ax)
        p = torch.exp(scores - m)
        l = mesh.psum(p.sum(-1, keepdim=True), ax)
        o = mesh.psum(torch.einsum("bhgqk,bkhd->bqhgd", p.to(qb.dtype), vcq), ax)
        out = o / l.clamp(min=1e-20).to(o.dtype).permute(0, 3, 1, 2, 4)
        return out.reshape(qb.shape[0], 1, hq, vcq.shape[-1])

    rep4 = P(b_ax, None, None, None)
    shard4 = P(b_ax, ax, None, None)
    return shard_map(body, mesh, in_specs=(rep4, rep4, rep4, shard4, shard4, P(b_ax)),
                     out_specs=rep4)(q, k_new, v_new, cache["k"], cache["v"], cache_pos)


def _paged_append_int8(pages, scales, phys, off, new):
    """Append one token per row into int8 pages with per-page scales, in
    place.  pages: (P, BS, Hkv, D) int8; scales: (P,) f32; phys/off: (B,)
    page id / in-page offset; new: (B, Hkv, D).  The scale update is
    MONOTONE (never shrinks), so when the new token fits the old scale the
    requantize round-trips existing entries exactly (round(q*s/s) == q)."""
    rows = torch.arange(phys.shape[0], device=phys.device)
    blk = pages[phys].float() * scales[phys][:, None, None, None]
    blk[rows, off] = new.float()
    amax = torch.amax(torch.abs(blk), dim=(1, 2, 3))
    new_scale = torch.maximum(scales[phys], torch.clamp(amax, min=1e-12) / 127.0)
    q = torch.clamp(torch.round(blk / new_scale[:, None, None, None]),
                    -127, 127).to(torch.int8)
    pages[phys] = q
    scales[phys] = new_scale


def gqa_decode_paged(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                     block_tables: torch.Tensor, lengths: torch.Tensor,
                     local: bool, use_kernel: bool = False):
    """One-token decode against a paged KV pool (one layer's pages).

    x: (B,1,d); cache: {"k": (P,BS,Hkv,D), "v": ..., optional "k_scale"/
    "v_scale": (P,) f32 for int8 pages}; block_tables: (B,NB) physical page
    per logical block (page 0 = reserved garbage page — free rows write
    there); lengths: (B,) tokens resident = write position.  The pages are
    updated IN PLACE (the reference returns new arrays); returns
    (out, cache).

    The host guarantees (PagedKVCache.prepare_append) that active rows' tail
    pages are private (copy-on-write) and allocated; inactive rows carry
    lengths=0 and all-zero table rows, so their scatter lands in the garbage
    page and their (discarded) output attends only to it."""
    q, k_new, v_new = _qkv(params, cfg, x)
    q = apply_rope(q, lengths[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, lengths[:, None], cfg.rope_theta)

    b = x.shape[0]
    bs_blk = cache["k"].shape[1]
    nb = block_tables.shape[1]
    lengths_l = lengths.long()
    bidx = lengths_l // bs_blk
    off = lengths_l % bs_blk
    phys = block_tables.long()[torch.arange(b, device=x.device), bidx]   # (B,)
    quantized = "k_scale" in cache

    if quantized:
        _paged_append_int8(cache["k"], cache["k_scale"], phys, off, k_new[:, 0])
        _paged_append_int8(cache["v"], cache["v_scale"], phys, off, v_new[:, 0])
    else:
        cache["k"][phys, off] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][phys, off] = v_new[:, 0].to(cache["v"].dtype)

    windowed = local and cfg.sliding_window > 0
    if use_kernel and not windowed:
        o = paged_decode_attention(
            q[:, 0], cache["k"], cache["v"], block_tables, lengths + 1,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            softcap=float(cfg.attn_logit_softcap))
        out = o[:, None].to(x.dtype)
    else:
        bt = block_tables.long()
        kb = cache["k"][bt]                                  # (B,NB,BS,Hkv,D)
        vb = cache["v"][bt]
        if quantized:
            kb = kb.float() * cache["k_scale"][bt][..., None, None, None]
            vb = vb.float() * cache["v_scale"][bt][..., None, None, None]
        hkv, d = cache["k"].shape[2], cache["k"].shape[3]
        kb = kb.reshape(b, nb * bs_blk, hkv, d)
        vb = vb.reshape(b, nb * bs_blk, hkv, d)
        j = torch.arange(nb * bs_blk, device=x.device)[None, :]
        mask = j <= lengths_l[:, None]
        if windowed:
            mask &= j > (lengths_l[:, None] - cfg.sliding_window)
        out = _sdpa(cfg, q, kb.to(q.dtype), vb.to(q.dtype), mask[:, None, :])
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return out, cache


# =============================================================================
# Cross attention (whisper decoder)
# =============================================================================

def cross_attention(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    memory: torch.Tensor) -> torch.Tensor:
    """x: (B,Sq,d) queries (under a context in the residual layout);
    memory: (B,Skv,d) encoder output, whole over "model".  No mask, no
    rope.  Under a context on the rank's heads (or whole on every rank)."""
    ctx = current_ctx()
    seq = ctx is not None and ctx.seq_blocks
    if _mode(ctx, cfg.num_heads, x) != "heads":
        return replicated(lambda h: _cross_on(gather_tree(params), cfg, h, memory), x, ctx,
                          seq)
    out = _cross_on(_head_weights(params, cfg, ctx), cfg, enter(x, ctx, seq),
                    enter(memory, ctx, False))
    return leave(out, ctx, seq)


def _cross_on(w: dict, cfg: ModelConfig, x: torch.Tensor, memory: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, w["wq"])
    k = torch.einsum("bsd,dhk->bshk", memory, w["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, w["wv"])
    mask = torch.ones((1, q.shape[1], k.shape[1]), dtype=torch.bool, device=x.device)
    return torch.einsum("bshk,hkd->bsd", _sdpa(cfg, q, k, v, mask), w["wo"])


# =============================================================================
# MLA (deepseek-v2)
# =============================================================================

def init_mla(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    s = d ** -0.5
    dt = cfg.adtype
    p = {
        "wkv_a": normal(gen, (d, r_kv + dr), s, dt),
        "kv_norm": torch.zeros((r_kv,), dtype=dt, device=gen.device),
        "wkv_b": normal(gen, (r_kv, h, dn + dv), r_kv ** -0.5, dt),
        "wo": normal(gen, (h, dv, d), (h * dv) ** -0.5, dt),
    }
    if r_q > 0:
        p["wq_a"] = normal(gen, (d, r_q), s, dt)
        p["q_norm"] = torch.zeros((r_q,), dtype=dt, device=gen.device)
        p["wq_b"] = normal(gen, (r_q, h, dn + dr), r_q ** -0.5, dt)
    else:
        p["wq"] = normal(gen, (d, h, dn + dr), s, dt)
    return p


def _mla_q(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank > 0:
        cq = rms_norm(torch.einsum("bsd,dr->bsr", x, params["wq_a"]), params["q_norm"],
                      cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", cq, params["wq_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """The compressed cache entries of x: (ckv (B,S,R) normed, krope (B,S,Dr)
    roped with a singleton head axis)."""
    r_kv = cfg.kv_lora_rank
    kv = torch.einsum("bsd,dr->bsr", x, params["wkv_a"])
    ckv = rms_norm(kv[..., :r_kv], params["kv_norm"], cfg.norm_eps)
    krope = apply_rope(kv[..., None, r_kv:], positions, cfg.rope_theta)[..., 0, :]
    return ckv, krope


def mla_full(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
             cache: Optional[dict] = None):
    """Naive (paper-faithful) MLA for prefill: decompress, then attend with
    q/k of head dim dn + dr and v of dv.  The given cache is written in
    place at positions [0, S).  Under a context on the rank's heads of
    ``wq_b``/``wkv_b``/``wo`` (the latent projections and their norms
    whole), or whole on every rank where the heads do not divide."""
    ctx = current_ctx()
    mode = _mode(ctx, cfg.num_heads, x)
    seq = ctx is not None and ctx.seq_blocks
    if mode != "heads":
        return replicated(lambda h: _mla_full_on(gather_tree(params), cfg, h, positions,
                                                 cache), x, ctx, seq), cache
    out = _mla_full_on(_head_weights(params, cfg, ctx), cfg, enter(x, ctx, seq), positions,
                       cache)
    return leave(out, ctx, seq), cache


def _mla_full_on(w: dict, cfg: ModelConfig, x, positions, cache) -> torch.Tensor:
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(w, cfg, x, positions)
    ckv, krope = _mla_ckv(w, cfg, x, positions)
    # naive even where the decode is absorbed: each position is decompressed
    # once, and S x S attention at head dim dn + dr suits the tensor cores
    if cache is not None:
        s = ckv.shape[1]
        cache["ckv"][:, :s] = ckv.to(cache["ckv"].dtype)
        cache["krope"][:, :s] = krope.to(cache["krope"].dtype)
    kv = torch.einsum("bsr,rhk->bshk", ckv, w["wkv_b"])
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(*krope.shape[:2], q.shape[2],
                                                        krope.shape[-1])], dim=-1)
    out = _sdpa_auto(cfg, q, k, v, 0, causal=True)
    return torch.einsum("bshk,hkd->bsd", out[..., :dv], w["wo"])


def mla_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               cache_pos: torch.Tensor, absorb: bool = False):
    """One-token MLA decode against one layer's COMPRESSED slot cache,
    written IN PLACE at ``cache_pos``.

    absorb=False: paper-faithful, decompress every cached step, then attend.
    absorb=True: weight-absorbed, scores in latent space; never builds
    per-head K/V for the cache.  The same mathematics: ``wkv_b``'s halves
    reassociated, operands in the activations' dtype, f32 softmax, the
    same mask.  The serving backend (``TorchBackend``) always decodes
    absorbed; ``launch.steps``'s decode step follows ``ShardCtx.mla_absorb``
    (naive by default); the tests and ``chip_smoke.py`` take both.

    Under a shard context whose model axis divides the cache length, the
    sequence-sharded decode runs instead.  Under a context whose model axis
    divides the heads, the queries are computed on the rank's heads and made
    whole for the attention (which takes ``wkv_b`` whole), and ``wo`` runs
    on the rank's heads."""
    tracing.count("mla_decode_layers", 1)
    if absorb:
        tracing.count("mla_decode_latent", 1)
    dn = cfg.qk_nope_head_dim
    ctx = current_ctx()
    heads = _mode(ctx, cfg.num_heads, x) == "heads"
    pw = _head_weights(params, cfg, ctx) if heads else gather_tree(params)
    h = enter(x, ctx, False) if heads else x
    q_nope, q_rope = _mla_q(pw, cfg, h, cache_pos[:, None])
    ckv_new, krope_new = _mla_ckv(pw, cfg, h, cache_pos[:, None])
    wkv_b = pw["wkv_b"]                       # the attention below takes every head's
    if heads:
        q_nope, q_rope = whole_of(q_nope, ctx, 2), whole_of(q_rope, ctx, 2)
        wkv_b = gather(params["wkv_b"])
    pos = cache_pos.long()
    rows = torch.arange(x.shape[0], device=x.device)

    if ctx is not None and divides(cache["ckv"].shape[1], ctx.tp):
        check_cache(cache["ckv"])
        out = _mla_decode_seqsharded(cfg, wkv_b, q_nope, q_rope, ckv_new, krope_new,
                                     cache, cache_pos, ctx, absorb)
        if not isinstance(cache["ckv"], Stored):
            cache["ckv"][rows, pos] = ckv_new[:, 0].to(cache["ckv"].dtype)
            cache["krope"][rows, pos] = krope_new[:, 0].to(cache["krope"].dtype)
        return _heads_out(out, pw["wo"], ctx, heads), cache

    with opened(cache) as c:
        c["ckv"][rows, pos] = ckv_new[:, 0].to(c["ckv"].dtype)
        c["krope"][rows, pos] = krope_new[:, 0].to(c["krope"].dtype)
        ckv_c = c["ckv"].to(x.dtype)
        krope_c = c["krope"].to(x.dtype)

    s_max = ckv_c.shape[1]
    masked = (torch.arange(s_max, device=x.device)[None, :] > pos[:, None])[:, None, None]
    scale = (dn + cfg.qk_rope_head_dim) ** -0.5
    if absorb:
        wkb_k = wkv_b[..., :dn]                                   # (r, h, dn)
        wkb_v = wkv_b[..., dn:]                                   # (r, h, dv)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wkb_k)     # (b,1,h,r)
        scores = (torch.einsum("bshr,btr->bhst", q_lat, ckv_c)
                  + torch.einsum("bshk,btk->bhst", q_rope, krope_c)).float() * scale
        w = torch.softmax(scores.masked_fill(masked, NEG_INF), dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhst,btr->bshr", w, ckv_c)          # (b,1,h,r)
        out = torch.einsum("bshr,rhk->bshk", o_lat, wkb_v)        # (b,1,h,dv)
    else:
        kv = torch.einsum("btr,rhk->bthk", ckv_c, wkv_b)          # every step
        k_nope, v = kv[..., :dn], kv[..., dn:]
        scores = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
                  + torch.einsum("bshk,btk->bhst", q_rope, krope_c)).float() * scale
        w = torch.softmax(scores.masked_fill(masked, NEG_INF), dim=-1).to(x.dtype)
        out = torch.einsum("bhst,bthk->bshk", w, v)
    return _heads_out(out, pw["wo"], ctx, heads), cache


def _mla_decode_seqsharded(cfg: ModelConfig, wkb, q_nope, q_rope, ckv_new,
                           krope_new, cache, cache_pos, ctx, absorb: bool) -> torch.Tensor:
    """MLA decode with the compressed cache split over the model axis on
    the sequence (flash-decode combine over the model axis, as the GQA
    one).  absorb=True scores in latent space; absorb=False decompresses
    only this rank's chunk.  Returns out (B,1,H,dv)."""
    mesh, ax = ctx.mesh, ctx.model_axis
    dn = cfg.qk_nope_head_dim
    b_ax = batch_axis(ctx, q_nope.shape[0])
    scale = (dn + cfg.qk_rope_head_dim) ** -0.5
    # wkb: wkv_b (r, H, dn+dv), whole on every rank
    # latent queries (absorbed); the naive body reads q_nope itself
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wkb[..., :dn]) if absorb else q_nope

    def body(qn, qr, ql, cn, kn, ckv, krope, pos, wkb_b):
        s_loc = ckv.shape[1]
        start, in_range, lp_safe = _seq_chunk(mesh, ax, s_loc, pos)
        _write_row_guarded(ckv, cn[:, 0], lp_safe, in_range)
        _write_row_guarded(krope, kn[:, 0], lp_safe, in_range)

        ckv_c, krope_c = ckv.to(qn.dtype), krope.to(qn.dtype)
        jg = start + torch.arange(s_loc, device=qn.device)
        mask = jg[None, :] <= pos.long()[:, None]
        if absorb:
            scores = (torch.einsum("bshr,btr->bhst", ql, ckv_c)
                      + torch.einsum("bshk,btk->bhst", qr, krope_c)).float() * scale
        else:
            kv = torch.einsum("btr,rhk->bthk", ckv_c, wkb_b)       # local decompress
            scores = (torch.einsum("bshk,bthk->bhst", qn, kv[..., :dn])
                      + torch.einsum("bshk,btk->bhst", qr, krope_c)).float() * scale
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
        m = mesh.pmax(scores.amax(-1, keepdim=True), ax)
        p = torch.exp(scores - m)
        l = mesh.psum(p.sum(-1, keepdim=True), ax)
        w = p.to(qn.dtype)
        if absorb:
            o_lat = mesh.psum(torch.einsum("bhst,btr->bshr", w, ckv_c), ax)
            o_lat = o_lat / l.clamp(min=1e-20).to(o_lat.dtype).permute(0, 2, 1, 3)
            return torch.einsum("bshr,rhk->bshk", o_lat, wkb_b[..., dn:])
        o = mesh.psum(torch.einsum("bhst,bthk->bshk", w, kv[..., dn:]), ax)
        return o / l.clamp(min=1e-20).to(o.dtype).permute(0, 2, 1, 3)

    rep3 = P(b_ax, None, None)
    rep4 = P(b_ax, None, None, None)
    shard3 = P(b_ax, ax, None)
    return shard_map(body, mesh,
                     in_specs=(rep4, rep4, rep4, rep3, rep3, shard3, shard3, P(b_ax),
                               P(None, None, None)),
                     out_specs=rep4)(q_nope, q_rope, q_lat, ckv_new, krope_new,
                                     cache["ckv"], cache["krope"], cache_pos, wkb)


# =============================================================================
# Entry points used by blocks.py
# =============================================================================

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    if cfg.attention_type == "mla":
        return init_mla(gen, cfg)
    return init_gqa(gen, cfg)


def attention_full(params: dict, cfg: ModelConfig, x, positions, local: bool,
                   cache: Optional[dict] = None):
    if cfg.attention_type == "mla":
        return mla_full(params, cfg, x, positions, cache)
    return gqa_full(params, cfg, x, positions, local, cache)


def attention_decode(params: dict, cfg: ModelConfig, x, cache, cache_pos, local: bool,
                     mla_absorb: bool = False):
    if cfg.attention_type == "mla":
        return mla_decode(params, cfg, x, cache, cache_pos, absorb=mla_absorb)
    return gqa_decode(params, cfg, x, cache, cache_pos, local)
