"""Plain PyTorch versions of every kernel of the port (the numerics ground
truth), mirroring ``repro.kernels.ref``.

Each wrapper takes its plain version for tensors on the CPU; ``chip_smoke.py``
holds each CUDA kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties broken to the LOWEST index, like
    ``lax.top_k`` and the kernels' iterative argmax (``torch.topk`` promises
    no order among equal values).  A stable descending sort keeps equal
    values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def ref_moe_gemm(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped expert GEMM.  xe: (E, C, D), w: (E, D, F) -> (E, C, F) in f32
    accumulation, cast back to xe.dtype."""
    out = torch.einsum("ecd,edf->ecf", xe.float(), w.float())
    return out.to(xe.dtype)


def ref_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """Single-token GQA decode attention.
    q: (B, Hq, D); k, v: (B, S, Hkv, D); lengths: (B,) valid KV length per row.
    Returns (B, Hq, D); a row with length 0 is exactly zero."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) * (d ** -0.5)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]   # (B, S)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    wts = torch.softmax(scores, dim=-1)
    # a length-0 row has an all -inf score row (softmax -> NaN); the kernel
    # contract is zeros there
    wts = torch.where(lengths[:, None, None, None] > 0, wts, torch.zeros_like(wts))
    out = torch.einsum("bhgs,bshd->bhgd", wts, v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def ref_flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              lengths: torch.Tensor, softcap: float = 0.0,
                              chunk: int = 64, k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None):
    """The split pass of the decode kernels in plain PyTorch: per chunk of
    ``chunk`` positions, the f32 online-softmax partial of each query head.
    Optional per-position scales (B, S) of a quantised store: the K scale
    multiplies the position's score before the softcap, the V scale its
    probability in the P.V weights only (``l`` sums the unscaled ones).
    Returns (m (B,Hq,N), l (B,Hq,N), acc (B,Hq,N,D), valid (B,N)) with N =
    ceil(S / chunk); a chunk is valid when it starts before the row's length,
    and only valid chunks carry meaning.  Not on any main path: it mirrors
    the arithmetic of ``csrc/split_decode.cuh`` for the tests and the fault
    checks of chip_smoke.py."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    n = -(-s // chunk)
    pad = n * chunk - s
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.reshape(b, n, chunk, hkv, d)
    vf = vf.reshape(b, n, chunk, hkv, d)
    scores = torch.einsum("bhgd,bnchd->bhgnc", q.float().reshape(b, hkv, g, d), kf)
    if k_scale is not None:
        scores = scores * _per_chunk(k_scale, n, chunk)
    scores = scores * (d ** -0.5)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    pos = torch.arange(n * chunk, device=q.device).reshape(n, chunk)
    mask = pos[None] < lengths.long()[:, None, None]                 # (B, N, chunk)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    m = scores.amax(-1)                                              # (B, Hkv, G, N)
    p = torch.exp(scores - m[..., None])                             # NaN in empty chunks
    l = p.sum(-1)
    if v_scale is not None:
        p = p * _per_chunk(v_scale, n, chunk)
    acc = torch.einsum("bhgnc,bnchd->bhgnd", p, vf)
    valid = mask[..., 0]
    return (m.reshape(b, hq, n), l.reshape(b, hq, n), acc.reshape(b, hq, n, d), valid)


def _per_chunk(x: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """(B, S) per-position values -> (B, 1, 1, N, chunk), padded with 1."""
    x = torch.nn.functional.pad(x.float(), (0, n * chunk - x.shape[1]), value=1.0)
    return x.reshape(x.shape[0], 1, 1, n, chunk)


def ref_merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """The merge pass: sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i,
    1e-20) over the valid chunks, M their largest m.  A row with no valid
    chunk (length 0) is exactly zero.  Returns (B, Hq, D) f32."""
    vm = valid[:, None, :]
    mx = torch.where(vm, m, torch.full_like(m, float("-inf"))).amax(-1, keepdim=True)
    # invalid chunks hold NaN (e^(-inf - -inf)); they get weight 0 and are zeroed
    w = torch.where(vm, torch.exp(m - mx), torch.zeros_like(m))
    num = (w[..., None] * acc.masked_fill(~vm[..., None], 0.0)).sum(-2)
    den = (w * l.masked_fill(~vm, 0.0)).sum(-1, keepdim=True)
    return num / torch.clamp(den, min=1e-20)


def ref_flash_decode_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, softcap: float = 0.0,
                           chunk: int = 64) -> torch.Tensor:
    """``ref_flash_decode`` computed as the slot kernel computes it: chunk
    partials, then the log-sum-exp merge.  Returns (B, Hq, D) in q's dtype."""
    parts = ref_flash_decode_partials(q, k, v, lengths, softcap, chunk)
    return ref_merge_partials(*parts).to(q.dtype)


def ref_flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, softcap: float = 0.0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged single-token GQA decode attention (block-table indexed).
    q: (B, Hq, D); k_pages, v_pages: (P, BS, Hkv, D) page pool; block_tables:
    (B, NB) int32 physical page per logical block (page 0 is the garbage
    page); lengths: (B,).  Optional per-page int8 scales (P,) f32."""
    b = q.shape[0]
    _, bs, hkv, d = k_pages.shape
    nb = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[bt].float()                      # (B, NB, BS, Hkv, D)
    v = v_pages[bt].float()
    if k_scale is not None:
        k = k * k_scale[bt][:, :, None, None, None]
    if v_scale is not None:
        v = v * v_scale[bt][:, :, None, None, None]
    k = k.reshape(b, nb * bs, hkv, d)
    v = v.reshape(b, nb * bs, hkv, d)
    return ref_flash_decode(q, k, v, lengths, softcap)


def ref_flash_decode_paged_partials(q: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                                    lengths: torch.Tensor, softcap: float = 0.0,
                                    k_scale: Optional[torch.Tensor] = None,
                                    v_scale: Optional[torch.Tensor] = None,
                                    chunk: int = 32):
    """The paged kernel's split pass in plain PyTorch: each row's pages
    gathered through its block table into one (B, NB * BS) store of the
    raw page values, each position carrying its own page's scales, then
    ``ref_flash_decode_partials`` over ``chunk``-position chunks (which may
    span pages).  Lengths are clamped to NB * BS.  Returns the partials as
    that function does; not on any main path."""
    b = q.shape[0]
    _, bs, hkv, d = k_pages.shape
    nb = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, nb * bs, hkv, d)
    v = v_pages[bt].reshape(b, nb * bs, hkv, d)

    def per_position(scale):
        return None if scale is None else scale[bt].repeat_interleave(bs, dim=1)
    lengths = lengths.clamp(0, nb * bs)
    return ref_flash_decode_partials(q, k, v, lengths, softcap, chunk,
                                     k_scale=per_position(k_scale),
                                     v_scale=per_position(v_scale))


def slot_positions(slots: torch.Tensor, num_slots: int) -> torch.Tensor:
    """GShard capacity positions: each selection's rank among the earlier
    selections of its slot, in row-major order of ``slots`` (token-major,
    then selection, for (T, k)), by a one-hot cumsum.  Returns int32."""
    onehot = (slots.reshape(-1, 1).long()
              == torch.arange(num_slots, device=slots.device)[None, :]).int()
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    return pos.reshape(slots.shape).int()


def ref_topk_router(logits: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused router: softmax, top-k (lowest index on ties), renormalised
    gates, and capacity positions per expert in token-major, then selection,
    order.  logits: (T, E).  Returns (gates (T,k) f32, ids (T,k), pos (T,k)),
    the integers as int32."""
    e = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids.int(), slot_positions(ids, e)


def ref_topk_router_replicated(logits: torch.Tensor, k: int,
                               replica_slots: torch.Tensor,
                               replica_count: torch.Tensor, num_slots: int
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, torch.Tensor]:
    """Replica-aware fused router: softmax, top-k (lowest index on ties),
    renormalised gates, logical -> physical slot round-robin on the global
    selection index ((t*k + j) mod n_replicas), and per-slot capacity
    positions in token-major order.  Returns (gates (T,k) f32, ids (T,k)
    logical, slots (T,k) physical, pos (T,k)), the integers as int32."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    sel = (torch.arange(t, device=logits.device)[:, None] * k
           + torch.arange(k, device=logits.device)[None, :])
    ridx = sel % torch.clamp(replica_count.long()[ids], min=1)
    slots = replica_slots.long()[ids, ridx]
    return gates, ids.int(), slots.int(), slot_positions(slots, num_slots)


def ref_router_plan_terms(slots: torch.Tensor, plan, num_slots: int) -> dict:
    """The router kernel's capacity count in plain PyTorch, as its launch
    ``plan`` (``topk_router.route_plan``: ctas, warps, per_warp, rounds)
    lays the tokens out: each selection's rank among its warp's selections
    of the same slot (token-major), the selections of that slot in the
    lower warps of its CTA, in the lower CTAs of its round, and in all
    earlier rounds (the carry).  slots: (T, k) physical slots.  Returns the
    four (T, k) int32 terms, keyed "warp_rank", "lower_warps", "lower_ctas"
    and "carry"; the position is their sum.  Not on any main path: it
    mirrors ``csrc/topk_router.cu`` for the tests and chip_smoke.py."""
    t, k = slots.shape
    n, w, m, rounds = plan.ctas, plan.warps, plan.per_warp, plan.rounds
    cap = rounds * n * w * m
    if cap < t:
        raise ValueError(f"plan covers {cap} tokens, not T={t}")
    oh = torch.zeros((cap * k, num_slots), dtype=torch.int32, device=slots.device)
    oh[:t * k] = (slots.reshape(-1, 1).long()
                  == torch.arange(num_slots, device=slots.device)[None, :]).int()
    oh = oh.reshape(rounds, n, w, m * k, num_slots)
    warp_cnt = oh.sum(3)                                     # (R, n, W, S)
    cta_cnt = warp_cnt.sum(2)                                # (R, n, S)
    round_cnt = cta_cnt.sum(1)                               # (R, S)
    terms = {
        "warp_rank": torch.cumsum(oh, 3) - oh,
        "lower_warps": (torch.cumsum(warp_cnt, 2) - warp_cnt)[:, :, :, None],
        "lower_ctas": (torch.cumsum(cta_cnt, 1) - cta_cnt)[:, :, None, None],
        "carry": (torch.cumsum(round_cnt, 0) - round_cnt)[:, None, None, None],
    }
    return {name: (x * oh).sum(-1).reshape(-1)[:t * k].reshape(t, k).int()
            for name, x in terms.items()}


def ref_router_plan_positions(slots: torch.Tensor, plan, num_slots: int) -> torch.Tensor:
    """The capacity positions (T, k) int32 as the router kernel counts them
    under ``plan``: the sum of ``ref_router_plan_terms``."""
    return sum(ref_router_plan_terms(slots, plan, num_slots).values())
