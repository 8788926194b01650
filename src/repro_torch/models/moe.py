"""Mixture-of-Experts layer with placement-aware, replica-splitting
dispatch, ported from ``repro.models.moe``.

A placement is a slot map over S = E + R physical slots (R >= 0 replicas of
hot experts).  Expert weights are stored in SLOT order, so relocating or
replicating an expert is a gather on the expert axis.  The router works in
logical-expert space and maps selected ids to slots round-robin over an
expert's replicas (``ExpertPlacement.dispatch_slots``).

Three dispatch modes with the same numerics:
  * "dense"  — GShard one-hot einsum dispatch (the paper-faithful baseline);
  * "gather" — an (S, C) token-index table, gather, grouped GEMM, scatter-add;
  * "fused"  — "gather" with the replica-aware router kernel and three
               grouped-GEMM kernels (kernels/ops.py).
The capacity rule (token-major, then selection; ``_capacity`` rounds up to
a multiple of 8) and the stats (``expert_ids``, ``expert_counts``,
``dropped_frac``) match the reference exactly.  The gather modes combine
by a per-token gather: token t reads its k gated expert rows (a dropped
selection reads a zero row, never a live slot) and sums them in f32 in
selection order, so the output is one answer per input on every device and
in every run.  The reference scatter-adds in slot order, so the two agree
within float tolerance, not bit for bit.

Under batch blocks (``ShardCtx.batch_blocks``: ``x`` is this rank's block
of the global batch, as in a step whose batch arrived stored) the layer
keeps the reference's global semantics, which its GSPMD gives it: the
capacity is the global batch's, and a selection is kept when its position
in its slot, counting the selections of the earlier blocks first (their
per-slot counts, all-gathered over the batch axes), falls below it.  The
expert FFN works row by row, so each rank runs it on its own kept tokens
only, in buffers of at most its token count a slot.  The router statistics
are summed over the blocks.  The fused mode's router kernel numbers tokens
within its call, so it is refused there.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels.ops import expert_ffn, route_replicated
from repro_torch.kernels.ref import top_k
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ffn_apply, init_ffn, normal


class ExpertPlacement(NamedTuple):
    """Replicated expert placement over S = E + R physical slots.

    ``inv[s]`` = logical expert in slot s (every expert holds >= 1 slot).
    ``perm[e]`` = primary (lowest) slot of expert e.  ``replica_slots[e, r]``
    enumerates e's slots, padded by repeating the primary;
    ``replica_count[e]`` is the true copy count.  R=0 is a permutation."""
    perm: torch.Tensor            # (E,) int32 primary slot per logical expert
    inv: torch.Tensor             # (S,) int32 logical expert per slot
    replica_slots: torch.Tensor   # (E, max_rep) int32, padded with the primary
    replica_count: torch.Tensor   # (E,) int32

    @property
    def num_slots(self) -> int:
        return self.inv.shape[0]

    @property
    def num_experts(self) -> int:
        return self.perm.shape[0]

    @staticmethod
    def identity(num_experts: int, device=None) -> "ExpertPlacement":
        eye = torch.arange(num_experts, dtype=torch.int32, device=device)
        return ExpertPlacement(perm=eye, inv=eye, replica_slots=eye[:, None],
                               replica_count=torch.ones_like(eye))

    @staticmethod
    def from_perm(perm, device=None) -> "ExpertPlacement":
        perm = torch.as_tensor(perm, dtype=torch.int32, device=device)
        inv = torch.zeros_like(perm)
        inv[perm.long()] = torch.arange(perm.shape[0], dtype=torch.int32,
                                        device=perm.device)
        return ExpertPlacement(perm=perm, inv=inv, replica_slots=perm[:, None],
                               replica_count=torch.ones_like(perm))

    @staticmethod
    def from_slot_map(inv, num_experts: int, device=None) -> "ExpertPlacement":
        """Build from a slot map (S,) slot -> logical expert."""
        inv = torch.as_tensor(inv, dtype=torch.int32, device=device)
        s, e = inv.shape[0], num_experts
        max_rep = s - e + 1                      # static copy-count bound
        onehot = (inv[None, :] == torch.arange(e, dtype=torch.int32,
                                               device=inv.device)[:, None])  # (E,S)
        count = onehot.sum(1).to(torch.int32)
        rank = torch.cumsum(onehot.int(), dim=1) * onehot            # 1-based per slot
        slots_row = torch.arange(s, dtype=torch.int32, device=inv.device)[None, :]
        absent = torch.tensor(s, dtype=torch.int32, device=inv.device)
        cols = [torch.where(rank == r + 1, slots_row, absent).amin(1)
                for r in range(max_rep)]
        tbl = torch.stack(cols, dim=1)
        primary = tbl[:, 0]
        tbl = torch.where(tbl == s, primary[:, None], tbl)
        return ExpertPlacement(perm=primary.to(torch.int32), inv=inv,
                               replica_slots=tbl.to(torch.int32),
                               replica_count=count)

    def dispatch_slots(self, expert_ids: torch.Tensor, first: int = 0) -> torch.Tensor:
        """Physical slot per selection with round-robin load splitting:
        selection (t, j) goes to replica (t*k + j) mod n_replicas, t the
        global index of the token (``first`` that of row 0: a batch
        block's offset).  expert_ids: (T, k) logical -> (T, k) slots
        (int32)."""
        t, k = expert_ids.shape
        dev = expert_ids.device
        ids = expert_ids.long()
        sel = ((first + torch.arange(t, device=dev))[:, None] * k
               + torch.arange(k, device=dev)[None, :])
        ridx = sel % torch.clamp(self.replica_count.long()[ids], min=1)
        return self.replica_slots[ids, ridx].to(torch.int32)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    dt = cfg.adtype
    p = {
        "w_router": normal(gen, (d, e), s_in, torch.float32),
        "w_gate": normal(gen, (e, d, f), s_in, dt),
        "w_up": normal(gen, (e, d, f), s_in, dt),
        "w_down": normal(gen, (e, f, d), s_out, dt),
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = init_ffn(gen, d, cfg.moe_d_ff * cfg.num_shared_experts, dt)
    return p


def router_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1)


def top_k_gating(probs: torch.Tensor, k: int):
    """Returns (gates (T,k) renormalized, expert ids (T,k)); ties go to the
    lowest expert id, as ``lax.top_k``."""
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(cfg.capacity_factor * cfg.moe_top_k * num_tokens / cfg.num_experts) + 1
    # round capacity up to a multiple of 8, as the reference does
    return max(8, -(-c // 8) * 8)


def _expert_ffn(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d) gated FFN per expert (grouped GEMM)."""
    gate = torch.einsum("ecd,edf->ecf", xe, params["w_gate"])
    up = torch.einsum("ecd,edf->ecf", xe, params["w_up"])
    act = F.silu(gate.float()).to(xe.dtype) * up
    return torch.einsum("ecf,efd->ecd", act, params["w_down"])


def _dispatch_tables(slot_idx: torch.Tensor, num_slots: int, capacity: int):
    """Capacity assignment shared by the dense and gather modes.
    slot_idx: (T, k) physical slot per selection.  Returns (pos (T,k)
    position-in-slot, >= capacity if dropped; keep (T,k) bool).
    Priority: earlier tokens first, then lower k — the GShard rule."""
    t, k = slot_idx.shape
    flat = slot_idx.reshape(-1).long()                               # token-major
    onehot = (flat[:, None] == torch.arange(num_slots, device=flat.device)[None, :]).int()
    pos_flat = (torch.cumsum(onehot, dim=0) - 1) * onehot
    pos = pos_flat.sum(-1).reshape(t, k).to(torch.int32)
    return pos, pos < capacity


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot that maps out-of-range indices to all-zero rows (as
    ``jax.nn.one_hot``; ``F.one_hot`` raises on them)."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _token_table(slots: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
                 ns: int, cap: int) -> torch.Tensor:
    """(S, C) token-index table: which token sits in slot (s, c); ``t``
    (the token count) where none does.  Dropped selections land in an
    overflow row S that is cut off."""
    t, k = slots.shape
    tok_ids = torch.arange(t, dtype=torch.int32, device=slots.device).repeat_interleave(k)
    slot_flat = torch.where(keep, slots.long(), ns).reshape(-1)
    pos_flat = torch.where(keep, pos.long(), 0).reshape(-1)
    table = torch.full((ns + 1, cap), t, dtype=torch.int32, device=slots.device)
    return table.index_put((slot_flat, pos_flat), tok_ids)[:ns]


def _combine(ye: torch.Tensor, row_idx: torch.Tensor, gates: torch.Tensor,
             dtype) -> torch.Tensor:
    """Each token's k rows of ``ye`` (n, C, d) gathered by ``row_idx``
    (T, k; n * C reads a zero row) and summed, gated, in f32 in selection
    order: a fixed order, where a scatter-add on the card is atomic and
    unordered."""
    d = ye.shape[-1]
    rows = torch.cat([ye.reshape(-1, d), ye.new_zeros(1, d)])
    picked = rows[row_idx].float()                                 # (T, k, d)
    g = gates.float()
    acc = picked[:, 0] * g[:, 0:1]
    for j in range(1, row_idx.shape[1]):
        acc = torch.addcmul(acc, picked[:, j], g[:, j:j + 1])
    return acc.to(dtype)


def moe_apply(params: dict, cfg: ModelConfig, x: torch.Tensor,
              placement: Optional[ExpertPlacement] = None,
              dispatch_mode: str = "dense", return_stats: bool = False):
    """x: (B, S, d).  Returns (y, aux): aux carries the router losses and,
    when return_stats, per-expert activation counts, per-token expert ids
    and the dropped fraction."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.moe_top_k
    xf = x.reshape(t, d)
    dev = x.device
    if placement is None:
        placement = ExpertPlacement.identity(e, device=dev)

    # imported here: the distributed package imports this module
    from repro_torch.distributed.context import current_ctx, sum_blocks
    ctx = current_ctx()
    blocks = ctx is not None and ctx.batch_blocks
    if blocks and dispatch_mode == "fused":
        raise ValueError("the fused dispatch numbers tokens within its call; under batch "
                         "blocks take 'dense' or 'gather'")
    n_all = t * ctx.dp if blocks else t                            # the global tokens

    if dispatch_mode not in ("dense", "gather", "fused"):
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
    with tracing.span("route"):
        logits = xf.float() @ params["w_router"]
        probs = router_probs(logits)                               # logical space
        ns = placement.num_slots                                   # S = E + R
        cap = _capacity(cfg, n_all)
        if dispatch_mode == "fused":
            gates, expert_ids, slot_idx, pos = route_replicated(
                logits, k, placement.replica_slots, placement.replica_count, ns)
            keep = pos < cap
        else:
            gates, expert_ids = top_k_gating(probs, k)             # (T,k) logical
            first = ctx.mesh.axis_index(ctx.batch_axes) * t if blocks else 0
            slot_idx = placement.dispatch_slots(expert_ids, first)  # physical slots
            pos, keep = _dispatch_tables(slot_idx, ns, cap)
            if blocks:
                # kept by the global rule; the expert FFN is row by row, so the
                # block's kept tokens take buffers of their own, at most t a slot
                keep = pos + _earlier_blocks(slot_idx, ns, ctx) < cap
                cap = min(cap, t)
        gates = gates.to(x.dtype)

    if dispatch_mode == "dense":
        with tracing.span("dispatch"):
            oh_e = _one_hot(slot_idx, ns, x.dtype) * keep[..., None]
            oh_c = _one_hot(pos, cap, x.dtype)
            dispatch = torch.einsum("tke,tkc->tec", oh_e, oh_c)
            combine = torch.einsum("tke,tkc,tk->tec", oh_e, oh_c, gates)
            xe = torch.einsum("tec,td->ecd", dispatch, xf)
        with tracing.span("experts"):
            ye = _expert_ffn(params, xe)
        with tracing.span("combine"):
            y = torch.einsum("tec,ecd->td", combine, ye)
    else:
        with tracing.span("dispatch"):
            table = _token_table(slot_idx, pos, keep, ns, cap)      # (S, C)
            valid = table < t
            src = table.clamp(max=t - 1).long()
            xe = torch.where(valid[..., None], xf[src], 0).to(x.dtype)
        with tracing.span("experts"):
            if dispatch_mode == "fused":
                ye = expert_ffn(params, xe)                        # 3x moe_gemm
            else:
                ye = _expert_ffn(params, xe)
        with tracing.span("combine"):
            # a dropped selection reads the zero row S*C
            row_idx = torch.where(keep, slot_idx.long() * cap + pos.long(), ns * cap)
            y = _combine(ye, row_idx, gates, x.dtype)

    if cfg.num_shared_experts > 0:
        with tracing.span("experts.shared"):
            y = y + ffn_apply(params["shared"], xf)

    aux = router_aux(probs, logits, expert_ids, k, ctx, return_stats)
    if return_stats:
        aux["expert_ids"] = expert_ids.reshape(b, s, k).to(torch.int32)
        aux["dropped_frac"] = 1.0 - (sum_blocks(keep.float().sum(), ctx) / (n_all * k)
                                     if blocks else keep.float().mean())
    return y.reshape(b, s, d), aux


def router_aux(probs: torch.Tensor, logits: torch.Tensor, expert_ids: torch.Tensor, k: int,
               ctx=None, counts: bool = False) -> dict:
    """The router losses (always f32), and with ``counts`` the per-expert
    selection counts, over the global tokens: under a context with batch
    blocks the probability sums, the counts and the squared
    log-normalizers are summed over the blocks (``context.sum_blocks``)
    before the products; otherwise means over this call's tokens."""
    from repro_torch.distributed.context import sum_blocks
    t, e = probs.shape
    ids_flat = expert_ids.reshape(-1).long()
    count = torch.zeros(e, dtype=torch.int32, device=probs.device).index_add(
        0, ids_flat, torch.ones_like(ids_flat, dtype=torch.int32))
    lse2 = torch.square(torch.logsumexp(logits, dim=-1))
    if ctx is not None and ctx.batch_blocks:
        # one all-reduce for the three sums, in f64 (the counts stay exact)
        n_all = t * ctx.dp
        sums = sum_blocks(torch.cat([probs.sum(0), torch.sum(lse2)[None],
                                     count.float()]).double(), ctx)
        me, z = (sums[:e] / n_all).float(), (sums[e] / n_all).float()
        count = sums[e + 1:].round().to(torch.int32)
    else:
        n_all = t
        me, z = probs.mean(0), torch.mean(lse2)
    aux = {"load_balance_loss": e * torch.sum(me * (count.float() / (n_all * k))),
           "router_z_loss": z}
    if counts:
        aux["expert_counts"] = count
    return aux


def _earlier_blocks(slot_idx: torch.Tensor, ns: int, ctx) -> torch.Tensor:
    """Under batch blocks: for each selection, the count of selections of
    its slot in the blocks before this rank's (the global order is block
    after block, each token-major)."""
    flat = slot_idx.reshape(-1).long()
    counts = torch.zeros(ns, dtype=torch.int32, device=flat.device).index_add(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    every = ctx.mesh.all_gather(counts[None], ctx.batch_axes, dim=0)     # (dp, S)
    before = every[:ctx.mesh.axis_index(ctx.batch_axes)].sum(0, dtype=torch.int32)
    return before[slot_idx.long()]


def permute_expert_weights(params: dict, old: ExpertPlacement,
                           new: ExpertPlacement) -> dict:
    """Relocate stacked expert weights from placement ``old`` to ``new``:
    each new slot gathers its expert's weights from that expert's primary
    slot under ``old`` (growing E -> E+R slots materializes the replicas)."""
    gather_idx = old.perm.long()[new.inv.long()]
    out = dict(params)
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = params[name][gather_idx]
    return out
