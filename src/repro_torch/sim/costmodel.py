"""Analytic per-iteration cost model for the discrete-event simulator,
ported from ``repro.sim.costmodel`` with the reference's hardware profiles.

Latency terms are derived from the same roofline constants as §Roofline
(compute, HBM, interconnect), per hardware profile.  The MoE-specific knobs —
hotspot multiplier and cross-device dispatch fraction — are where the paper's
expert level changes the numbers: a placement that balances activation load
drives the multiplier toward 1.0, and affinity co-location drives the
cross-traffic fraction down (§III-D).
"""
from __future__ import annotations

import dataclasses

# the coupling-factor computation lives with the placement math in
# core/placement.py; re-exported here because the cost model is its consumer
from repro_torch.core.placement import placement_coupling  # noqa: F401
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # bf16 FLOP/s per device
    hbm_bw: float              # bytes/s per device
    link_bw: float             # bytes/s interconnect per device (one direction)
    mem_bytes: float           # HBM capacity per device
    flops_eff: float = 0.45    # achievable MFU for big matmuls
    bw_eff: float = 0.70
    step_overhead: float = 0.004   # scheduler + dispatch per engine iteration (s)
    # vLLM-style per-iteration scheduler cost scaling with queue state (the
    # Python block-table / batching bookkeeping grows with running+waiting
    # sequences); this is the mechanism by which shorter queues (SJF/DPLB)
    # lower TPOT, not just TTFT (paper Figs. 8-9)
    sched_overhead_per_seq: float = 60e-6


# the paper's testbed (per A100-80GB, NVLink)
A100 = HardwareProfile("a100", peak_flops=312e12, hbm_bw=2.0e12,
                       link_bw=300e9, mem_bytes=80e9)
# the reference's TPU target (per v5e chip, ICI), kept so that simulated
# results equal the reference's; no port figure comes from either profile
V5E = HardwareProfile("v5e", peak_flops=197e12, hbm_bw=819e9,
                      link_bw=50e9, mem_bytes=16e9)

PROFILES = {"a100": A100, "v5e": V5E}


class CostModel:
    """Per-engine iteration times.  Topology matches the paper: each DP engine
    owns one device; MoE experts are EP-sharded across all `g` devices, so
    expert imbalance couples engines (§V-A.1)."""

    def __init__(self, cfg: ModelConfig, hw: HardwareProfile, g: int,
                 block_size: int = 1):
        self.cfg = cfg
        self.hw = hw
        self.g = max(g, 1)
        # paged-KV allocation granularity: decode reads whole blocks, so with
        # block_size > 1 the per-sequence context rounds UP to a block
        # multiple in the memory term (the paging overhead the slot layout
        # avoids by construction; 1 = exact-token reads, the historical model)
        self.block_size = max(block_size, 1)
        itemsize = 2  # bf16 serving
        self.active_params = cfg.active_params()
        self.total_params = cfg.total_params()
        # split weights into expert vs non-expert bytes
        if cfg.is_moe:
            n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
            self.expert_bytes = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts * n_moe * itemsize
            self.n_moe_layers = n_moe
            expert_active = 3 * cfg.d_model * cfg.moe_d_ff * cfg.moe_top_k * n_moe
            self.expert_flop_frac = min(expert_active / max(self.active_params, 1), 0.95)
        else:
            self.expert_bytes = 0
            self.n_moe_layers = 0
            self.expert_flop_frac = 0.0
        self.nonexpert_bytes = self.total_params * itemsize - self.expert_bytes
        self.kv_bytes_tok = cfg.kv_bytes_per_token()

    # ------------------------------------------------------------------ pieces
    def _expert_eff(self, tokens: int) -> float:
        """Skinny-GEMM efficiency of expert compute: with T tokens routed
        top-k over E experts, each expert sees ~T*k/E rows; below ~128 rows
        the MXU/SMs run far under peak (the reason MoE serving is slow on
        real hardware and why the paper's expert level matters)."""
        if not self.cfg.is_moe or tokens <= 0:
            return 1.0
        rows = tokens * self.cfg.moe_top_k / max(self.cfg.num_experts, 1)
        return min(1.0, max(rows / 128.0, 0.02))

    def _compute_time(self, flops: float, moe_mult: float,
                      tokens: int = 0) -> float:
        eff = self.hw.peak_flops * self.hw.flops_eff
        dense = flops * (1.0 - self.expert_flop_frac) / eff
        expert = flops * self.expert_flop_frac * moe_mult \
            / (eff * self._expert_eff(tokens))
        return dense + expert

    def _a2a_time(self, tokens: int, cross_frac: float) -> float:
        """MoE all-to-all: tokens*d bf16 out and back per MoE layer; only the
        cross-device fraction pays interconnect."""
        if self.n_moe_layers == 0 or tokens == 0:
            return 0.0
        byts = 2 * tokens * self.cfg.d_model * 2 * self.n_moe_layers * cross_frac
        return byts / (self.hw.link_bw * self.hw.bw_eff)

    # ------------------------------------------------------------------ phases
    def prefill_time(self, tokens: int, moe_mult: float = 1.0,
                     cross_frac: float = 0.5) -> float:
        """Compute-bound phase (paper §VI: 'prefill phases are compute-bound')."""
        if tokens <= 0:
            return 0.0
        lin = 2.0 * self.active_params * tokens
        attn = 2.0 * tokens * tokens * self.cfg.d_model * self.cfg.num_attention_layers() \
            / max(self.cfg.num_layers, 1)  # causal-halved quadratic term
        t_comp = self._compute_time(lin + attn, moe_mult, tokens)
        t_mem = (tokens * self.kv_bytes_tok) / (self.hw.hbm_bw * self.hw.bw_eff)
        return max(t_comp, t_mem) + self._a2a_time(tokens, cross_frac)

    def prefill_layer_time(self, tokens: int, moe_mult: float = 1.0,
                           cross_frac: float = 0.5) -> float:
        """ONE layer's slice of ``prefill_time`` — the unit of work a
        layered-prefill micro-step charges (paper family: "From Tokens to
        Layers" interleaves prefill with decode at layer boundaries, so
        decode stalls for one layer, not one chunk).

        Per-layer split of the fused formula: the linear FLOPs
        (2·active_params·tokens) and the causal-quadratic attention term are
        uniform across layers; the KV-write HBM term is one layer's share of
        ``kv_bytes_tok``; A2A is averaged over layers (MoE layers pay it,
        dense layers don't — the scheduler charges uniform micro-steps).
        Every term is its fused total over ``num_layers``, so by construction

            num_layers * prefill_layer_time(T) == prefill_time(T)

        — n layered micro-steps charge exactly what one fused chunk does;
        the win is that decode interleaves at every boundary."""
        if tokens <= 0:
            return 0.0
        n = max(self.cfg.num_layers, 1)
        lin = 2.0 * self.active_params * tokens / n
        attn = 2.0 * tokens * tokens * self.cfg.d_model \
            * self.cfg.num_attention_layers() / max(self.cfg.num_layers, 1) / n
        t_comp = self._compute_time(lin + attn, moe_mult, tokens)
        t_mem = (tokens * self.kv_bytes_tok / n) / (self.hw.hbm_bw * self.hw.bw_eff)
        return max(t_comp, t_mem) + self._a2a_time(tokens, cross_frac) / n

    def decode_time(self, batch: int, avg_ctx: float, moe_mult: float = 1.0,
                    cross_frac: float = 0.5, rep_factor: float = 1.0) -> float:
        """Memory-bound phase: weights resident on this device + KV reads.
        ``rep_factor`` = S/E, the replicated-placement weight blow-up: each
        device holds S/g expert slots instead of E/g."""
        if batch <= 0:
            return 0.0
        weight_bytes = self.nonexpert_bytes \
            + (self.expert_bytes * rep_factor / self.g) * moe_mult
        if self.block_size > 1:     # paged reads are block-granular
            avg_ctx = -(-avg_ctx // self.block_size) * self.block_size
        kv = batch * avg_ctx * self.kv_bytes_tok
        t_mem = (weight_bytes + kv) / (self.hw.hbm_bw * self.hw.bw_eff)
        t_comp = self._compute_time(2.0 * self.active_params * batch, moe_mult, batch)
        return max(t_mem, t_comp) + self._a2a_time(batch, cross_frac)

    def iteration_time(self, prefill_tokens: int, decode_batch: int, avg_ctx: float,
                       moe_mult: float = 1.0, cross_frac: float = 0.5,
                       queue_len: int = 0, rep_factor: float = 1.0) -> float:
        return (self.hw.step_overhead
                + self.hw.sched_overhead_per_seq * (decode_batch + queue_len)
                + self.prefill_time(prefill_tokens, moe_mult, cross_frac)
                + self.decode_time(decode_batch, avg_ctx, moe_mult, cross_frac,
                                   rep_factor))

    def migration_time(self, bytes_moved: int) -> float:
        return bytes_moved / (self.hw.link_bw * self.hw.bw_eff)

    # ------------------------------------------------------------------ capacity
    def kv_capacity_tokens(self, headroom: float = 0.9) -> int:
        """Token capacity of one engine's KV pool after weights."""
        weights_here = self.nonexpert_bytes + self.expert_bytes / self.g
        free = self.hw.mem_bytes * headroom - weights_here
        return max(int(free / max(self.kv_bytes_tok, 1)), 1024)
