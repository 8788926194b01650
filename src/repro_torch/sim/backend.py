"""CostModelBackend: the analytic execution substrate behind SchedulerCore,
ported from ``repro.sim.backend`` (host-only; it touches no device).

The performance-plane twin of serving/backend.py::TorchBackend: no compute
happens — ``start``/``decode``/``release`` only exist so the core can drive
the same state machine — and time comes from the roofline cost model
(sim/costmodel.py) instead of a caller-owned logical clock.  Expert-level
coupling enters through the shared SyntheticExpertLevel's (moe_mult,
cross_frac) factors, the same numbers core/placement.py optimizes.

``charge_prefix_hits`` is True: vLLM's prefix cache IS the KV block pool, so
cached leading blocks reduce the chunked-prefill budget charge (the live
engine recomputes full prefills and charges full length — the one deliberate
backend asymmetry)."""
from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.types import Request
from repro_torch.sim.costmodel import CostModel


class CostModelBackend:
    charge_prefix_hits = True

    def __init__(self, cost: CostModel, expert_level, *,
                 max_running: int = 256, kv_pool_tokens: int = 0,
                 max_ctx_tokens: Optional[int] = None, kv_block_size: int = 1):
        self.cost = cost
        self.expert = expert_level          # shared across engines (EP-sharded)
        self.max_concurrency = max_running
        # 0 -> cost-model capacity estimate
        self.kv_capacity = kv_pool_tokens or cost.kv_capacity_tokens()
        # per-request resident-KV cap (None = the pool is the only KV
        # constraint).  Set it to the live engine's slot length when twinning
        # a TorchBackend so finish-at-cap decisions stay in parity.
        self.max_ctx_tokens = max_ctx_tokens
        # KV allocation granularity: > 1 switches SchedulerCore to distinct-
        # block accounting (set it to the paged TorchBackend's block size when
        # twinning one, so admission/preemption streams stay in parity)
        self.kv_block_size = kv_block_size
        # layered-prefill micro-step count (SchedulerCore reads it; both
        # planes derive it from the same ModelConfig, so pipelines agree)
        self.n_layers = cost.cfg.num_layers

    # ------------------------------------------------------------------ Backend protocol
    def start(self, r: Request, now: float
              ) -> Tuple[None, Optional[np.ndarray]]:
        return None, None                   # nothing physical to prefill

    def decode(self, active: Sequence[Tuple[None, Request]], now: float
               ) -> Tuple[Set[int], Optional[np.ndarray]]:
        return set(), None                  # no real logits -> no EOS signal

    def release(self, handle: None, r: Request) -> None:
        pass

    def apply_placement(self, new_perm: np.ndarray) -> None:
        pass    # no weights to move; SyntheticExpertLevel re-derives factors

    def step_time(self, now: float, prefill_tokens: int, decode_batch: int,
                  avg_ctx: float, queue_len: int,
                  layer_jobs: Optional[List[int]] = None) -> float:
        e = self.cost.cfg.num_experts if self.cost.cfg.is_moe else 1
        rep = getattr(self.expert, "num_slots", e) / max(e, 1)
        t = self.cost.iteration_time(
            prefill_tokens, decode_batch, avg_ctx,
            self.expert.moe_mult, self.expert.cross_frac, queue_len=queue_len,
            rep_factor=rep)
        if layer_jobs:
            # layered prefill: each in-flight request advances ONE layer —
            # the per-layer slice of the fused charge, so n_layers micro-
            # steps sum to exactly what one chunked iteration charged
            t += sum(self.cost.prefill_layer_time(
                n, self.expert.moe_mult, self.expert.cross_frac)
                for n in layer_jobs)
        return now + t

    def transfer_time(self, kv_tokens: int) -> float:
        """Disaggregated hand-off cost: move ``kv_tokens`` of KV pages over
        the interconnect (CostModel.migration_time semantics)."""
        return self.cost.migration_time(kv_tokens * self.cost.kv_bytes_tok)

    def est_iter_time(self, prefill_tokens: int, decode_batch: int,
                      avg_ctx: float, queue_len: int) -> float:
        """Admission-control hint: a STATIC estimate (moe_mult/cross_frac at
        their placement-neutral defaults, no replication blow-up), so the
        shed decision depends only on queue state + the calibrated model —
        never on live expert-level state, which the serving twin cannot see.
        That keeps SLO-aware shedding differential-parity-testable."""
        return self.cost.iteration_time(prefill_tokens, decode_batch,
                                        avg_ctx, queue_len=queue_len)

    def kv_usage(self, kv_tokens: int) -> float:
        return min(kv_tokens / self.kv_capacity, 1.0)
