"""Port copy of ``repro.core.types``: host-side Python with no framework in it,
kept line for line so both packages make byte-identical decisions.

Shared datatypes for the Gimbal scheduling stack."""
from __future__ import annotations

import dataclasses
from typing import Optional

# Priority classes, ordered most- to least-urgent.  Rank 0 (interactive)
# may preempt rank 1 (batch) when GimbalConfig.enable_preemption is set.
PRIORITY_CLASSES = ("interactive", "batch")


def class_rank(priority_class: str) -> int:
    """Smaller rank == more urgent.  Unknown classes sort after known ones."""
    try:
        return PRIORITY_CLASSES.index(priority_class)
    except ValueError:
        return len(PRIORITY_CLASSES)


@dataclasses.dataclass
class Request:
    """A serving request as seen by every scheduling level."""
    req_id: int
    prompt_len: int                  # prefill token count == Alg.2's priority key
    max_new_tokens: int
    arrival_time: float
    user_id: Optional[str] = None    # enables Alg.1 user affinity
    prompt_tokens: Optional[object] = None  # actual tokens (functional plane only)
    priority_class: str = "batch"    # see PRIORITY_CLASSES
    tenant: str = "default"          # multi-tenant workload label
    # per-request SLO deadlines (None = no target on that axis)
    slo_ttft: Optional[float] = None     # seconds to first token
    slo_tpot: Optional[float] = None     # seconds per output token (mean)

    # lifecycle (filled in by the engine / simulator)
    engine_id: Optional[int] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    generated: int = 0
    priority: float = 0.0
    aged: bool = False
    preempted: int = 0               # times this request lost its decode slot
    wasted_tokens: int = 0           # generated tokens discarded by preemption
    hedged_at: Optional[float] = None  # last hedged re-dispatch time
    hedges: int = 0                  # times this request was hedged
    # fault-tolerance lifecycle (serving/cluster.py + sim/simulator.py drills)
    shed_time: Optional[float] = None  # rejected by SLO-aware admission control
    kv_migrated: bool = False        # KV pages travelled with the re-route:
    #                                  progress survives, no re-prefill charge
    reroutes: int = 0                # times re-dispatched off a failed/removed engine

    @property
    def rank(self) -> int:
        return class_rank(self.priority_class)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Mean per-output-token latency excluding the first token (paper metric)."""
        if self.finish_time is None or self.first_token_time is None or self.generated <= 1:
            return None
        return (self.finish_time - self.first_token_time) / (self.generated - 1)

    @property
    def has_slo(self) -> bool:
        return self.slo_ttft is not None or self.slo_tpot is not None

    @property
    def was_shed(self) -> bool:
        """Rejected by SLO-aware admission control (never served)."""
        return self.shed_time is not None and self.finish_time is None

    @property
    def slo_met(self) -> Optional[bool]:
        """Did this request hit its deadlines?  ``None`` until finished.
        A request with no targets vacuously meets its SLO (goodput ==
        throughput for SLO-less traffic); a single-token output has no TPOT
        and can only miss on TTFT."""
        if self.finish_time is None:
            return None
        if self.slo_ttft is not None:
            if self.ttft is None or self.ttft > self.slo_ttft:
                return False
        if self.slo_tpot is not None:
            t = self.tpot
            if t is not None and t > self.slo_tpot:
                return False
        return True


@dataclasses.dataclass
class EngineMetrics:
    """Per-engine metrics the DP load balancer consumes (Alg. 1 inputs).

    Delivered asynchronously in the paper (ZeroMQ) — carries a timestamp so
    the balancer can model staleness; `available` mirrors Alg. 1 line 2.
    """
    engine_id: int
    kv_usage: float = 0.0            # fraction of KV capacity in use, in [0,1]
    running_load: int = 0            # running + waiting TOKENS (not request count)
    num_running: int = 0
    num_waiting: int = 0
    timestamp: float = 0.0
    healthy: bool = True
    num_hedged: int = 0              # requests hedged AWAY from this engine

    @property
    def available(self) -> bool:
        return self.healthy


@dataclasses.dataclass(frozen=True)
class GimbalConfig:
    """All paper thresholds, with the paper's §V.A.2 defaults."""
    theta_kv: float = 0.90           # KV saturation threshold
    theta_diff: float = 0.10         # cross-engine KV imbalance tolerance
    theta_load: int = 3000           # running-load gap (tokens) ~ one large BurstGPT request
    theta_age: float = 5.0           # seconds; < P99 TTFT under 1.4 RPS load
    tau: int = 3000                  # expert replacement period (steps)
    affinity_ttl: float = 300.0      # user->engine mapping expiry (seconds)
    metric_staleness: float = 1.0    # metrics older than this count as unavailable
    # module switches (the paper's ablations: DPLB / SJFS / EDR / Gimbal)
    enable_dplb: bool = True
    enable_sjf: bool = True
    enable_edr: bool = True
    # hot-expert replication ("gimbal+rep"): number of redundant expert slots
    # (None = one per device; E+R must divide the device count)
    redundancy: Optional[int] = None
    # straggler mitigation (beyond-paper, required for 1000+ node runs)
    hedge_threshold: float = 0.0     # >0: re-dispatch if queued longer than this
    # preemptive priority scheduling (beyond-paper, mixed-tenant workloads)
    enable_preemption: bool = False  # interactive may evict running batch work
    victim_policy: str = "fewest_tokens"  # fewest_tokens | lowest_class | lru_slot
    max_preemptions: int = 3         # per-request eviction cap (livelock guard)
    # SLO-aware admission control / load shedding (beyond-paper, flash-crowd
    # robustness): reject (or down-class) a request at submit when its TTFT
    # deadline is already unmeetable given queue depth × the cost model
    # (SchedulerCore.estimate_ttft).  Shed requests count as SLO misses, so
    # shedding only wins by letting the survivors actually meet theirs.
    enable_shedding: bool = False
    shed_slack: float = 1.0          # shed when est TTFT > slack × remaining budget
    shed_mode: str = "reject"        # "reject" | "downclass" (demote to lowest class)
    # output-length prediction (beyond-paper, SRPT-style request scheduling):
    # a core/predictor.py spec — "oracle" | "noisy:<sigma>" |
    # "histogram[:<alpha>]" — or None for the paper's prefill-keyed Alg. 2.
    # With a predictor set, SJF ranks by predicted REMAINING tokens,
    # victim_policy="largest_remaining" becomes available, and estimate_ttft
    # counts only the backlog ranked ahead of the candidate (so shed_slack
    # can sit at 1.0 instead of compensating for over-conservatism).
    predictor: Optional[str] = None
    predictor_seed: int = 0          # noisy-oracle draw seed (shared by planes)
