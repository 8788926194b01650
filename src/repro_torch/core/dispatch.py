"""Engine-level scored dispatch: one policy core shared by serving and sim.

The paper's §IV-B engine level dispatches on "current prefix-token load,
KV-cache utilization and user stickiness".  Algorithm 1 (core/router.py)
realises that as a branch ladder; this module realises it as a weighted
score so the individual signals become ablatable dispatch variants
(core/gimbal.py registers them alongside "gimbal"/"rr"):

    score(e) =  w_prefix * matched_prefix(e) / prompt_len
             +  w_kv     * (1 - kv_usage(e))
             +  w_queue  * 1 / (1 + load(e) / theta_load)
             +  w_sticky * [e is the user's fresh sticky engine
                            and kv_usage(e) < theta_kv]

where ``matched_prefix`` comes from the cluster-wide ``PrefixDirectory``,
``kv_usage``/``load`` from the SchedulerCore-built ``EngineMetrics`` on the
MetricsBus (load includes the router's optimistic in-flight tokens so
same-snapshot arrivals don't herd), and stickiness from the engine the user
last landed on — suppressed under KV pressure, per Algorithm 1 line 15.
The argmax breaks ties toward the lowest engine id, which makes the
decision permutation-invariant over the engine-id ordering.

``DispatchCore`` is to the engine level what ``SchedulerCore`` is to the
request level: ONE state machine (router + directory + assignment log) that
``serving/cluster.py`` and ``sim/simulator.py`` both drive, so the
engine-assignment stream is differential-parity-testable the same way the
admit/preempt/finish stream is (tests/test_scheduler_parity.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.prefix_directory import PrefixDirectory
from repro_torch.core.router import GimbalRouter
from repro_torch.core.types import EngineMetrics, GimbalConfig, Request


@dataclass(frozen=True)
class DispatchWeights:
    """Signal weights for the scored router; zero disables a signal."""
    w_prefix: float = 0.0
    w_kv: float = 0.0
    w_queue: float = 0.0
    w_sticky: float = 0.0


# The single-signal variants isolate one term each (their score ladders are
# the ablation axis); "combined" weights prefix reuse highest — recomputing
# a long prefill dominates the cost of a mildly imbalanced dispatch — with
# stickiness just below so a fresh sticky engine wins any tie the directory
# can't break, and KV/queue headroom as pressure valves.
DISPATCH_WEIGHTS: Dict[str, DispatchWeights] = {
    "prefix": DispatchWeights(w_prefix=1.0, w_queue=0.05),
    "kv": DispatchWeights(w_kv=1.0, w_queue=0.25),
    "sticky": DispatchWeights(w_sticky=1.0, w_queue=0.1),
    "combined": DispatchWeights(w_prefix=1.0, w_kv=0.25, w_queue=0.25,
                                w_sticky=0.75),
}


class ScoredRouter(GimbalRouter):
    """Weighted-score dispatch over healthy engines (argmax of ``score``).

    Subclasses GimbalRouter for its metric-freshness filter, optimistic
    in-flight accounting, sticky user map and hedge_target — only the
    selection rule changes from Algorithm 1's branch ladder to the score."""

    def __init__(self, engine_ids: Sequence[int],
                 cfg: Optional[GimbalConfig] = None, *,
                 directory: Optional[PrefixDirectory] = None,
                 weights: Optional[DispatchWeights] = None):
        super().__init__(engine_ids, cfg)
        self.directory = directory
        self.weights = weights or DISPATCH_WEIGHTS["combined"]

    def score(self, request: Request, engine_id: int, m: EngineMetrics,
              held_tokens: int, sticky_engine: Optional[int]) -> float:
        w = self.weights
        s = 0.0
        if w.w_prefix:
            s += w.w_prefix * min(held_tokens / max(request.prompt_len, 1), 1.0)
        if w.w_kv:
            s += w.w_kv * (1.0 - min(max(m.kv_usage, 0.0), 1.0))
        if w.w_queue:
            load = m.running_load + self._inflight_tokens(engine_id, m.timestamp)
            s += w.w_queue / (1.0 + load / max(self.cfg.theta_load, 1))
        if w.w_sticky and engine_id == sticky_engine \
                and m.kv_usage < self.cfg.theta_kv:
            s += w.w_sticky
        return s

    def select(self, request: Request, metrics: Dict[int, EngineMetrics],
               now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        pool = self._role_pool(request)
        healthy = [e for e in pool
                   if metrics.get(e, EngineMetrics(e)).healthy] or pool

        fresh = {m.engine_id: m for m in self._fresh_metrics(metrics, now)}
        held: Dict[int, int] = {}
        if self.directory is not None and request.prompt_tokens is not None:
            held = self.directory.longest_prefix(request.prompt_tokens)
        sticky_engine = None
        if request.user_id is not None:
            hit = self.user_engine_map.get(request.user_id)
            if hit is not None:
                eng, ts = hit
                if now - ts <= self.cfg.affinity_ttl and eng in healthy:
                    sticky_engine = eng

        # argmax, ties to the lowest engine id: the winner depends only on
        # the (id, score) set, never on the order engines were registered
        best, best_key = healthy[0], None
        for e in healthy:
            m = fresh.get(e, EngineMetrics(e))
            key = (self.score(request, e, m, held.get(e, 0), sticky_engine), -e)
            if best_key is None or key > best_key:
                best, best_key = e, key

        if request.user_id is not None:
            self.user_engine_map[request.user_id] = (best, now)
        self._note_dispatch(best, request.prompt_len, now)
        return best


class DispatchCore:
    """The shared engine-level dispatch state machine.

    Owns the variant's router, the cluster-wide PrefixDirectory, and the
    engine-assignment log — the dispatch layer's parity oracle: driving the
    same trace through the serving Cluster and the simulator must produce
    byte-identical ``assignments`` streams."""

    def __init__(self, variant: str, engine_ids: Sequence[int],
                 cfg: Optional[GimbalConfig] = None, block_size: int = 16):
        # late import: gimbal imports ScoredRouter from this module
        from repro_torch.core.gimbal import make_router
        self.variant = variant
        self.cfg = cfg or GimbalConfig()
        self.directory = PrefixDirectory(block_size=block_size)
        self.router = make_router(variant, engine_ids, self.cfg,
                                  directory=self.directory)
        # disaggregated prefill/decode roles, shared INTO the router's role
        # map: fresh requests dispatch to prefill/unified engines, KV-
        # migrated hand-offs to decode/unified ones (core/router.py
        # _role_pool).  Empty / all-"unified" = historical behavior.
        self.roles: Dict[int, str] = self.router.roles
        self.assignments: List[Tuple[int, int]] = []
        # (kind, engine_id) membership-change stream in decision order — the
        # lifecycle parity oracle: a fault drill driven through the serving
        # Cluster and through the simulator must produce byte-identical
        # streams (timestamps deliberately excluded, like SchedEvent)
        self.lifecycle: List[Tuple[str, int]] = []

    # --- engine lifecycle ---------------------------------------------------

    def note_lifecycle(self, kind: str, engine_id: int) -> None:
        """Append a membership/detection event to the lifecycle stream (the
        cluster logs auto-detections here so the parity oracle covers the
        HealthMonitor's decisions, not just their consequences)."""
        self.lifecycle.append((kind, engine_id))

    def attach_engine(self, engine_id: int, prefix_cache=None,
                      role: Optional[str] = None) -> None:
        if engine_id not in self.router.engine_ids:
            self.router.add_engine(engine_id)
            self.note_lifecycle("attach", engine_id)
        if role is not None:
            if role not in ("prefill", "decode", "unified"):
                raise ValueError(f"unknown engine role {role!r}")
            self.roles[engine_id] = role
        if prefix_cache is not None:
            self.directory.attach(engine_id, prefix_cache)

    def on_engine_failed(self, engine_id: int, kv: str = "lost") -> None:
        """Failure invalidation: stop routing there AND forget its prefixes
        (the node's memory is gone; orphans must not chase stale entries).
        ``kv`` records how the orphans' KV is handled — "lost" (crash:
        re-prefill from scratch) vs "migrated" (orchestrated failover: pages
        travel with the re-route) — purely for the lifecycle stream; the
        KV semantics themselves live in SchedulerCore.drain(migrate=...)."""
        self.router.remove_engine(engine_id)
        self.directory.purge_engine(engine_id)
        self.note_lifecycle(f"fail:{kv}", engine_id)

    def on_engine_restored(self, engine_id: int) -> None:
        if engine_id not in self.router.engine_ids:
            self.router.add_engine(engine_id)
            self.note_lifecycle("restore", engine_id)

    def on_engine_removed(self, engine_id: int) -> None:
        """Graceful scale-in: stop routing there and forget its prefixes.
        Unlike a failure the drain is orchestrated (KV migrates), but the
        directory treatment is identical — the node's cache is going away."""
        self.router.remove_engine(engine_id)
        self.directory.purge_engine(engine_id)
        self.note_lifecycle("remove", engine_id)

    # --- the decision stream ------------------------------------------------

    def dispatch(self, request: Request, metrics: Dict[int, EngineMetrics],
                 now: float) -> int:
        eid = self.router.select(request, metrics, now)
        request.engine_id = eid
        self.assignments.append((request.req_id, eid))
        return eid

    def record_hedge(self, request: Request, target: int) -> None:
        """A hedged move IS an engine-assignment decision: log it so the
        parity oracle covers hedging too.  The directory needs no explicit
        update — re-submitting on the target inserts the prompt's blocks
        into the target's cache, which advertises them via its attach hook
        before the next dispatch consults the directory."""
        self.assignments.append((request.req_id, target))

    def assignment_log(self) -> List[Tuple[int, int]]:
        return list(self.assignments)

    def lifecycle_log(self) -> List[Tuple[str, int]]:
        return list(self.lifecycle)
