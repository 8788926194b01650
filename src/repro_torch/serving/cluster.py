"""The DP serving cluster: Gimbal router + N engines + fault tolerance.

Maps the paper's Figure 2 topology: a global request pool feeds the DP Engine
Load Balancer, which dispatches to engine replicas; each engine runs its own
SJF scheduler and (for MoE archs) Expert Dynamic Replacement.

Fault tolerance / elasticity (beyond-paper, required at 1000+ node scale) —
the engine-lifecycle API every fault drill (distributed/drill.py) drives:
  * auto-detection: with ``health=HealthConfig(...)`` the cluster owns a
    HealthMonitor fed from the SAME MetricsBus the balancer reads (a metric
    snapshot IS the heartbeat) — a silently-dead engine is detected by
    missed heartbeats and auto-failed, no manual fail_engine() call;
  * fail_engine(kv="lost"): crash semantics — orphans are drained and
    re-routed, re-prefilling elsewhere; kv="migrated" is the orchestrated
    failover: KV pages travel with the re-route, progress survives;
  * add_engine()/remove_engine(): elastic pool resize registered everywhere
    it matters (router candidate set, PrefixDirectory, MetricsBus,
    HealthMonitor); removal drains gracefully (KV migrated), additions can
    charge an expert-placement warm-up delay before serving;
  * autoscaling: with ``elastic=ElasticPolicy(...)`` + ``engine_factory``,
    the cluster resizes itself from live queue pressure (dead/stale engines
    filtered out of the signal);
  * SLO-aware shedding: with GimbalConfig.enable_shedding, engines reject
    requests whose TTFT deadline is already unmeetable (SchedulerCore);
    ``shed_requests()``/reports count them as SLO misses;
  * hedged dispatch: with GimbalConfig.hedge_threshold > 0, requests stuck in
    a queue past the threshold are re-dispatched to the least-loaded engine.

Every membership change lands in ``DispatchCore.lifecycle_log()`` — with the
assignment log, the fault-drill parity oracle between this plane and
sim/simulator.py (tests/test_scheduler_parity.py).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.dispatch import DispatchCore
from repro_torch.core.slo import SLOTracker
from repro_torch.core.types import GimbalConfig, Request
from repro_torch.distributed.fault import ElasticPolicy, HealthConfig, HealthMonitor
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import (MetricsBus, summarize, summarize_by_class,
                                   summarize_by_tenant)


class Cluster:
    def __init__(self, engines: Sequence[Engine], variant: str = "gimbal",
                 gimbal_cfg: Optional[GimbalConfig] = None, bus_delay: float = 0.05,
                 expert_level=None, dispatch_core: Optional[DispatchCore] = None,
                 health: Optional[HealthConfig] = None,
                 elastic: Optional[ElasticPolicy] = None,
                 engine_factory: Optional[Callable[[int], Engine]] = None,
                 warmup_s: float = 0.0):
        """``expert_level``: the ONE ClusterExpertLevel every engine was built
        with (core/gimbal.make_cluster_expert_level) — the cluster owns the
        cluster-wide expert telemetry and exposes its RebalanceEvent stream /
        coupling factors via ``expert_report()``.  When omitted, falls back
        to the first engine's level (which is only cluster-wide if the caller
        shared it across engines).

        ``dispatch_core``: the engine-level dispatch state machine (router +
        cluster-wide PrefixDirectory + assignment + lifecycle logs).  Built
        from ``variant`` when omitted; pass one in to share or inspect it.

        ``health``: enable heartbeat failure detection over the metrics bus;
        ``step()`` then auto-fails silently-dead engines (KV lost).
        ``elastic`` + ``engine_factory``: enable autoscaling — the policy
        decides from live bus pressure, the factory builds engines for fresh
        ids on scale-out, ``remove_engine`` drains the least-loaded on
        scale-in.  ``warmup_s``: expert-placement warm-up charged to every
        added engine (it heartbeats but serves nothing until ready —
        derive it from CostModel.migration_time over the weight bytes)."""
        self.gcfg = gimbal_cfg or GimbalConfig()
        self.engines: Dict[int, Engine] = {e.engine_id: e for e in engines}
        self.dispatch = dispatch_core or DispatchCore(
            variant, list(self.engines), self.gcfg)
        for e in engines:
            self.dispatch.attach_engine(e.engine_id, getattr(e, "prefix", None),
                                        role=getattr(e, "role", "unified"))
        self.router = self.dispatch.router
        self.bus = MetricsBus(delay=bus_delay)
        self.finished: List[Request] = []
        self.variant = variant
        self.expert_level = expert_level if expert_level is not None else next(
            (e.core.expert for e in engines if e.core.expert is not None), None)
        # --- lifecycle state (fault drills / elasticity) ---
        self.monitor = (HealthMonitor(list(self.engines), health)
                        if health is not None else None)
        self.elastic = elastic
        self.engine_factory = engine_factory
        self.warmup_s = warmup_s
        self.retired: List[Engine] = []     # gracefully removed; accounting kept
        self.rerouted = 0                   # orphan re-dispatches (fail + remove)
        self.fault_log: List[Dict] = []     # timed fail/remove records (telemetry)
        # --- disaggregated prefill/decode hand-off state ---
        # requests whose KV pages are on the wire: (ready_time, request,
        # src engine).  Collected by poll_handoffs off prefill-role engines
        # the step their prefill finishes; delivered (re-dispatched, which
        # re-advertises their prefix blocks at the destination) on the first
        # poll at or after ready_time — always a LATER poll than collection,
        # so delivery steps are plane-deterministic whenever the transfer
        # cost is below the driving step width.
        self._in_transfer: List[tuple] = []
        # (req_id, src_engine, dst_engine) in delivery order — the KV-
        # transfer parity oracle (timestamps deliberately excluded); the
        # transfer COST stays on the clock via ready_time/kv_transfer_s
        self.kv_transfers: List[tuple] = []
        self.kv_transfer_s = 0.0            # total seconds of KV on the wire
        self._ready_at: Dict[int, float] = {}
        self._next_engine_id = max(self.engines, default=-1) + 1

    # ------------------------------------------------------------------ dispatch
    def submit(self, r: Request, now: float) -> int:
        metrics = self.bus.snapshot(now)
        eid = self.dispatch.dispatch(r, metrics, now)
        self.engines[eid].submit(r, now)
        return eid

    # ------------------------------------------------------------------ execution
    def step(self, now: float) -> List[Request]:
        done: List[Request] = []
        for e in list(self.engines.values()):
            if not e.healthy:
                continue
            if now < self._ready_at.get(e.engine_id, now):
                # warm-up: the engine is alive (heartbeats flow, it can be
                # dispatched to and queue work) but serves nothing until its
                # expert placement has been materialised
                self.bus.publish(e.metrics(now))
                continue
            done.extend(e.step(now))
            self.bus.publish(e.metrics(now))
        self.poll_handoffs(now)
        self._maybe_hedge(now)
        self.health_check(now)
        self.autoscale(now)
        self.finished.extend(done)
        return done

    def run_until_drained(self, t0: float = 0.0, dt: float = 0.01,
                          max_steps: int = 100_000,
                          on_step: Optional[Callable[["Cluster", float], None]]
                          = None) -> List[Request]:
        """Step until EVERY engine — healthy or not — is empty.  Unhealthy
        engines' queues count: requests stranded on a failed-then-restored
        engine must not be silently dropped from the finished set (they only
        stop counting once ``fail_engine`` has drained and re-routed them).
        ``on_step(cluster, now)`` runs after each step — fault-injection
        drills (restore an engine mid-drain) hook in here."""
        now = t0
        for _ in range(max_steps):
            self.step(now)
            if on_step is not None:
                on_step(self, now)
            now += dt
            if (not self._in_transfer
                    and all(e.num_active() == 0 and len(e.queue) == 0
                            for e in self.engines.values())):
                break
        return self.finished

    # ---------------------------------------------------- prefill/decode hand-off
    def poll_handoffs(self, now: float) -> int:
        """Disaggregated prefill→decode KV hand-off, both directions of the
        wire.  (1) Deliver every transfer whose ready_time has passed: the
        request is re-dispatched (role-aware router sends KV-migrated work to
        decode/unified engines; re-submitting advertises its prefix blocks in
        the directory at the destination).  (2) Collect finished-prefill
        requests off prefill-role engines via SchedulerCore.pop_handoff —
        the migrated-KV semantics of drain(migrate=True), with the transfer cost on the clock
        (backend.transfer_time over the resident KV tokens).  Returns the
        number of requests delivered this poll."""
        delivered = 0
        for t in [t for t in self._in_transfer if t[0] <= now]:
            self._in_transfer.remove(t)
            _, r, src = t
            r.reroutes += 1
            dst = self.submit(r, now)
            self.kv_transfers.append((r.req_id, src, dst))
            delivered += 1
        for e in self.engines.values():
            if getattr(e, "role", "unified") != "prefill" or not e.healthy:
                continue
            core = e.core
            # generated <= 1: exactly the first (prefill-emitted) token —
            # a request that already decoded here (degraded fallback when no
            # decode engine was available) is never bounced a second time
            ready = [seq.r for seq in core.running
                     if seq.r.first_token_time is not None
                     and seq.r.generated <= 1]
            for r in ready:
                ctx = core.ctx_tokens.get(r.req_id,
                                          r.prompt_len + r.generated)
                popped = core.pop_handoff(r.req_id)
                if popped is None:
                    continue
                tt = getattr(getattr(e, "backend", None), "transfer_time",
                             None)
                dt_x = tt(ctx) if tt is not None else 0.0
                self.kv_transfer_s += dt_x
                self._in_transfer.append((now + dt_x, popped, e.engine_id))
        return delivered

    def next_transfer_time(self) -> Optional[float]:
        """Earliest in-flight KV transfer ready_time (None = wire empty) —
        the simulator races this against arrivals/engine iterations so a
        transfer completing on an otherwise-idle cluster still delivers."""
        return min((t[0] for t in self._in_transfer), default=None)

    def kv_transfer_log(self) -> List[tuple]:
        """(req_id, src_engine, dst_engine) delivery stream — the
        disaggregation parity oracle (tests/test_scheduler_parity.py)."""
        return list(self.kv_transfers)

    def _maybe_hedge(self, now: float) -> None:
        if self.gcfg.hedge_threshold <= 0 or not hasattr(self.router, "hedge_target"):
            return
        metrics = self.bus.snapshot(now)
        # plan all moves against the pass-start state, then apply: otherwise a
        # request hedged 0->1 is immediately re-hedged 1->0 within the pass
        moves = []
        for e in self.engines.values():
            if not e.healthy:
                continue
            for r in e.queue:            # public iteration, waiting order
                if (r.hedged_at is not None
                        and now - r.hedged_at < self.gcfg.hedge_threshold):
                    continue  # cooldown: one hedge per threshold window
                tgt = self.router.hedge_target(r, metrics, now)
                if tgt is not None and tgt != e.engine_id:
                    moves.append((e, r, tgt))
        for e, r, tgt in moves:
            e.queue.remove(r)
            r.engine_id = tgt
            r.hedged_at = now
            r.hedges += 1
            e.core.hedged_away += 1
            # the move is an assignment decision (parity oracle); re-submit
            # on the target advertises the prompt's blocks in the directory
            # before the next dispatch consults it
            self.dispatch.record_hedge(r, tgt)
            self.engines[tgt].submit(r, now)

    # ------------------------------------------------------------------ fault tolerance
    def health_check(self, now: float) -> List[int]:
        """Feed the HealthMonitor from the bus and auto-fail every engine it
        newly declares dead (KV lost: a silent death gives no chance to
        migrate pages).  No-op without ``health=``; ``step()`` calls this
        every tick, so failover needs no manual ``fail_engine``."""
        if self.monitor is None:
            return []
        self.monitor.observe(self.bus.snapshot(now), now)
        failed = []
        for eid in self.monitor.check(now):
            if eid in self.engines:
                self.dispatch.note_lifecycle("detect", eid)
                self.fail_engine(eid, now, kv="lost", detected=True)
                failed.append(eid)
            else:
                self.monitor.remove_engine(eid)   # stale bus entry
        return failed

    def autoscale(self, now: float) -> int:
        """One ElasticPolicy decision applied: +1 built via ``engine_factory``
        (charged ``warmup_s``), -1 drains the least-loaded engine.  No-op
        without ``elastic=``.  Returns the applied delta."""
        if self.elastic is None:
            return 0
        dead = self.monitor.dead if self.monitor is not None else ()
        decision = self.elastic.decide(self.bus.snapshot(now), now=now,
                                       dead=dead, n_engines=len(self.engines))
        if decision > 0 and self.engine_factory is not None:
            self.add_engine(self.engine_factory(self.next_engine_id()),
                            now, warmup_s=self.warmup_s)
            return +1
        if decision < 0:
            victim = self._scale_in_victim(now)
            if victim is not None:
                self.remove_engine(victim, now)
                return -1
        return 0

    def _scale_in_victim(self, now: float) -> Optional[int]:
        """Least-loaded ready healthy engine (ties to the lowest id);
        never the last healthy one."""
        ready = [e for e in self.engines.values()
                 if e.healthy and now >= self._ready_at.get(e.engine_id, now)]
        if len(ready) <= 1:
            return None
        return min((e.metrics(now).running_load, e.engine_id)
                   for e in ready)[1]

    def fail_engine(self, engine_id: int, now: float, kv: str = "lost",
                    detected: bool = False) -> int:
        """Node failure: mark dead, drain, re-route.  ``kv="lost"`` (crash):
        orphans re-prefill from scratch elsewhere; ``kv="migrated"``
        (orchestrated failover): KV pages travel with the re-route, so
        generation progress and first-token times survive.  Returns the
        number of re-routed requests."""
        e = self.engines[engine_id]
        e.healthy = False
        if self.monitor is not None:
            self.monitor.mark_dead(engine_id, now)
        # stop routing there and forget its prefixes (node memory is gone)
        # BEFORE re-routing orphans, so none chase the dead engine's cache
        self.dispatch.on_engine_failed(engine_id, kv=kv)
        e.prefix.clear()
        orphans = e.drain_all(migrate=(kv == "migrated"))
        self.fault_log.append({"t": now, "kind": "fail", "engine": engine_id,
                               "kv": kv, "detected": detected,
                               "orphans": [r.req_id for r in orphans]})
        for r in orphans:
            r.reroutes += 1
            self.submit(r, now)
        self.rerouted += len(orphans)
        return len(orphans)

    def restore_engine(self, engine_id: int, now: float = 0.0,
                       warmup_s: float = 0.0) -> None:
        e = self.engines[engine_id]
        e.healthy = True
        if warmup_s > 0:
            self._ready_at[engine_id] = now + warmup_s
        self.dispatch.on_engine_restored(engine_id)
        if self.monitor is not None:
            self.monitor.add_engine(engine_id, now)

    def add_engine(self, engine: Engine, now: float = 0.0,
                   warmup_s: float = 0.0) -> None:
        """Fold a new engine into the pool, registered everywhere membership
        matters: router candidate set + prefix directory (DispatchCore),
        metrics bus (first heartbeat published immediately, so the monitor
        never sees a silent newcomer) and health monitor.  ``warmup_s``
        charges the expert-placement warm-up: the engine queues dispatched
        work but serves nothing until ``now + warmup_s``."""
        eid = engine.engine_id
        self.engines[eid] = engine
        self._next_engine_id = max(self._next_engine_id, eid + 1)
        if warmup_s > 0:
            self._ready_at[eid] = now + warmup_s
        self.dispatch.attach_engine(eid, getattr(engine, "prefix", None),
                                    role=getattr(engine, "role", "unified"))
        self.bus.publish(engine.metrics(now))
        if self.monitor is not None:
            self.monitor.add_engine(eid, now)

    def remove_engine(self, engine_id: int, now: float = 0.0) -> int:
        """Graceful scale-in: stop routing there, migrate the drained
        requests' KV with their re-route, drop the engine from every
        registry.  Its accounting (SLO cells, shed list, counters) is kept
        on ``self.retired``.  Returns the number of re-routed requests."""
        e = self.engines[engine_id]
        self.dispatch.on_engine_removed(engine_id)
        orphans = e.drain_all(migrate=True)
        e.prefix.clear()
        del self.engines[engine_id]
        self._ready_at.pop(engine_id, None)
        self.bus.forget(engine_id)
        if self.monitor is not None:
            self.monitor.remove_engine(engine_id)
        self.retired.append(e)
        self.fault_log.append({"t": now, "kind": "remove", "engine": engine_id,
                               "orphans": [r.req_id for r in orphans]})
        for r in orphans:
            r.reroutes += 1
            self.submit(r, now)
        self.rerouted += len(orphans)
        return len(orphans)

    def next_engine_id(self) -> int:
        """Fresh id for an elastically-added engine.  Ids are never reused:
        the bus, monitor and lifecycle log all key on them."""
        eid = self._next_engine_id
        self._next_engine_id += 1
        return eid

    def ready_at(self, engine_id: int) -> float:
        """When the engine's warm-up ends (0.0 = already serving)."""
        return self._ready_at.get(engine_id, 0.0)

    # ------------------------------------------------------------------ reporting
    def _all_engines(self) -> List[Engine]:
        """Current pool + gracefully-removed engines: removal must never
        erase accounting (SLO cells, shed lists, counters)."""
        return list(self.engines.values()) + self.retired

    def shed_requests(self) -> List[Request]:
        """Requests rejected by SLO-aware admission control, cluster-wide."""
        return [r for e in self._all_engines() for r in e.core.shed]

    def report(self, horizon: Optional[float] = None):
        return summarize(self.finished + self.shed_requests(), horizon)

    def report_by_class(self, horizon: Optional[float] = None):
        """Per-priority-class latency breakdown (mixed-tenant view)."""
        return summarize_by_class(self.finished + self.shed_requests(),
                                  horizon)

    def report_by_tenant(self, horizon: Optional[float] = None):
        """Per-tenant latency + SLO-goodput breakdown."""
        return summarize_by_tenant(self.finished + self.shed_requests(),
                                   horizon)

    def slo_report(self) -> Dict[str, Dict[str, float]]:
        """Per-(tenant, class) SLO counters merged across engine cores —
        the live-engine twin of ``SimResult.slo``."""
        slo = SLOTracker()
        for e in self._all_engines():
            slo.merge(e.core.slo)
        return slo.snapshot()

    def preemption_stats(self) -> Dict[str, int]:
        return {"preemptions": sum(e.preemptions for e in self._all_engines())}

    def hedge_stats(self) -> Dict[str, int]:
        """Straggler-mitigation counters: total hedged re-dispatches (each
        engine counts requests hedged AWAY from its queue)."""
        return {"hedges": sum(e.core.hedged_away
                              for e in self._all_engines())}

    def expert_report(self) -> Dict[str, float]:
        """Cluster-wide expert-level telemetry: the shared level's coupling
        factors, migration counters and RebalanceEvent count — directly
        comparable with the simulator's (SimResult.moe_mult_final etc.)."""
        lvl = self.expert_level
        if lvl is None:
            return {"moe_mult": 1.0, "cross_frac": 0.0, "migrations": 0,
                    "bytes_moved": 0}
        return {"moe_mult": lvl.moe_mult, "cross_frac": lvl.cross_frac,
                "migrations": lvl.migrations, "bytes_moved": lvl.bytes_moved}

    def dispatch_stats(self) -> Dict[str, float]:
        """Engine-level dispatch telemetry: assignment count and directory
        occupancy per engine (the assignment stream itself is
        ``self.dispatch.assignment_log()``)."""
        d = self.dispatch
        return {"assignments": len(d.assignments),
                "directory_blocks": {eid: d.directory.blocks_held(eid)
                                     for eid in self.engines}}

    def kv_transfer_stats(self) -> Dict[str, float]:
        """Disaggregated hand-off telemetry: delivered transfer count, KV
        seconds on the wire, and how many are still in flight."""
        return {"kv_transfers": len(self.kv_transfers),
                "kv_transfer_s": self.kv_transfer_s,
                "in_flight": len(self._in_transfer)}

    def prefix_stats(self) -> Dict[str, float]:
        hits = sum(e.prefix.hit_blocks for e in self._all_engines())
        probed = sum(e.prefix.probed_blocks for e in self._all_engines())
        return {"hit_blocks": hits, "probed_blocks": probed,
                "hit_rate": hits / max(probed, 1)}
