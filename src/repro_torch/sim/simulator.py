"""Discrete-event simulator of the Gimbal serving cluster (performance plane),
ported from ``repro.sim.simulator``: host-only numpy, it touches no device.

Replays BurstGPT/ShareGPT traces against {vllm, dplb, sjfs, edr, gimbal}
variants at production scale using the roofline cost model for per-iteration
latency (sim/costmodel.py).  This is how the paper's §V tables (Figs. 6-12)
are reproduced quantitatively on CPU-only hardware.

Every scheduling decision is made by the SAME SchedulerCore the live
engine runs (core/scheduler.py) — SimEngine is a thin shell pairing that core
with the analytic CostModelBackend (sim/backend.py), so an admission or
preemption decision can never differ between simulation and serving
(tests/test_torch_sim.py is the oracle).  Only model execution time is
analytic:

  * each engine owns one device; one iteration = admit under the chunked-
    prefill token budget (prefills join the running batch), then one decode
    step for all previously-running requests;
  * KV pressure from the cost model's capacity estimate gates admission;
  * MoE expert imbalance couples engines through the hotspot multiplier
    (max expert load / mean) and affinity cut fraction produced by the
    EXPERT-LEVEL placement — one SyntheticExpertLevel (core/eplb.py) shared
    by all engines, same Algorithm 3 driver and RebalanceEvent stream as
    serving;
  * expert relocation (every tau steps) costs migration bytes on the links.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dispatch import DispatchCore
from repro_torch.core.gimbal import make_sim_expert_level, variant_flags
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.scheduler import SchedulerCore
from repro_torch.core.sjf import SJFQueue
from repro_torch.core.types import EngineMetrics, GimbalConfig, Request
from repro_torch.distributed.drill import DRILLS, DrillRunner
from repro_torch.models.config import ModelConfig
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.metrics import (LatencyReport, summarize,
                                   summarize_by_class, summarize_by_tenant)
from repro_torch.sim.backend import CostModelBackend
from repro_torch.sim.costmodel import CostModel, HardwareProfile, PROFILES


class SimEngine:
    """Thin shell: SchedulerCore + CostModelBackend (vLLM-style continuous
    batching, per §V-A.1)."""

    def __init__(self, engine_id: int, cost: CostModel, gcfg: GimbalConfig,
                 sjf: bool, expert_level, *, prefill_budget: int = 2048,
                 max_running: int = 256, kv_pool_tokens: int = 0,
                 max_ctx_tokens=None, kv_block_size: int = 1,
                 role: str = "unified", prefill_mode: str = "chunked"):
        self.engine_id = engine_id
        # disaggregated serving role: Cluster.poll_handoffs collects finished
        # prefills off "prefill" engines; DispatchCore routes by role
        self.role = role
        self.backend = CostModelBackend(cost, expert_level,
                                        max_running=max_running,
                                        kv_pool_tokens=kv_pool_tokens,
                                        max_ctx_tokens=max_ctx_tokens,
                                        kv_block_size=kv_block_size)
        # vLLM's prefix cache IS the KV block pool: bound + LRU-churn it
        prefix = PrefixCache(
            capacity_blocks=max(self.backend.kv_capacity // 16, 256))
        self.core = SchedulerCore(
            self.backend, SJFQueue(gcfg, policy="sjf" if sjf else "fcfs"),
            gcfg, prefill_budget=prefill_budget, engine_id=engine_id,
            expert_level=expert_level, prefix_cache=prefix,
            prefill_mode=prefill_mode)

    def submit(self, r: Request, now: float) -> bool:
        """False when SLO-aware admission control shed the request."""
        return self.core.submit(r, now)

    def metrics(self, now: float) -> EngineMetrics:
        return self.core.metrics(now)

    def iterate(self, now: float) -> Tuple[float, List[Request]]:
        """One continuous-batching iteration starting at ``now``.
        Returns (iteration latency, finished requests)."""
        end, finished = self.core.step(now)
        return end - now, finished

    # Cluster-compatible surface (serving/engine.py's shape): a Cluster can
    # drive SimEngines directly, which is how the fast cluster regression
    # tests run the real dispatch/fault path without model compute.
    def step(self, now: float) -> List[Request]:
        _, finished = self.core.step(now)
        return finished

    def num_active(self) -> int:
        return self.core.num_running()

    def drain_all(self, migrate: bool = False) -> List[Request]:
        return self.core.drain(migrate=migrate)

    @property
    def queue(self) -> SJFQueue:
        return self.core.queue

    @property
    def healthy(self) -> bool:
        return self.core.healthy

    @healthy.setter
    def healthy(self, v: bool) -> None:
        self.core.healthy = v

    @property
    def idle(self) -> bool:
        return self.core.idle

    @property
    def prefix(self) -> PrefixCache:
        return self.core.prefix

    @property
    def preemptions(self) -> int:
        return self.core.preemptions


@dataclasses.dataclass
class SimResult:
    report: LatencyReport
    prefix_hits: int
    prefix_probed: int
    moe_mult_final: float
    cross_frac_final: float
    migrations: int
    per_engine_steps: List[int]
    # (step, moe_mult) after every placement update of the shared
    # ClusterExpertLevel — the hotspot-multiplier trajectory the campaign's
    # hot-expert-skew cells record
    moe_mult_trajectory: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)
    report_by_class: Dict[str, LatencyReport] = dataclasses.field(
        default_factory=dict)
    preemptions: int = 0
    report_by_tenant: Dict[str, LatencyReport] = dataclasses.field(
        default_factory=dict)
    # per-(tenant, class) SLO counters merged across engine cores
    # (core/slo.py::SLOTracker.snapshot format)
    slo: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # (req_id, engine_id) engine-assignment stream from the DispatchCore —
    # the engine-level parity oracle (tests/test_torch_sim.py)
    assignments: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # --- fault-drill telemetry (drill= / health= / elastic= runs) ---
    # (kind, engine_id) membership-change stream — the lifecycle parity oracle
    lifecycle: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    fault_log: List[Dict] = dataclasses.field(default_factory=list)
    n_shed: int = 0          # rejected by SLO-aware admission control
    rerouted: int = 0        # orphan re-dispatches off failed/removed engines
    # auto-detection latency: crash injection -> HealthMonitor declares dead
    # (None: nothing crashed, or nothing was auto-detected)
    detect_s: Optional[float] = None
    # failover recovery: first failure -> last orphan finished or shed
    recovery_s: Optional[float] = None
    # --- disaggregated prefill/decode telemetry (roles= runs) ---
    # (req_id, src, dst) KV hand-off delivery stream — the disagg parity
    # oracle — and the total seconds of KV pages on the interconnect
    kv_transfers: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    kv_transfer_s: float = 0.0

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_probed, 1)


def _sync_clocks(cluster, t_engine: Dict[int, float], steps: Dict[int, int],
                 now: float) -> None:
    """After a lifecycle event (drill / auto-detection / autoscale): every
    member engine's clock moves to at least ``now`` — re-routed orphans and
    fresh engines must not be served in the past.  (Busy engines are already
    past ``now``: the event-loop race only fires an event once no engine
    iteration precedes it.)"""
    for eid in cluster.engines:
        t_engine[eid] = max(t_engine.get(eid, now), now)
        steps.setdefault(eid, 0)


def simulate(requests: Sequence[Request], variant: str, cfg: ModelConfig,
             n_engines: int = 2, hw: str | HardwareProfile = "a100",
             gcfg: Optional[GimbalConfig] = None, seed: int = 0,
             horizon: Optional[float] = None, prefill_budget: int = 2048,
             max_running: int = 256, metric_delay: float = 0.05,
             kv_pool_tokens: int = 0, hot_boost: float = 8.0,
             drill=None, health=None, elastic=None,
             warmup_s: Optional[float] = None,
             prefill_mode: str = "chunked",
             roles: Optional[Sequence[str]] = None) -> SimResult:
    """Run one experiment: a trace against one variant (paper §V-A.7).

    ``hot_boost`` is the hot-expert-skew knob: how hot the synthetic prior's
    hot experts run (8.0 = the paper's Fig. 3 shape; the campaign's hotspot
    cells raise it to stress replication).

    Fault drills (the robustness axis): ``drill`` — a distributed/drill.py
    ``Drill`` or a ``DRILLS`` name — injects timed lifecycle events into the
    run; ``health`` (HealthConfig) arms heartbeat auto-detection, so a
    silently crashed engine is failed by the monitor, not by the script;
    ``elastic`` (ElasticPolicy) lets the cluster resize itself through the
    same SimEngine factory drills use.  ``warmup_s`` is the expert-placement
    warm-up charged to every added engine (None = time to move one engine's
    full weights at the cost model's link bandwidth).  All lifecycle ops go
    through the SAME serving ``Cluster`` API, so the lifecycle + assignment
    streams stay parity-comparable with the live plane.

    Disaggregation (the prefill axis): ``prefill_mode`` selects chunked
    (fused, historical) vs layered (per-layer micro-step) prefill admission
    on every engine; ``roles`` assigns per-engine serving roles, e.g.
    ``("prefill", "decode")`` for a 1P+1D topology — role-aware dispatch
    sends fresh requests to prefill engines and the cluster hands finished
    prefills to decode engines with the KV-transfer cost on the clock
    (engines beyond ``len(roles)`` default to "unified")."""
    gcfg = gcfg or GimbalConfig()
    hwp = PROFILES[hw] if isinstance(hw, str) else hw
    flags = variant_flags(variant)
    # the same DispatchCore the serving Cluster drives: router + cluster-wide
    # PrefixDirectory + engine-assignment log (the dispatch parity oracle)
    dispatch = DispatchCore(variant, list(range(n_engines)), gcfg)
    # ONE cluster-wide expert level shared by every engine core (§V-A.1)
    experts = make_sim_expert_level(variant, cfg, n_engines, gcfg, seed=seed,
                                    hot_boost=hot_boost)
    cost = CostModel(cfg, hwp, n_engines)

    def make_engine(i: int) -> SimEngine:
        role = roles[i] if roles is not None and i < len(roles) else "unified"
        return SimEngine(i, cost, gcfg, flags["sjf"], experts,
                         prefill_budget=prefill_budget,
                         max_running=max_running,
                         kv_pool_tokens=kv_pool_tokens,
                         role=role, prefill_mode=prefill_mode)

    if warmup_s is None:
        warmup_s = (cost.migration_time(cost.nonexpert_bytes
                                        + cost.expert_bytes)
                    if (drill is not None or elastic is not None) else 0.0)
    cluster = Cluster([make_engine(i) for i in range(n_engines)], variant,
                      gimbal_cfg=gcfg, bus_delay=metric_delay,
                      expert_level=experts, dispatch_core=dispatch,
                      health=health, elastic=elastic,
                      engine_factory=make_engine, warmup_s=warmup_s)
    bus = cluster.bus
    reqs = sorted(requests, key=lambda r: r.arrival_time)
    n_total = len(reqs)
    t_last = reqs[-1].arrival_time if reqs else 0.0

    runner = None
    if drill is not None:
        d = DRILLS[drill] if isinstance(drill, str) else drill
        runner = DrillRunner(d, 0.0, t_last, warmup_s=warmup_s)
    # control cadence: heartbeat synthesis + monitor checks + autoscaling
    # (idle engines never iterate, so without synthesized heartbeats the
    # monitor would false-positive exactly the engines that are healthy)
    ctrl_dt = 0.0
    if cluster.monitor is not None:
        ctrl_dt = cluster.monitor.cfg.heartbeat_timeout / 2.0
    elif cluster.elastic is not None:
        ctrl_dt = 0.25
    t_ctrl = ctrl_dt if ctrl_dt > 0 else float("inf")

    # event loop: arrivals, drill events, control ticks and per-engine
    # iterations raced on one clock (ties: arrival, drill, control, engine)
    t_engine: Dict[int, float] = {eid: 0.0 for eid in cluster.engines}
    steps: Dict[int, int] = {eid: 0 for eid in cluster.engines}
    i_req = 0
    finished = cluster.finished
    inf = float("inf")
    max_events = 1000 * max(n_total, 1) + 100_000
    n_events = 0

    def n_shed() -> int:
        return sum(len(e.core.shed) for e in cluster._all_engines())

    while (len(finished) + n_shed() < n_total
           or (runner is not None and not runner.done)):
        n_events += 1
        if n_events > max_events:
            raise RuntimeError(
                f"simulation runaway after {max_events} events "
                f"({len(finished)}/{n_total} finished)")
        busy = [(max(t_engine[eid], cluster.ready_at(eid)), eid)
                for eid, e in cluster.engines.items()
                if e.healthy and not e.idle]
        t_eng, eid_eng = min(busy) if busy else (inf, -1)
        t_arr = reqs[i_req].arrival_time if i_req < n_total else inf
        t_drill = runner.next_time() if runner is not None else inf
        t_xfer = cluster.next_transfer_time()
        t_xfer = inf if t_xfer is None else t_xfer
        t_next = min(t_eng, t_arr, t_drill, t_ctrl, t_xfer)
        if t_next == inf:
            raise RuntimeError(
                f"simulation stalled at {len(finished)}/{n_total} finished: "
                "unserved requests remain but no engine, arrival, drill or "
                "control event can make progress (a crash drill with no "
                "HealthMonitor strands its engine's queue)")
        if t_arr <= t_next:
            r = reqs[i_req]
            i_req += 1
            eid = cluster.submit(r, r.arrival_time)
            t_engine[eid] = max(t_engine.get(eid, r.arrival_time),
                                r.arrival_time)
            continue
        if t_drill <= t_next:
            runner.poll(cluster, t_drill)
            _sync_clocks(cluster, t_engine, steps, t_drill)
            continue
        if t_xfer <= t_next:
            # a KV hand-off finished its wire time on an otherwise-quiet
            # cluster: deliver it (role-aware re-dispatch to a decode engine)
            cluster.poll_handoffs(t_xfer)
            _sync_clocks(cluster, t_engine, steps, t_xfer)
            continue
        if t_ctrl <= t_next:
            for e in list(cluster.engines.values()):
                if e.healthy:           # heartbeat: idle + warming engines too
                    bus.publish(e.metrics(t_ctrl))
            cluster.health_check(t_ctrl)
            cluster.autoscale(t_ctrl)
            _sync_clocks(cluster, t_engine, steps, t_ctrl)
            t_ctrl += ctrl_dt
            continue
        eng = cluster.engines[eid_eng]
        dt, done = eng.iterate(t_eng)
        t_engine[eid_eng] = t_eng + dt
        steps[eid_eng] += 1
        finished.extend(done)
        bus.publish(eng.metrics(t_engine[eid_eng]))
        if getattr(eng, "role", "unified") == "prefill":
            # collect finished prefills for hand-off the moment the engine's
            # iteration ends; delivery happens at the t_xfer event above
            if cluster.poll_handoffs(t_engine[eid_eng]):
                _sync_clocks(cluster, t_engine, steps, t_engine[eid_eng])

    everyone = cluster._all_engines()
    shed_all = cluster.shed_requests()
    hits = sum(e.prefix.hit_blocks for e in everyone)
    probed = sum(e.prefix.probed_blocks for e in everyone)

    # failover telemetry, from the injection record + the cluster fault log
    detect_s = None
    if runner is not None:
        crashes = {e: t for t, act, e in runner.fired if act == "crash"}
        for f in cluster.fault_log:
            if (f["kind"] == "fail" and f.get("detected")
                    and f["engine"] in crashes):
                detect_s = f["t"] - crashes[f["engine"]]
                break
    recovery_s = None
    fails = [f for f in cluster.fault_log if f["kind"] == "fail"]
    if fails:
        orphan_ids = {rid for f in fails for rid in f["orphans"]}
        ends = [r.finish_time if r.finish_time is not None else r.shed_time
                for r in list(finished) + shed_all if r.req_id in orphan_ids]
        ends = [t for t in ends if t is not None]
        if ends:
            recovery_s = max(ends) - fails[0]["t"]

    graded = list(finished) + shed_all
    return SimResult(
        report=summarize(graded, horizon),
        prefix_hits=hits, prefix_probed=probed,
        moe_mult_final=experts.moe_mult, cross_frac_final=experts.cross_frac,
        migrations=experts.migrations,
        per_engine_steps=[steps[eid] for eid in sorted(steps)],
        moe_mult_trajectory=list(getattr(experts, "factor_trail", [])),
        report_by_class=summarize_by_class(graded, horizon),
        preemptions=sum(e.preemptions for e in everyone),
        report_by_tenant=summarize_by_tenant(graded, horizon),
        slo=cluster.slo_report(), assignments=dispatch.assignment_log(),
        lifecycle=dispatch.lifecycle_log(), fault_log=list(cluster.fault_log),
        n_shed=len(shed_all), rerouted=cluster.rerouted,
        detect_s=detect_s, recovery_s=recovery_s,
        kv_transfers=cluster.kv_transfer_log(),
        kv_transfer_s=cluster.kv_transfer_s)
