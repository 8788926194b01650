"""Metric plumbing: the async engine->balancer bus (paper's ZeroMQ channel) and
the request-level latency recorder (TTFT / TPOT / throughput, §V-A.5)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.types import EngineMetrics, Request


class MetricsBus:
    """Asynchronous metric delivery with explicit propagation delay: engines
    publish snapshots; the balancer reads the newest snapshot whose publish
    time + delay <= now.  Models the paper's ZeroMQ staleness semantics."""

    def __init__(self, delay: float = 0.05):
        self.delay = delay
        self._log: Dict[int, List[EngineMetrics]] = {}

    def publish(self, m: EngineMetrics) -> None:
        self._log.setdefault(m.engine_id, []).append(m)

    def snapshot(self, now: float) -> Dict[int, EngineMetrics]:
        out: Dict[int, EngineMetrics] = {}
        for eid, ms in self._log.items():
            vis = [m for m in ms if m.timestamp + self.delay <= now]
            if vis:
                out[eid] = vis[-1]
            # GC old entries
            if len(ms) > 64:
                self._log[eid] = ms[-32:]
        return out

    def forget(self, engine_id: int) -> None:
        """Drop an engine's metric history (elastic scale-in): its stale
        snapshots must not keep re-enrolling it with the HealthMonitor or
        diluting the ElasticPolicy's pressure average."""
        self._log.pop(engine_id, None)


@dataclasses.dataclass
class LatencyReport:
    n: int
    mean_ttft: float
    p50_ttft: float
    p99_ttft: float
    mean_tpot: float
    p99_tpot: float
    throughput_tok_s: float
    throughput_req_s: float
    preemptions: int = 0             # total slot evictions suffered
    wasted_tokens: int = 0           # generated tokens discarded by preemption
    # SLO accounting (core/slo.py semantics): attainment grades only requests
    # that carried a target; goodput counts only SLO-met requests/tokens.
    # SLO-less traffic vacuously meets, so goodput == throughput there.
    slo_attainment: float = 1.0
    goodput_tok_s: float = 0.0
    goodput_req_s: float = 0.0
    # requests rejected by SLO-aware admission control; they count as SLO
    # misses in `slo_attainment` (shedding must not launder attainment)
    shed: int = 0

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def summarize(requests: Sequence[Request], horizon: Optional[float] = None) -> LatencyReport:
    done = [r for r in requests if r.finish_time is not None]
    shed = [r for r in requests if r.was_shed]
    ttfts = [r.ttft for r in done if r.ttft is not None]
    tpots = [r.tpot for r in done if r.tpot is not None]
    if not done or not ttfts:
        return LatencyReport(0, *([float("nan")] * 6), 0.0,
                             slo_attainment=0.0 if shed else 1.0,
                             shed=len(shed))
    t0 = min(r.arrival_time for r in done)
    t1 = horizon if horizon is not None else max(r.finish_time for r in done)
    span = max(t1 - t0, 1e-9)
    tokens = sum(r.generated for r in done)
    with_slo = [r for r in done if r.has_slo]
    met = [r for r in done if r.slo_met]
    tracked = len(with_slo) + len(shed)
    return LatencyReport(
        n=len(done),
        mean_ttft=float(np.mean(ttfts)),
        p50_ttft=float(np.percentile(ttfts, 50)),
        p99_ttft=float(np.percentile(ttfts, 99)),
        mean_tpot=float(np.mean(tpots)) if tpots else float("nan"),
        p99_tpot=float(np.percentile(tpots, 99)) if tpots else float("nan"),
        throughput_tok_s=tokens / span,
        throughput_req_s=len(done) / span,
        preemptions=sum(r.preempted for r in done),
        wasted_tokens=sum(r.wasted_tokens for r in done),
        slo_attainment=(sum(1 for r in with_slo if r.slo_met) / tracked
                        if tracked else 1.0),
        goodput_tok_s=sum(r.generated for r in met) / span,
        goodput_req_s=len(met) / span,
        shed=len(shed),
    )


def summarize_by_class(requests: Sequence[Request],
                       horizon: Optional[float] = None
                       ) -> Dict[str, LatencyReport]:
    """Per-priority-class TTFT/TPOT breakdown (mixed-tenant evaluation):
    one LatencyReport per priority_class present in `requests`."""
    by_class: Dict[str, List[Request]] = {}
    for r in requests:
        by_class.setdefault(r.priority_class, []).append(r)
    return {c: summarize(rs, horizon) for c, rs in sorted(by_class.items())}


def summarize_by_tenant(requests: Sequence[Request],
                        horizon: Optional[float] = None
                        ) -> Dict[str, LatencyReport]:
    """Per-tenant TTFT/TPOT/SLO-goodput breakdown (multi-tenant evaluation):
    one LatencyReport per ``Request.tenant`` present in `requests`."""
    by_tenant: Dict[str, List[Request]] = {}
    for r in requests:
        by_tenant.setdefault(r.tenant, []).append(r)
    return {t: summarize(rs, horizon) for t, rs in sorted(by_tenant.items())}
