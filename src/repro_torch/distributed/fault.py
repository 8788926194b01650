"""Fault detection + elastic pool control for the serving cluster.

At 1000+-node scale engines fail and recover continuously; the controller
must notice silently-dead engines (no heartbeat), evict them (re-routing
their requests), and fold recovered or newly-provisioned engines back in.

HealthMonitor consumes the same MetricsBus the DP load balancer reads: a
metric snapshot IS the heartbeat, so no extra control channel exists to fail
independently.  ElasticPolicy sizes the pool from queue pressure (scale out
when sustained backlog, scale in when idle) — the hooks a cluster autoscaler
drives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.types import EngineMetrics


@dataclasses.dataclass
class HealthConfig:
    heartbeat_timeout: float = 2.0     # seconds without a metric => suspect
    suspect_strikes: int = 3           # consecutive suspect checks => dead
    recovery_probation: float = 5.0    # healthy streak required to rejoin


class HealthMonitor:
    """Heartbeat-based failure detector over the metrics bus."""

    def __init__(self, engine_ids, cfg: Optional[HealthConfig] = None):
        self.cfg = cfg or HealthConfig()
        self.strikes: Dict[int, int] = {e: 0 for e in engine_ids}
        self.dead: Dict[int, float] = {}            # engine -> time declared
        self.last_seen: Dict[int, float] = {e: 0.0 for e in engine_ids}

    def add_engine(self, engine_id: int, now: float) -> None:
        self.strikes[engine_id] = 0
        self.last_seen[engine_id] = now
        self.dead.pop(engine_id, None)

    def remove_engine(self, engine_id: int) -> None:
        self.strikes.pop(engine_id, None)
        self.last_seen.pop(engine_id, None)
        self.dead.pop(engine_id, None)

    def mark_dead(self, engine_id: int, now: float) -> None:
        """An out-of-band failure notice (orchestrated kill / drill event):
        record the engine dead so ``check`` doesn't re-detect and re-fail
        an engine the cluster already drained."""
        if engine_id in self.last_seen:
            self.dead.setdefault(engine_id, now)

    def observe(self, snapshot: Dict[int, EngineMetrics], now: float) -> None:
        for eid, m in snapshot.items():
            if eid not in self.last_seen:
                # auto-enroll on first heartbeat: an engine added via
                # Cluster.add_engine (or one the monitor was never told
                # about) must not be invisible to failure detection
                self.add_engine(eid, m.timestamp)
                continue
            if m.timestamp > self.last_seen[eid]:
                self.last_seen[eid] = m.timestamp
                if eid not in self.dead:
                    self.strikes[eid] = 0

    def check(self, now: float) -> List[int]:
        """Returns engines newly declared DEAD this check (sorted for
        deterministic failover order across planes)."""
        newly = []
        for eid, seen in sorted(self.last_seen.items()):
            if eid in self.dead:
                continue
            if now - seen > self.cfg.heartbeat_timeout:
                self.strikes[eid] = self.strikes.get(eid, 0) + 1
                if self.strikes[eid] >= self.cfg.suspect_strikes:
                    self.dead[eid] = now
                    newly.append(eid)
            else:
                self.strikes[eid] = 0
        return newly

    def recovered(self, now: float) -> List[int]:
        """Engines whose heartbeats resumed for the probation period."""
        out = []
        for eid, t_dead in list(self.dead.items()):
            seen = self.last_seen.get(eid, 0.0)
            if seen > t_dead and now - t_dead >= self.cfg.recovery_probation \
                    and now - seen <= self.cfg.heartbeat_timeout:
                out.append(eid)
                del self.dead[eid]
                self.strikes[eid] = 0
        return out


@dataclasses.dataclass
class ElasticPolicy:
    """Queue-pressure pool sizing: the decision function an autoscaler calls.

    scale OUT when waiting tokens per engine exceed `out_tokens` for
    `sustain_checks` consecutive checks; scale IN when below `in_tokens`.

    Pressure is averaged over LIVE engines only: a dead engine's frozen
    metrics would otherwise dilute per-engine pressure and block scale-out
    exactly when the survivors are drowning.  Callers pass the monitor's
    ``dead`` set and ``now`` (with ``stale_after`` > 0, snapshots older than
    that are treated as dead too); the pool-size bounds check uses
    ``n_engines`` — the actual pool — not the snapshot width.
    """
    out_tokens: int = 20_000
    in_tokens: int = 1_000
    min_engines: int = 1
    max_engines: int = 1024
    sustain_checks: int = 3
    stale_after: float = 0.0        # 0 = no heartbeat-freshness filter

    def __post_init__(self):
        self._hot = 0
        self._cold = 0

    def decide(self, snapshot: Dict[int, EngineMetrics], now: float = None,
               dead=(), n_engines: int = None) -> int:
        """Returns +1 (add an engine), -1 (remove one), or 0."""
        live = [m for eid, m in snapshot.items()
                if m.healthy and eid not in dead
                and not (self.stale_after > 0 and now is not None
                         and now - m.timestamp > self.stale_after)]
        if not live:
            return 0
        n = n_engines if n_engines is not None else len(live)
        per_engine = sum(m.running_load for m in live) / len(live)
        if per_engine > self.out_tokens:
            self._hot += 1
            self._cold = 0
            if self._hot >= self.sustain_checks and n < self.max_engines:
                self._hot = 0
                return +1
        elif per_engine < self.in_tokens:
            self._cold += 1
            self._hot = 0
            if self._cold >= self.sustain_checks and n > self.min_engines:
                self._cold = 0
                return -1
        else:
            self._hot = self._cold = 0
        return 0
