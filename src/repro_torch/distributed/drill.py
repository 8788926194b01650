"""Deterministic fault drills: ONE scenario language both planes execute.

A drill is a timed script of engine-lifecycle events — crash, kill, restore,
add, remove — pinned to FRACTIONS of the trace's arrival window, so the same
drill stresses a 60-request smoke trace and a 50k-request campaign cell at
the same relative point in the workload.  ``DrillRunner`` applies due events
to a ``Cluster`` (serving/cluster.py over real TorchBackend Engines, or the same
Cluster over SimEngines, or sim/simulator.py's event loop); because every
event lands on the cluster's lifecycle API — which routes through the shared
``DispatchCore``/``SchedulerCore`` — the resulting lifecycle + assignment
streams are differential-parity-testable across planes
(tests/test_scheduler_parity.py).

Actions:
  * ``crash``   — flip ``healthy`` silently.  NOTHING else happens: the
                  router keeps assigning to the corpse until the cluster's
                  HealthMonitor detects the missed heartbeats and auto-fails
                  it.  This is the auto-detection acceptance path.
  * ``kill``    — orchestrated failure: ``Cluster.fail_engine`` immediately,
                  with ``kv`` deciding whether orphans re-prefill ("lost")
                  or their KV pages travel with the re-route ("migrated").
  * ``restore`` — the engine rejoins (router candidate set + monitor).
  * ``add``     — grow the pool via ``Cluster.engine_factory`` under a fresh
                  id, charged the runner's expert-placement ``warmup_s``.
  * ``remove``  — graceful scale-in: drain (KV migrated), deregister.

``engine == -1`` targets the most recently added engine (the elastic drill's
"scale in what you scaled out").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.types import Request

ACTIONS = ("crash", "kill", "restore", "add", "remove")


@dataclasses.dataclass(frozen=True)
class DrillEvent:
    at: float            # fraction of the drill window [0, 1)
    action: str          # one of ACTIONS
    engine: int = 0      # target engine id; -1 = most recently added
    kv: str = "lost"     # kill only: orphan KV semantics (lost | migrated)

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown drill action {self.action!r}")
        if not 0.0 <= self.at <= 1.0:
            raise ValueError(f"drill event at={self.at} outside [0, 1]")


@dataclasses.dataclass(frozen=True)
class Drill:
    name: str
    events: Tuple[DrillEvent, ...] = ()

    def schedule(self, t0: float, t1: float
                 ) -> List[Tuple[float, int, DrillEvent]]:
        """Absolute firing times over the window [t0, t1]; the script index
        breaks simultaneous-event ties, so the order is deterministic."""
        span = max(t1 - t0, 0.0)
        return sorted((t0 + ev.at * span, i, ev)
                      for i, ev in enumerate(self.events))


# The registry the campaign's fault axis and the CI smoke job name cells by.
# Engine 1 is the canonical victim: engine 0 keeps the lowest-id tie-break
# stable so assignment streams stay comparable across drills.
DRILLS: Dict[str, Drill] = {
    "none": Drill("none"),
    # silent crash, never recovered — pure auto-detection + failover
    "kill": Drill("kill", (DrillEvent(0.25, "crash", 1),)),
    # THE acceptance drill: silent crash, detected by the monitor, victim
    # rejoins later — requests must finish exactly once through it all
    "kill_restore": Drill("kill_restore", (DrillEvent(0.25, "crash", 1),
                                           DrillEvent(0.60, "restore", 1))),
    # orchestrated failover twin of kill_restore: KV migrates, no re-prefill
    "kill_migrate": Drill("kill_migrate",
                          (DrillEvent(0.25, "kill", 1, kv="migrated"),
                           DrillEvent(0.60, "restore", 1))),
    # elastic flex: scale out under the flash crowd, scale back in after
    "elastic": Drill("elastic", (DrillEvent(0.20, "add", -1),
                                 DrillEvent(0.75, "remove", -1))),
}


class DrillRunner:
    """Applies a drill's due events to a Cluster.  Both planes drive one:
    the serving plane polls it from its step loop (``run_drill``), the
    simulator races ``next_time()`` against its event queue."""

    def __init__(self, drill: Drill, t0: float, t1: float, *,
                 warmup_s: float = 0.0):
        self.drill = drill
        self.pending = drill.schedule(t0, t1)
        self.warmup_s = warmup_s
        self.fired: List[Tuple[float, str, int]] = []   # (t, action, engine)
        self._last_added: Optional[int] = None

    @property
    def done(self) -> bool:
        return not self.pending

    def next_time(self) -> float:
        return self.pending[0][0] if self.pending else float("inf")

    def poll(self, cluster, now: float) -> int:
        """Fire every event due by ``now``; returns how many fired."""
        n = 0
        while self.pending and self.pending[0][0] <= now:
            _, _, ev = self.pending.pop(0)
            self._apply(cluster, ev, now)
            n += 1
        return n

    def _resolve(self, cluster, ev: DrillEvent) -> int:
        if ev.engine != -1:
            return ev.engine
        if self._last_added is not None:
            return self._last_added
        return max(cluster.engines)

    def _apply(self, cluster, ev: DrillEvent, now: float) -> None:
        if ev.action == "add":
            if cluster.engine_factory is None:
                raise ValueError(
                    f"drill {self.drill.name!r} adds an engine: the Cluster "
                    "needs an engine_factory")
            eid = cluster.next_engine_id()
            cluster.add_engine(cluster.engine_factory(eid), now,
                               warmup_s=self.warmup_s)
            self._last_added = eid
        else:
            eid = self._resolve(cluster, ev)
            if ev.action == "crash":
                if eid in cluster.engines:
                    cluster.engines[eid].healthy = False   # silent: no drain,
                    # no deregistration — the HealthMonitor must notice
            elif ev.action == "kill":
                if eid in cluster.engines and cluster.engines[eid].healthy:
                    cluster.fail_engine(eid, now, kv=ev.kv)
            elif ev.action == "restore":
                if eid in cluster.engines:
                    cluster.restore_engine(eid, now)
            elif ev.action == "remove":
                if eid in cluster.engines:
                    cluster.remove_engine(eid, now)
        self.fired.append((now, ev.action,
                           eid if ev.action != "add" else self._last_added))


def run_drill(cluster, requests: Sequence[Request], drill, *,
              t0: float = 0.0, dt: float = 0.01, warmup_s: float = 0.0,
              max_steps: int = 200_000) -> DrillRunner:
    """Step-clock drill harness for a Cluster of either engine flavour:
    submit arrivals on the logical clock, poll the drill, step — until the
    drill is exhausted and every request has finished or been shed.  The
    parity test drives a real-Engine cluster and its SimEngine twin through
    THIS loop at the same dt, then compares lifecycle/assignment/event
    streams.  Returns the runner (``fired`` is the injection record)."""
    d = DRILLS[drill] if isinstance(drill, str) else drill
    pending = sorted(requests, key=lambda r: (r.arrival_time, r.req_id))
    t1 = pending[-1].arrival_time if pending else t0
    runner = DrillRunner(d, t0, t1, warmup_s=warmup_s)
    i, now = 0, t0
    for _ in range(max_steps):
        while i < len(pending) and pending[i].arrival_time <= now:
            cluster.submit(pending[i], now)
            i += 1
        runner.poll(cluster, now)
        cluster.step(now)
        now += dt
        if (i == len(pending) and runner.done
                and len(cluster.finished) + len(cluster.shed_requests())
                >= len(pending)
                and all(e.num_active() == 0 and len(e.queue) == 0
                        for e in cluster.engines.values())):
            return runner
    raise RuntimeError(
        f"drill {d.name!r} did not drain within {max_steps} steps "
        f"({len(cluster.finished)}/{len(pending)} finished, "
        f"{len(cluster.shed_requests())} shed)")
