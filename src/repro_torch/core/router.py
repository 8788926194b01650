"""Engine-level scheduling: the DP Engine Load Balancer (paper Algorithm 1).

Also provides the Round-Robin baseline (vLLM default) and a hedged-dispatch
straggler-mitigation extension for large fleets (beyond-paper, disabled unless
GimbalConfig.hedge_threshold > 0).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.types import EngineMetrics, GimbalConfig, Request


class RoundRobinRouter:
    """vLLM-default baseline: blind rotation over healthy engines."""

    def __init__(self, engine_ids: Sequence[int], cfg: Optional[GimbalConfig] = None):
        self.engine_ids = list(engine_ids)
        self._next = 0
        # engine roles for disaggregated prefill/decode dispatch
        # (DispatchCore shares its role map into this dict).  Empty or
        # all-"unified": every select behaves exactly as before.
        self.roles: Dict[int, str] = {}

    def _role_pool(self, request: Request) -> List[int]:
        """Candidate engines honoring disaggregated roles: fresh requests
        (prefill ahead of them) go to prefill/unified engines; KV-migrated
        requests (prefill done, pages travelling) go to decode/unified
        engines.  Falls back to every engine when the wanted pool is empty
        (e.g. all decode engines failed) — degraded beats stranded."""
        if not self.roles or all(v == "unified" for v in self.roles.values()):
            return self.engine_ids
        want = (("decode", "unified") if request.kv_migrated
                else ("prefill", "unified"))
        pool = [e for e in self.engine_ids
                if self.roles.get(e, "unified") in want]
        return pool or self.engine_ids

    def select(self, request: Request, metrics: Dict[int, EngineMetrics],
               now: Optional[float] = None) -> int:
        ids = self._role_pool(request)
        healthy = [e for e in ids if metrics.get(e, EngineMetrics(e)).healthy]
        ids = healthy or ids
        e = ids[self._next % len(ids)]
        self._next += 1
        return e

    # elastic pool ------------------------------------------------------------
    def add_engine(self, engine_id: int) -> None:
        if engine_id not in self.engine_ids:
            self.engine_ids.append(engine_id)

    def remove_engine(self, engine_id: int) -> None:
        if engine_id in self.engine_ids:
            self.engine_ids.remove(engine_id)


class GimbalRouter(RoundRobinRouter):
    """Algorithm 1: KV-usage-aware, running-load-aware, user-affinity dispatch.

    Decision order (faithful to the paper):
      1. default: next engine round-robin                         (line 1)
      2. if metrics available:
         a. KV saturation (>= theta_kv) + imbalance (>= theta_diff)
            -> engine with min KV usage                           (lines 3-7)
         b. else running-load gap (> theta_load)
            -> engine with min running load                       (lines 8-13)
      3. elif user affinity mapping fresh -> sticky engine        (lines 15-18)
      4. update user_engine_map, return                           (lines 21-22)

    NOTE on line 15: per the paper text, affinity is "only applied when no
    engine shows KV overuse" — we therefore take the affinity branch when
    metrics exist but no rebalancing fired, as well as when metrics are absent.
    """

    def __init__(self, engine_ids: Sequence[int], cfg: Optional[GimbalConfig] = None):
        super().__init__(engine_ids)
        self.cfg = cfg or GimbalConfig()
        self.user_engine_map: Dict[str, Tuple[int, float]] = {}
        # optimistic in-flight accounting: tokens dispatched since the engine's
        # last metric snapshot.  Without it, every arrival inside one metric
        # period sees the same stale snapshot and herds onto the same "least
        # loaded" engine (vLLM's DP balancer keeps the same in-flight view).
        self._inflight: Dict[int, List[Tuple[int, float]]] = {}

    def _inflight_tokens(self, engine_id: int, since: float) -> int:
        entries = self._inflight.get(engine_id, [])
        return sum(t for t, ts in entries if ts >= since)

    def _note_dispatch(self, engine_id: int, tokens: int, now: float) -> None:
        lst = self._inflight.setdefault(engine_id, [])
        lst.append((tokens, now))
        if len(lst) > 256:
            del lst[:128]

    def _fresh_metrics(self, metrics: Dict[int, EngineMetrics], now: float
                       ) -> List[EngineMetrics]:
        out = []
        for e in self.engine_ids:
            m = metrics.get(e)
            if m is None or not m.healthy:
                continue
            if self.cfg.metric_staleness > 0 and now - m.timestamp > self.cfg.metric_staleness:
                continue  # stale == unavailable (async ZeroMQ semantics)
            out.append(m)
        return out

    def select(self, request: Request, metrics: Dict[int, EngineMetrics],
               now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        pool = self._role_pool(request)
        healthy = [e for e in pool
                   if metrics.get(e, EngineMetrics(e)).healthy] or pool

        # line 1: default round-robin candidate
        e_star = healthy[self._next % len(healthy)]
        self._next += 1

        ms = [m for m in self._fresh_metrics(metrics, now)
              if m.engine_id in healthy]
        rebalanced = False
        if ms:                                                    # line 2
            kv = {m.engine_id: m.kv_usage for m in ms}
            i_max = max(kv, key=kv.get)                           # line 3
            i_min = min(kv, key=kv.get)                           # line 4
            if kv[i_max] >= self.cfg.theta_kv:                    # line 5
                if kv[i_max] - kv[i_min] >= self.cfg.theta_diff:  # line 6
                    e_star, rebalanced = i_min, True              # line 7
            else:                                                 # line 8
                load = {m.engine_id: m.running_load
                        + self._inflight_tokens(m.engine_id, m.timestamp)
                        for m in ms}
                l_max, l_min = max(load.values()), min(load.values())
                if l_max - l_min > self.cfg.theta_load:           # line 10
                    e_star = min(load, key=load.get)              # lines 11-12
                    rebalanced = True
        if not rebalanced and request.user_id is not None:        # line 15
            hit = self.user_engine_map.get(request.user_id)
            if hit is not None:                                   # line 16
                eng, ts = hit
                if now - ts <= self.cfg.affinity_ttl and eng in healthy:
                    e_star = eng                                  # line 17

        if request.user_id is not None:                           # line 21
            self.user_engine_map[request.user_id] = (e_star, now)
        self._note_dispatch(e_star, request.prompt_len, now)
        return e_star                                             # line 22

    # --- straggler mitigation (beyond-paper) ------------------------------------
    def hedge_target(self, request: Request, metrics: Dict[int, EngineMetrics],
                     now: float) -> Optional[int]:
        """If a dispatched request has been queued past hedge_threshold, pick a
        second engine (lowest running load, != current) to hedge onto.  The
        engine that starts it first wins; the other cancels (cluster.py)."""
        if self.cfg.hedge_threshold <= 0 or request.engine_id is None:
            return None
        waited = now - request.arrival_time
        if waited < self.cfg.hedge_threshold:
            return None
        pool = self._role_pool(request)
        ms = [m for m in self._fresh_metrics(metrics, now)
              if m.engine_id != request.engine_id and m.engine_id in pool]
        if not ms:
            return None
        return min(ms, key=lambda m: m.running_load).engine_id
