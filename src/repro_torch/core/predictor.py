"""Port copy of ``repro.core.predictor``: host-side Python with no framework in it,
kept line for line so both packages make byte-identical decisions.

Output-length prediction: the missing input of SRPT-style request scheduling.

The paper's Algorithm 2 deliberately keys SJF on the PREFILL length because
output lengths are unknown at admission.  "Optimal Scheduling Algorithms for
LLM Inference: Theory and Practice" (PAPERS.md) shows the principled target
is SRPT — rank by predicted REMAINING work — and that SRPT degrades
gracefully under bounded prediction error.  This module supplies that
prediction as a pluggable interface consumed by the whole request level:

  * ``sjf_order`` / ``SJFQueue`` rank waiting requests by
    ``LengthPredictor.remaining`` instead of ``prompt_len``
    (core/sjf.py);
  * preemption victim selection can evict the seat holding the MOST
    predicted-remaining work (``victim_policy="largest_remaining"``,
    core/preempt.py);
  * SLO-aware shedding's TTFT estimate counts only the backlog ranked
    AHEAD of the candidate under the predictor ordering, replacing the
    conservative whole-queue × ``shed_slack`` product
    (``SchedulerCore.estimate_ttft``).

Determinism contract (the parity invariant): a predictor's output may depend
only on (its config, the request's immutable fields, and the finish events
it has observed) — never on wall time, call order, or which plane asked.
``NoisyOraclePredictor`` therefore derives its noise from ``(seed, req_id)``
alone, so the serving engine and the simulator draw the SAME error for the
same request; ``HistogramPredictor`` updates only on ``observe`` (finish),
and the finish streams are byte-identical across planes
(tests/test_scheduler_parity.py).

Wiring: set ``GimbalConfig.predictor`` to a spec string — ``"oracle"``,
``"noisy:<sigma>"``, ``"histogram[:<alpha>]"`` — and every SchedulerCore
(both planes) builds its own instance via ``make_predictor``.  ``None``
keeps the paper's prefill-keyed Algorithm 2 byte-identical to before.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from repro_torch.core.types import Request

#: spec prefixes accepted by make_predictor
PREDICTOR_KINDS = ("oracle", "noisy", "histogram")


class LengthPredictor:
    """Interface: predict a request's total output length (tokens).

    ``remaining`` converts the prediction into the SRPT ranking key —
    predicted tokens still to generate, plus the un-prefilled prompt for
    requests that have not produced a token yet (a preempted request
    re-prefills; a KV-migrated orphan keeps its progress and is charged
    neither the prompt nor the tokens it already generated)."""

    def predict(self, r: Request) -> float:
        """Predicted TOTAL output length of ``r`` (generated tokens)."""
        raise NotImplementedError

    def observe(self, r: Request) -> None:
        """A request finished with ``r.generated`` output tokens: learn."""

    def remaining(self, r: Request) -> float:
        """Predicted remaining work in tokens (the SRPT priority key)."""
        rem = max(self.predict(r) - r.generated, 0.0)
        if r.generated == 0:
            rem += float(r.prompt_len)      # prefill still ahead of it
        return rem


class OraclePredictor(LengthPredictor):
    """Perfect knowledge of the declared output budget (``max_new_tokens``).

    The zero-error endpoint of the sigma sweep.  (EOS or the context cap may
    still end a request early — the oracle knows the budget, not the logits.)
    """

    def predict(self, r: Request) -> float:
        return float(r.max_new_tokens)


class NoisyOraclePredictor(LengthPredictor):
    """Oracle corrupted by multiplicative lognormal error:

        predict(r) = max_new_tokens * exp(sigma * z),   z ~ N(0, 1)

    ``sigma`` is the relative (log-space) error — the sweep axis of
    benchmarks/bench_predictor.py; sigma=0 reduces to the oracle.  ``z`` is a
    pure function of ``(seed, req_id)`` (one spawned generator per request),
    so the draw lives in shared core state and both planes — and repeated
    calls for the same request — see the identical prediction."""

    def __init__(self, sigma: float = 0.25, seed: int = 0):
        assert sigma >= 0.0
        self.sigma = float(sigma)
        self.seed = int(seed)
        self._cache: Dict[int, float] = {}

    def predict(self, r: Request) -> float:
        p = self._cache.get(r.req_id)
        if p is None:
            z = float(np.random.default_rng(
                (self.seed, r.req_id)).standard_normal())
            p = max(1.0, r.max_new_tokens * math.exp(self.sigma * z))
            self._cache[r.req_id] = p
        return p


class HistogramPredictor(LengthPredictor):
    """Per-tenant EMA of observed output lengths — the deployable predictor.

    Every finish updates the request's tenant bucket AND a global bucket
    with exponential weight ``alpha``; an unseen tenant falls back to the
    global estimate (and before any finish at all, to ``prior``), so cold
    tenants degrade to population behaviour instead of crashing or starving.
    State changes only in ``observe``, which fires on finish events — a
    byte-identical stream across planes — keeping predictions plane-invariant.
    """

    def __init__(self, alpha: float = 0.05, prior: float = 220.0):
        # prior ~= the BurstGPT mean output draw (workloads/burstgpt.py)
        assert 0.0 < alpha <= 1.0
        self.alpha = float(alpha)
        self.prior = float(prior)
        self._tenant: Dict[str, float] = {}
        self._global: Optional[float] = None

    def predict(self, r: Request) -> float:
        v = self._tenant.get(r.tenant)
        if v is not None:
            return v
        return self._global if self._global is not None else self.prior

    def observe(self, r: Request) -> None:
        n = float(r.generated)
        a = self.alpha
        self._global = n if self._global is None \
            else (1.0 - a) * self._global + a * n
        t = self._tenant.get(r.tenant)
        self._tenant[r.tenant] = n if t is None else (1.0 - a) * t + a * n


def make_predictor(spec: Optional[str], seed: int = 0
                   ) -> Optional[LengthPredictor]:
    """Build a predictor from a ``GimbalConfig.predictor`` spec string.

    ``None`` -> None (prefill-keyed Algorithm 2, the paper default);
    ``"oracle"``; ``"noisy:<sigma>"`` (default sigma 0.25);
    ``"histogram[:<alpha>]"`` (default alpha 0.05)."""
    if spec is None:
        return None
    kind, _, arg = spec.partition(":")
    if kind == "oracle":
        return OraclePredictor()
    if kind == "noisy":
        return NoisyOraclePredictor(sigma=float(arg) if arg else 0.25,
                                    seed=seed)
    if kind == "histogram":
        return HistogramPredictor(alpha=float(arg) if arg else 0.05)
    raise ValueError(f"unknown predictor spec {spec!r}; "
                     f"kinds: {PREDICTOR_KINDS}")
