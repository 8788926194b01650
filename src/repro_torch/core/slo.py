"""Port copy of ``repro.core.slo``: host-side Python with no framework in it,
kept line for line so both packages make byte-identical decisions.

SLO-attainment and goodput accounting (request level, both planes).

Throughput counts every generated token; **goodput** counts only tokens from
requests that met their per-request deadlines (``Request.slo_ttft`` /
``slo_tpot``) — the metric that actually matters to a tenant paying for a
latency target.  ``SLOTracker`` is owned by ``SchedulerCore`` so the live
JAX engine and the cost-model simulator run the *same* accounting code on
the same decision stream (tests/test_scheduler_parity.py extends the parity
oracle to these counters); ``serving/metrics.py::summarize`` derives the
identical attainment/goodput columns offline from finished-request lists.

Counters are broken down per ``(tenant, priority_class)`` cell — the
grouping the campaign report tables use — and roll up via ``merge`` across
engines."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

from repro_torch.core.types import Request

Key = Tuple[str, str]               # (tenant, priority_class)


@dataclasses.dataclass
class SLOCell:
    """Accumulated outcomes for one (tenant, class) traffic slice."""
    finished: int = 0
    met: int = 0                    # finished requests whose SLO held
    with_slo: int = 0               # finished requests that had any target
    tokens: int = 0                 # generated tokens (throughput numerator)
    good_tokens: int = 0            # tokens from SLO-met requests (goodput)
    shed: int = 0                   # rejected by SLO-aware admission control

    @property
    def attainment(self) -> float:
        """Fraction of SLO-carrying requests that met their deadlines; 1.0
        for SLO-less traffic (vacuously met, so goodput == throughput).
        Shed requests count in the denominator as misses: load shedding must
        not launder attainment by rejecting the traffic it would have
        failed — it only wins by letting the survivors meet theirs."""
        tracked = self.with_slo + self.shed
        return self.met_of_tracked / tracked if tracked else 1.0

    @property
    def met_of_tracked(self) -> int:
        # `met` counts vacuous passes too; attainment only grades requests
        # that actually carried a target
        return self.met - (self.finished - self.with_slo)

    def row(self) -> Dict[str, float]:
        return {"finished": self.finished, "met": self.met,
                "with_slo": self.with_slo, "tokens": self.tokens,
                "good_tokens": self.good_tokens, "shed": self.shed,
                "attainment": self.attainment}


class SLOTracker:
    """Per-(tenant, class) SLO bookkeeping; one per SchedulerCore."""

    def __init__(self) -> None:
        self.cells: Dict[Key, SLOCell] = {}

    def observe(self, r: Request) -> None:
        """Record a finished request (call exactly once, at finish)."""
        cell = self.cells.setdefault((r.tenant, r.priority_class), SLOCell())
        cell.finished += 1
        cell.tokens += r.generated
        if r.has_slo:
            cell.with_slo += 1
        if r.slo_met:
            cell.met += 1
            cell.good_tokens += r.generated

    def observe_shed(self, r: Request) -> None:
        """Record a request rejected by SLO-aware admission control (call
        exactly once, at the shed decision; the request never finishes)."""
        cell = self.cells.setdefault((r.tenant, r.priority_class), SLOCell())
        cell.shed += 1

    def merge(self, other: "SLOTracker") -> "SLOTracker":
        """Fold another tracker's cells into this one (cluster roll-up)."""
        for key, c in other.cells.items():
            mine = self.cells.setdefault(key, SLOCell())
            mine.finished += c.finished
            mine.met += c.met
            mine.with_slo += c.with_slo
            mine.tokens += c.tokens
            mine.good_tokens += c.good_tokens
            mine.shed += c.shed
        return self

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """JSON-friendly view keyed ``tenant/class`` in sorted order — also
        the parity oracle's comparison payload."""
        return {f"{t}/{c}": cell.row()
                for (t, c), cell in sorted(self.cells.items())}

    @staticmethod
    def of(requests: Iterable[Request]) -> "SLOTracker":
        """Build a tracker offline from finished requests (metrics path)."""
        tr = SLOTracker()
        for r in requests:
            if r.finish_time is not None:
                tr.observe(r)
        return tr
