"""Port copy of ``repro.core.sjf``: host-side Python with no framework in it,
kept line for line so both packages make byte-identical decisions.

Request-level scheduling: SJF with aging (paper Algorithm 2) + FCFS baseline
+ predicted-remaining-work (SRPT) ranking when a length predictor is wired.

The paper's priority key is the PREFILL token count (r.prompt) — it
deliberately avoids output-length prediction.  With a
``core/predictor.py::LengthPredictor`` attached (GimbalConfig.predictor), the
key becomes the predictor's **remaining-work** estimate instead: un-prefilled
prompt + predicted output tokens still to generate.  Because ``remaining``
shrinks as a request decodes (and resets when a preempted request loses its
KV), every ``reorder`` re-ranks the waiting queue against current progress —
the SRPT discipline of "Optimal Scheduling Algorithms for LLM Inference"
(PAPERS.md).  Requests waiting longer than theta_age are promoted to high
priority regardless of size (starvation guard), predictor or not.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, TYPE_CHECKING

from repro_torch.core.types import GimbalConfig, Request

if TYPE_CHECKING:           # import cycle guard: predictor imports types only
    from repro_torch.core.predictor import LengthPredictor


def order_key(r: Request, now: float, cfg: GimbalConfig,
              predictor: Optional["LengthPredictor"] = None):
    """The Algorithm-2(+SRPT) sort key, as a pure function (no field
    mutation): aged requests outrank every class; everyone else sorts by
    (class rank, size) where size is the predictor's remaining-work estimate
    when one is wired, else the prefill length; ties break by arrival then
    request id — a total order, so sorting is permutation-invariant."""
    if now - r.arrival_time >= cfg.theta_age:
        return (-1, -1.0, r.arrival_time, r.req_id)
    size = (predictor.remaining(r) if predictor is not None
            else float(r.prompt_len))
    return (r.rank, size, r.arrival_time, r.req_id)


def fcfs_order(waiting: Sequence[Request], now: float) -> List[Request]:
    """vLLM default: arrival order."""
    return sorted(waiting, key=lambda r: (r.arrival_time, r.req_id))


def sjf_order(waiting: Sequence[Request], now: float,
              cfg: GimbalConfig | None = None,
              predictor: Optional["LengthPredictor"] = None) -> List[Request]:
    """Algorithm 2 extended with priority classes (and, with ``predictor``,
    SRPT remaining-work ranking): assign priorities, sort ascending, return
    the new queue.

    Aged requests (w_r >= theta_age) get priority -1 ("high") and jump ahead
    of EVERY class — the starvation guard outranks class so preempted batch
    work eventually runs; ties among aged requests break by arrival (oldest
    first).  Everyone else sorts by (class rank, size): interactive before
    batch, smallest size first within a class — size is the prefill length
    (the paper's key) or, with a predictor, its predicted-remaining-tokens
    estimate; ties break by arrival then id for determinism.  With all
    requests in the default class and no predictor this reduces exactly to
    the paper's Algorithm 2.
    """
    cfg = cfg or GimbalConfig()
    for r in waiting:                                   # lines 1-8
        w_r = now - r.arrival_time                      # line 2
        if w_r >= cfg.theta_age:                        # line 3
            r.priority = -1.0                           # line 4: high priority
            r.aged = True
        else:
            r.priority = (predictor.remaining(r)        # SRPT key, or
                          if predictor is not None
                          else float(r.prompt_len))     # line 6 (paper)
            r.aged = False
    # line 9: sort ascending (aged first, then by class, then smallest size)
    return sorted(waiting, key=lambda r: order_key(r, now, cfg, predictor))


class SJFQueue:
    """Mutable waiting queue wrapper used by the engine: push requests, pop the
    next batch in SJF/SRPT(+aging) or FCFS order before each forward pass.

    Bookkeeping is O(1) where the engine hot path needs it: ``waiting_tokens``
    is an incremental counter (read per metrics publish and per shed
    estimate) and ``remove`` — called once per preemption beneficiary — is a
    swap-delete through a req_id -> position index instead of the old O(n)
    ``list.remove`` equality scan.  Order between ``reorder`` calls is
    unspecified (every consumer reorders first), which is what makes
    swap-delete safe."""

    def __init__(self, cfg: GimbalConfig | None = None, policy: str = "sjf",
                 predictor: Optional["LengthPredictor"] = None):
        assert policy in ("sjf", "fcfs")
        self.cfg = cfg or GimbalConfig()
        self.policy = policy
        # ranking hook: SchedulerCore attaches the GimbalConfig-built
        # predictor here so "sjf" ranks by predicted remaining work (SRPT)
        self.predictor = predictor
        self._items: List[Request] = []
        self._pos: dict[int, int] = {}      # req_id -> index in _items
        self._waiting_tokens = 0

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        """Public read-only iteration over waiting requests in current queue
        order (the cluster's hedging scan uses this; mutate only through
        push/remove/extend/pop_next)."""
        return iter(list(self._items))

    @property
    def waiting_tokens(self) -> int:
        return self._waiting_tokens

    def push(self, r: Request) -> None:
        if r.req_id in self._pos:
            raise ValueError(f"request {r.req_id} is already queued")
        self._pos[r.req_id] = len(self._items)
        self._items.append(r)
        self._waiting_tokens += r.prompt_len

    def remove(self, r: Request) -> None:
        """Pull a specific request out of the queue (engine preemption hands
        its beneficiary a slot directly, bypassing pop_next).  O(1):
        swap-delete via the position index."""
        i = self._pos.get(r.req_id)
        if i is None:
            raise ValueError(f"request {r.req_id} not in queue")
        del self._pos[r.req_id]
        last = self._items.pop()
        if i < len(self._items):
            self._items[i] = last
            self._pos[last.req_id] = i
        self._waiting_tokens -= r.prompt_len

    def extend(self, rs: Sequence[Request]) -> None:
        for r in rs:
            self.push(r)

    def _reindex(self) -> None:
        self._pos = {r.req_id: i for i, r in enumerate(self._items)}

    def reorder(self, now: float) -> List[Request]:
        if self.policy == "sjf":
            self._items = sjf_order(self._items, now, self.cfg, self.predictor)
        else:
            self._items = fcfs_order(self._items, now)
        self._reindex()
        return list(self._items)

    def pop_next(self, now: float, budget_tokens: int | None = None) -> List[Request]:
        """Reorder, then pop requests fitting a prefill token budget (chunked-
        prefill-style admission).  budget_tokens=None pops just the head."""
        self.reorder(now)
        popped: List[Request] = []
        if budget_tokens is None:
            if self._items:
                popped.append(self._items.pop(0))
        else:
            used = 0
            while self._items and used + self._items[0].prompt_len <= budget_tokens:
                r = self._items.pop(0)
                used += r.prompt_len
                popped.append(r)
            if not popped and self._items and used == 0:
                popped.append(self._items.pop(0))  # head bigger than budget: admit alone
        if popped:
            self._waiting_tokens -= sum(r.prompt_len for r in popped)
            self._reindex()
        return popped

    def drain(self) -> List[Request]:
        items, self._items = self._items, []
        self._pos.clear()
        self._waiting_tokens = 0
        return items
