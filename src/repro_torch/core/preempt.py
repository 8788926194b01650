"""Port copy of ``repro.core.preempt``: host-side Python with no framework in it,
kept line for line so both packages make byte-identical decisions.

Victim selection for preemptive priority scheduling.

When a high-class (interactive) request would otherwise wait for a decode
slot, the engine may evict a running lower-class request: its KV state is
released and the victim re-enters the waiting queue with its generation
state reset for recompute-on-resume (greedy decoding regenerates the same
tokens).  This module holds the policy shared by the real engine
(serving/engine.py) and the discrete-event simulator (sim/simulator.py).

Policies (GimbalConfig.victim_policy):
  * fewest_tokens — evict the candidate with the fewest generated tokens
    (cheapest recompute; the default)
  * lowest_class  — evict the least-urgent class first, ties by fewest
    generated tokens
  * lru_slot      — evict the candidate admitted longest ago (oldest slot)
  * largest_remaining — evict the seat holding the MOST predicted-remaining
    work (SRPT's dual: free the seat that would occupy it longest; needs a
    core/predictor.py predictor — falls back to fewest_tokens without one)
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, TYPE_CHECKING

from repro_torch.core.types import GimbalConfig, Request

if TYPE_CHECKING:
    from repro_torch.core.predictor import LengthPredictor

VICTIM_POLICIES = ("fewest_tokens", "lowest_class", "lru_slot",
                   "largest_remaining")


def eligible_victims(running: Sequence[Tuple[object, Request]],
                     incoming_rank: int,
                     cfg: GimbalConfig) -> list:
    """Filter (handle, request) pairs preemptible by a request of
    `incoming_rank`: strictly lower class (higher rank number) and not yet
    past the per-request preemption cap.  Equal-class work is never evicted."""
    return [(h, r) for h, r in running
            if r.rank > incoming_rank and r.preempted < cfg.max_preemptions]


def select_victim(running: Sequence[Tuple[object, Request]],
                  incoming_rank: int,
                  cfg: GimbalConfig,
                  admit_order: Optional[Sequence[float]] = None,
                  predictor: Optional["LengthPredictor"] = None):
    """Pick the (handle, request) pair to evict, or None if nothing is
    preemptible.  `running` pairs an opaque handle (engine slot index, sim
    list position, ...) with the running request; `admit_order` optionally
    supplies a per-candidate admission timestamp for the lru_slot policy
    (defaults to arrival_time); `predictor` feeds the largest_remaining
    policy (without one it degrades to fewest_tokens, the cheapest-recompute
    default, rather than guessing)."""
    policy = cfg.victim_policy
    if policy not in VICTIM_POLICIES:
        # validate before the no-candidates early-out so a typo'd policy
        # fails on the first call, not on the first contested eviction
        raise ValueError(f"unknown victim_policy {policy!r}; "
                         f"pick from {VICTIM_POLICIES}")
    cands = eligible_victims(running, incoming_rank, cfg)
    if not cands:
        return None
    if admit_order is not None:
        admit = {id(r): t for (_, r), t in zip(running, admit_order)}
    else:
        admit = {id(r): r.arrival_time for _, r in running}
    if policy == "largest_remaining" and predictor is None:
        policy = "fewest_tokens"
    if policy == "fewest_tokens":
        key = lambda hr: (hr[1].generated, -hr[1].rank, hr[1].req_id)
    elif policy == "lowest_class":
        key = lambda hr: (-hr[1].rank, hr[1].generated, hr[1].req_id)
    elif policy == "largest_remaining":
        # most predicted-remaining work first; class, then fewest generated
        # (cheapest recompute) break ties, id last for determinism
        key = lambda hr: (-predictor.remaining(hr[1]), -hr[1].rank,
                          hr[1].generated, hr[1].req_id)
    else:  # lru_slot: oldest admission first
        key = lambda hr: (admit[id(hr[1])], hr[1].req_id)
    return min(cands, key=key)


def reset_for_resume(r: Request) -> Request:
    """Drain-style reset (mirrors Engine.drain_all): KV is gone, so the
    request re-prefills and regenerates on resume.  Book-keeps the waste."""
    r.wasted_tokens += r.generated
    r.preempted += 1
    r.first_token_time = None
    r.generated = 0
    return r
