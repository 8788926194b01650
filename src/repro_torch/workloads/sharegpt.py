"""ShareGPT-style multi-turn user sessions (paper §V-B.3 prefix-cache study).

Each user holds a conversation: turn t's prompt is the running transcript
(previous prompt + previous answer + new utterance), so consecutive requests
from the same user share a growing prefix.  Routing a user's next turn to the
engine that served the last one (user affinity, Alg. 1 lines 15-18) turns that
shared prefix into prefix-cache hits — Figs. 11-12.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.types import Request


def sharegpt_trace(n_requests: int = 10_000, n_users: int = 500, rps: float = 4.0,
                   seed: int = 0, vocab_size: int = 50_000,
                   utterance_mean: int = 60, answer_mean: int = 120,
                   max_context: int = 3000,
                   continue_p: float = 1.0,
                   interactive_frac: float = 0.0,
                   slo_ttft: float | None = None,
                   slo_tpot: float | None = None) -> List[Request]:
    """continue_p < 1 makes a user's request start a FRESH conversation with
    probability (1 - continue_p) — real ShareGPT traffic is mostly new
    conversations (the paper measures only a 3.6-3.8% block hit rate), and
    only session continuations can hit the prefix cache.

    `interactive_frac` > 0 marks that fraction of USERS as interactive-class
    (chat sessions are per-user latency-sensitive, so the class sticks to the
    whole conversation); everyone else is batch-class.  `slo_ttft`/`slo_tpot`
    attach deadlines to the interactive users' requests (SLO-goodput
    accounting, core/slo.py); batch users stay SLO-less."""
    rng = np.random.default_rng(seed)
    transcripts = {u: list(rng.integers(0, vocab_size, rng.integers(10, 40)))
                   for u in range(n_users)}
    # short-circuit keeps the seeded stream unchanged at interactive_frac=0
    user_class = {u: "interactive" if interactive_frac > 0
                  and rng.random() < interactive_frac else "batch"
                  for u in range(n_users)}
    gaps = rng.exponential(1.0 / rps, n_requests)
    arrivals = np.cumsum(gaps)
    reqs: List[Request] = []
    for i in range(n_requests):
        u = int(rng.integers(0, n_users))
        if rng.random() > continue_p:   # new conversation: no shared prefix
            transcripts[u] = list(rng.integers(0, vocab_size,
                                               rng.integers(10, 40)))
        t = transcripts[u]
        # user adds an utterance
        t.extend(rng.integers(0, vocab_size, max(1, int(rng.poisson(utterance_mean)))))
        if len(t) > max_context:       # truncate from the left like chat UIs
            del t[: len(t) - max_context]
        out_len = max(4, int(rng.poisson(answer_mean)))
        interactive = user_class[u] == "interactive"
        reqs.append(Request(
            req_id=i, prompt_len=len(t), max_new_tokens=out_len,
            arrival_time=float(arrivals[i]), user_id=f"user{u}",
            prompt_tokens=np.asarray(t, np.int64).copy(),
            priority_class=user_class[u],
            slo_ttft=slo_ttft if interactive else None,
            slo_tpot=slo_tpot if interactive else None))
        # the (simulated) answer extends the transcript for the next turn
        t.extend(rng.integers(0, vocab_size, out_len))
    return reqs
