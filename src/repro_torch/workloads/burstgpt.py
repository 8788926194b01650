"""BurstGPT-shaped synthetic traces (paper §V-A.4, Fig. 5).

The paper samples 1,000 requests from BurstGPT reshaped into five prompt-length
distributions — Random, Central, Descending, Two-end, Average — with Poisson
arrivals at 1.0–1.4 RPS.  BurstGPT statistics used for calibration: 97.6 % of
requests have <= 3000 prompt tokens (the paper sets theta_load from this);
output lengths are lognormal-ish with a few-hundred-token mode.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.types import Request
from repro_torch.workloads.arrivals import mmpp_gaps

DISTRIBUTIONS = ("random", "central", "descending", "two-end", "average")

PROMPT_MIN = 16
PROMPT_MAX = 6000          # small tail above 3000, like BurstGPT
PROMPT_P976 = 3000         # 97.6 % of mass below this


def _sample_prompt_lens(rng: np.random.Generator, n: int, distribution: str) -> np.ndarray:
    lo, hi = PROMPT_MIN, PROMPT_P976
    if distribution == "random":
        # uniform-at-random over the support
        lens = rng.uniform(lo, hi, n)
    elif distribution == "central":
        # bell centred mid-range
        lens = rng.normal((lo + hi) / 2, (hi - lo) / 8, n)
    elif distribution == "descending":
        # many short, few long (exponential-ish decay)
        lens = lo + rng.exponential((hi - lo) / 4, n)
    elif distribution == "two-end":
        # bimodal: short chats + long documents
        side = rng.random(n) < 0.5
        short = rng.normal(lo + (hi - lo) * 0.08, (hi - lo) / 20, n)
        long_ = rng.normal(lo + (hi - lo) * 0.92, (hi - lo) / 20, n)
        lens = np.where(side, short, long_)
    elif distribution == "average":
        # equal counts per length bin (stratified uniform)
        edges = np.linspace(lo, hi, n + 1)
        lens = edges[:-1] + rng.random(n) * np.diff(edges)
        rng.shuffle(lens)
    else:
        raise ValueError(f"unknown distribution {distribution!r}; pick from {DISTRIBUTIONS}")
    # 2.4 % heavy tail above 3000 tokens (BurstGPT calibration)
    tail = rng.random(n) < 0.024
    lens = np.where(tail, rng.uniform(PROMPT_P976, PROMPT_MAX, n), lens)
    return np.clip(lens, PROMPT_MIN, PROMPT_MAX).astype(int)


def _sample_output_lens(rng: np.random.Generator, n: int) -> np.ndarray:
    out = rng.lognormal(mean=4.6, sigma=0.7, size=n)   # mode ~ 100, mean ~ 220
    return np.clip(out, 8, 1024).astype(int)


def burstgpt_trace(n: int = 1000, distribution: str = "random", rps: float = 1.4,
                   seed: int = 0, with_users: bool = False,
                   vocab_size: Optional[int] = None,
                   burstiness: float = 2.5,
                   interactive_frac: float = 0.0,
                   arrival: str = "mmpp") -> List[Request]:
    """Arrivals at mean `rps` with BurstGPT-like burstiness (the dataset's
    namesake): a two-state MMPP alternating burst/calm phases whose
    inter-arrival CV ~= `burstiness` (CV=1 == Poisson; the paper's queueing
    effects, e.g. P99 TTFT ~ 35x the mean, require the bursty arrivals of the
    real trace).  Prompt lengths follow `distribution` (Fig. 5).

    `interactive_frac` > 0 tags that fraction of requests with
    priority_class="interactive" (rest "batch") for mixed-tenant /
    preemption experiments; the draw is independent of size and arrival so
    both classes see the same length distribution.

    `arrival` swaps the arrival process for any registered in
    workloads/arrivals.py ("poisson"/"gamma"/"diurnal"/"flash"); the default
    "mmpp" keeps the original generator — and the exact RNG call sequence,
    so every pre-existing seeded trace stays bit-identical.  Non-mmpp
    arrivals draw from a spawned child generator (which does not advance the
    main bitstream), so at a fixed seed every non-mmpp arrival process sees
    the SAME prompt/output lengths — cross-arrival comparisons measure
    clumping, not a resampled workload."""
    rng = np.random.default_rng(seed)
    if arrival == "mmpp":
        # shared two-state MMPP (workloads/arrivals.py) — same RNG call
        # sequence as the original inline generator
        arrivals = np.cumsum(mmpp_gaps(rng, n, rps, burstiness))
    else:
        from repro_torch.workloads.arrivals import make_arrivals
        arrivals = make_arrivals(arrival, rng.spawn(1)[0], n, rps)
    plens = _sample_prompt_lens(rng, n, distribution)
    olens = _sample_output_lens(rng, n)
    # guard the draw so interactive_frac=0 leaves the seeded stream (and thus
    # every pre-existing trace) bit-identical
    interactive = (rng.random(n) < interactive_frac) if interactive_frac > 0 \
        else np.zeros(n, bool)
    reqs = []
    for i in range(n):
        tokens = rng.integers(0, vocab_size, plens[i]) if vocab_size else None
        reqs.append(Request(
            req_id=i, prompt_len=int(plens[i]), max_new_tokens=int(olens[i]),
            arrival_time=float(arrivals[i]),
            user_id=f"user{rng.integers(0, max(n // 10, 1))}" if with_users else None,
            prompt_tokens=tokens,
            priority_class="interactive" if interactive[i] else "batch"))
    return reqs
