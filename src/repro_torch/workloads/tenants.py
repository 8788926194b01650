"""Multi-tenant workload mixer: compose per-tenant traffic into one trace.

A ``TenantSpec`` describes one tenant's traffic shape — volume share, prompt
-length distribution (the paper's Fig. 5 shapes, reused per tenant), output
scale, priority class, TTFT/TPOT SLO targets, and a sticky user pool (users
belong to exactly one tenant, so Alg. 1 user affinity and the prefix cache
see realistic per-tenant session locality).  ``mixed_trace`` draws one
arrival stream from workloads/arrivals.py and labels each request with its
tenant's class/SLO/user, producing the labeled traces the campaign runner
(benchmarks/campaign.py) feeds the simulator; ``SUITES`` holds named tenant
mixes used as the campaign's workload axis.

This operationalizes the mixed-priority multi-tenant direction of
"Priority-Aware Preemptive Scheduling for Mixed-Priority Workloads in MoE
Inference": interactive tenants carry tight deadlines and preemption rights,
batch tenants carry volume, and SLO-goodput (core/slo.py) is the scorecard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.types import Request
from repro_torch.workloads.arrivals import make_arrivals
from repro_torch.workloads.burstgpt import (_sample_output_lens, _sample_prompt_lens)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape and service-level contract."""
    name: str
    weight: float = 1.0              # share of request volume (normalized)
    priority_class: str = "batch"    # see core/types.py PRIORITY_CLASSES
    prompt_dist: str = "descending"  # Fig. 5 shape (workloads/burstgpt.py)
    output_scale: float = 1.0        # multiplier on the BurstGPT output draw
    slo_ttft: Optional[float] = None     # seconds; None = no TTFT target
    slo_tpot: Optional[float] = None     # seconds/token; None = no target
    n_users: int = 50                # sticky user pool size (affinity/prefix)


def mixed_trace(specs: Tuple[TenantSpec, ...], n: int = 1000,
                arrival: str = "mmpp", rps: float = 1.4, seed: int = 0,
                vocab_size: Optional[int] = None, sessions: bool = False,
                max_context: int = 512, **arrival_kw) -> List[Request]:
    """One labeled multi-tenant trace: ``n`` requests at mean rate ``rps``
    under the named arrival process, each assigned a tenant by weighted
    draw and stamped with that tenant's class, SLO targets, and a user from
    its pool.  Deterministic in ``(specs, n, arrival, rps, seed)``.

    Label conservation: every request's ``tenant`` is one of the spec names
    and expected per-tenant counts follow the weights (tested in
    tests/test_workload_matrix.py).

    ``sessions=True`` (requires ``vocab_size``) makes each user a growing
    chat transcript, sharegpt-style: a user's next prompt is their previous
    prompt plus a fresh suffix (the per-tenant length draw), capped at
    ``max_context`` tokens prefix-stably (excess suffix is dropped, never
    the head, so cached leading blocks stay valid).  This gives real
    cross-request prefix locality — the signal prefix/sticky/combined
    dispatch (core/dispatch.py) exploits and round-robin destroys.  Session
    tokens come from a dedicated child generator, so (tenant, new-turn
    lengths, users, arrivals) stay IDENTICAL to the token-less
    (``vocab_size=None``) trace at the same seed: session cells compare
    token locality, not a resampled workload."""
    if not specs:
        raise ValueError("mixed_trace needs at least one TenantSpec")
    if sessions and not vocab_size:
        raise ValueError("sessions=True requires vocab_size")
    rng = np.random.default_rng(seed)
    # arrivals draw from a spawned child generator (which does NOT advance
    # `rng`'s bitstream): switching the arrival axis at a fixed seed keeps
    # the tenant/length/user draws identical, so cross-arrival campaign
    # cells compare clumping — not a resampled workload
    arrivals = make_arrivals(arrival, rng.spawn(1)[0], n, rps, **arrival_kw)
    session_rng = np.random.default_rng((seed, 0x5e55)) if sessions else None
    w = np.asarray([max(s.weight, 0.0) for s in specs], float)
    if w.sum() <= 0:
        raise ValueError("tenant weights must sum to a positive value")
    tenant_idx = rng.choice(len(specs), size=n, p=w / w.sum())
    # per-tenant length draws so each tenant keeps its own shape
    plens = np.empty(n, int)
    olens = np.empty(n, int)
    for ti, s in enumerate(specs):
        mask = tenant_idx == ti
        m = int(mask.sum())
        if m == 0:
            continue
        plens[mask] = _sample_prompt_lens(rng, m, s.prompt_dist)
        olens[mask] = np.maximum(
            (_sample_output_lens(rng, m) * s.output_scale), 4).astype(int)
    transcripts: Dict[str, List[int]] = {}
    reqs: List[Request] = []
    for i in range(n):
        s = specs[tenant_idx[i]]
        uid = int(rng.integers(0, max(s.n_users, 1)))
        user = f"{s.name}:user{uid}"
        plen = int(plens[i])
        if sessions:
            hist = transcripts.setdefault(user, [])
            suffix = session_rng.integers(0, vocab_size, plen).tolist()
            toks = (hist + suffix)[:max_context]
            transcripts[user] = toks
            tokens = np.asarray(toks, dtype=np.int64)
            plen = len(toks)
        else:
            tokens = rng.integers(0, vocab_size, plen) if vocab_size else None
        reqs.append(Request(
            req_id=i, prompt_len=plen, max_new_tokens=int(olens[i]),
            arrival_time=float(arrivals[i]),
            user_id=user,
            prompt_tokens=tokens,
            priority_class=s.priority_class,
            tenant=s.name,
            slo_ttft=s.slo_ttft, slo_tpot=s.slo_tpot))
    return reqs


# ---------------------------------------------------------------- named mixes
# SLO targets are in *simulator* seconds, calibrated against the cost-model
# operating points in benchmarks/common.py (where 10 sim-RPS saturates the
# vLLM baseline at P99 TTFT of seconds): tight interactive targets bite
# under load without being unachievable, batch targets are loose or absent.
SUITES: Dict[str, Tuple[TenantSpec, ...]] = {
    # latency-sensitive chat riding on top of bulk summarization volume
    "chat_vs_batch": (
        TenantSpec("chat", weight=0.3, priority_class="interactive",
                   prompt_dist="descending", output_scale=0.5,
                   slo_ttft=1.0, slo_tpot=0.20, n_users=200),
        TenantSpec("summarize", weight=0.7, priority_class="batch",
                   prompt_dist="two-end", output_scale=1.0,
                   slo_ttft=10.0, n_users=40),
    ),
    # agentic tool loops (many small calls, tight TPOT) vs offline evals
    "agents_vs_eval": (
        TenantSpec("agents", weight=0.5, priority_class="interactive",
                   prompt_dist="central", output_scale=0.25,
                   slo_ttft=0.8, slo_tpot=0.15, n_users=80),
        TenantSpec("evals", weight=0.5, priority_class="batch",
                   prompt_dist="average", output_scale=1.5, n_users=10),
    ),
    # a paying-tier ladder: enterprise > pro > free on deadlines and priority
    "three_tier": (
        TenantSpec("enterprise", weight=0.2, priority_class="interactive",
                   prompt_dist="random", slo_ttft=0.8, slo_tpot=0.15,
                   n_users=60),
        TenantSpec("pro", weight=0.3, priority_class="interactive",
                   prompt_dist="descending", slo_ttft=2.0, slo_tpot=0.25,
                   n_users=150),
        TenantSpec("free", weight=0.5, priority_class="batch",
                   prompt_dist="descending", slo_ttft=8.0, n_users=500),
    ),
    # single-tenant control cell: the paper's original shape, SLO-less
    "uniform": (
        TenantSpec("all", weight=1.0, prompt_dist="random"),
    ),
}


def suite_trace(suite: str, n: int = 1000, arrival: str = "mmpp",
                rps: float = 1.4, seed: int = 0, **kw) -> List[Request]:
    """``mixed_trace`` over a named suite (the campaign's workload axis)."""
    try:
        specs = SUITES[suite]
    except KeyError:
        raise ValueError(f"unknown tenant suite {suite!r}; "
                         f"pick from {tuple(SUITES)}") from None
    return mixed_trace(specs, n=n, arrival=arrival, rps=rps, seed=seed, **kw)
