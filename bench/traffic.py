"""The one traffic generator: it reads a traffic mix's parameters
(``bench/traffic/<name>.json``) and makes the requests a run offers.

The length laws and arrival processes are frozen copies of the program's
generators (``repro_torch/workloads/burstgpt.py`` and ``arrivals.py``, with
the same random call sequences), so a later change to the program cannot
change the traffic.  The MMPP copy also returns the phase of each gap.

Every seed offers the same work: the sizes and arrival times come from the
mix's ``master_seed``; ``--seed`` orders the sizes (within each burst/calm
phase of an open loop, unless its ``order`` is "fixed"; within each
client's list of a closed loop, whose first item then gives way to the
equilibrium request) and draws the token ids, uniform over the vocabulary
and unshared.

Mix keys:
  loop         "open" (requests due on a schedule) or "closed" (clients that
               send their next request when the last one finishes)
  arrival      open: {"process": "mmpp" | "poisson", "rps", "burstiness",
               "mean_dwell"}
  order        open: "phase" (the default: the seed permutes the sizes within
               each burst/calm phase) or "fixed" (the master schedule's order:
               every seed sends the same sizes at the same times, so where a
               long prompt lands in a burst does not change from run to run)
  clients      closed: the number of clients, each sending its next request
               as soon as the last finishes (no think time);
               ``equilibrium_start`` gives each first request a uniform
               share of a length-biased output draw
  prompt       {"law": "burstgpt", "distribution", "min", "p976", "max",
               "tail_frac"} or {"law": "uniform", "min", "max"}
  output       {"law": "lognormal", "mu", "sigma", "min", "max"}
  requests     open: requests in the master schedule; closed: a client's list
  warmup_s     traffic run before the window opens, not counted
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Tuple

import numpy as np


def subseed(seed: int, *names) -> int:
    """A 63-bit seed for one use of the run's seed, the same on every host."""
    key = "/".join([str(int(seed))] + [str(n) for n in names]).encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little") >> 1


@dataclasses.dataclass
class Job:
    """One request as the harness offers it.  ``due`` is seconds after the
    traffic starts (open loop); a closed loop's job is due when its client's
    previous one finishes."""
    rid: int
    prompt: np.ndarray
    out_len: int
    due: Optional[float] = None
    client: int = 0


# ---------------------------------------------------------------- frozen laws
# copied from repro_torch/workloads/burstgpt.py (_sample_prompt_lens,
# _sample_output_lens) and arrivals.py (mmpp_gaps), parameters made explicit

def burstgpt_prompt_lens(rng: np.random.Generator, n: int, distribution: str,
                         lo: int = 16, p976: int = 3000, hi: int = 6000,
                         tail_frac: float = 0.024) -> np.ndarray:
    top = p976
    if distribution == "random":
        lens = rng.uniform(lo, top, n)
    elif distribution == "central":
        lens = rng.normal((lo + top) / 2, (top - lo) / 8, n)
    elif distribution == "descending":
        lens = lo + rng.exponential((top - lo) / 4, n)
    elif distribution == "two-end":
        side = rng.random(n) < 0.5
        short = rng.normal(lo + (top - lo) * 0.08, (top - lo) / 20, n)
        long_ = rng.normal(lo + (top - lo) * 0.92, (top - lo) / 20, n)
        lens = np.where(side, short, long_)
    elif distribution == "average":
        edges = np.linspace(lo, top, n + 1)
        lens = edges[:-1] + rng.random(n) * np.diff(edges)
        rng.shuffle(lens)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    tail = rng.random(n) < tail_frac
    lens = np.where(tail, rng.uniform(p976, hi, n), lens)
    return np.clip(lens, lo, hi).astype(int)


def mmpp_gaps(rng: np.random.Generator, n: int, rps: float, burstiness: float = 2.5,
              mean_dwell: float = 20.0) -> Tuple[np.ndarray, np.ndarray]:
    """Two-state MMPP gaps (burst at ``burstiness * rps``, calm at
    ``rps / burstiness``, geometric dwell of ``mean_dwell`` requests) and
    the index of the phase each gap belongs to."""
    if burstiness <= 1.0:
        return rng.exponential(1.0 / rps, n), np.zeros(n, np.int64)
    b = burstiness
    hi, lo = b * rps, rps / b
    gaps = np.empty(n)
    phase = np.empty(n, np.int64)
    i, k = 0, 0
    state_hi = bool(rng.integers(0, 2))
    while i < n:
        dwell = max(1, int(rng.exponential(mean_dwell)))
        rate = hi if state_hi else lo
        j = min(n, i + dwell)
        gaps[i:j] = rng.exponential(1.0 / rate, j - i)
        phase[i:j] = k
        i, k = j, k + 1
        state_hi = not state_hi
    return gaps, phase


# ---------------------------------------------------------------- the laws by name

def prompt_lens(rng: np.random.Generator, n: int, law: dict) -> np.ndarray:
    if law["law"] == "burstgpt":
        return burstgpt_prompt_lens(rng, n, law["distribution"], law["min"], law["p976"],
                                    law["max"], law["tail_frac"])
    if law["law"] == "uniform":
        return rng.integers(law["min"], law["max"] + 1, n)
    raise ValueError(f"unknown prompt law {law['law']!r}")


def output_lens(rng: np.random.Generator, n: int, law: dict) -> np.ndarray:
    if law["law"] == "lognormal":
        out = rng.lognormal(mean=law["mu"], sigma=law["sigma"], size=n)
        return np.clip(out, law["min"], law["max"]).astype(int)
    raise ValueError(f"unknown output law {law['law']!r}")


def arrivals(rng: np.random.Generator, n: int, spec: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(due times, phase of each request) of ``n`` requests."""
    if spec["process"] == "mmpp":
        gaps, phase = mmpp_gaps(rng, n, spec["rps"], spec.get("burstiness", 2.5),
                                spec.get("mean_dwell", 20.0))
    elif spec["process"] == "poisson":
        gaps, phase = rng.exponential(1.0 / spec["rps"], n), np.zeros(n, np.int64)
    else:
        raise ValueError(f"unknown arrival process {spec['process']!r}")
    return np.cumsum(gaps), phase


# ---------------------------------------------------------------- the mixes

def _tokens(seed: int, lens, vocab: int) -> List[np.ndarray]:
    rng = np.random.default_rng(subseed(seed, "tokens"))
    flat = rng.integers(0, vocab, int(np.sum(lens)), dtype=np.int64)
    return np.split(flat, np.cumsum(lens)[:-1])


def _permute_within(groups: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """An order of 0..n-1 that permutes indices only within equal ``groups``."""
    order = np.arange(len(groups))
    for g in np.unique(groups):
        idx = np.flatnonzero(groups == g)
        order[idx] = idx[rng.permutation(len(idx))]
    return order


def open_loop(mix: dict, seed: int, vocab: int, max_prompt: int) -> List[Job]:
    """The open loop's jobs in due order."""
    n = mix["requests"]
    master = np.random.default_rng(mix["master_seed"])
    due, phase = arrivals(master, n, mix["arrival"])
    plens = np.minimum(prompt_lens(master, n, mix["prompt"]), max_prompt)
    olens = output_lens(master, n, mix["output"])
    if mix.get("order", "phase") == "phase":
        order = _permute_within(phase, np.random.default_rng(subseed(seed, "order")))
        plens, olens = plens[order], olens[order]
    elif mix["order"] != "fixed":
        raise ValueError(f"unknown order {mix['order']!r}")
    toks = _tokens(seed, plens, vocab)
    return [Job(i, toks[i], int(olens[i]), float(due[i])) for i in range(n)]


def length_biased(rng: np.random.Generator, law: dict, n: int) -> np.ndarray:
    """``n`` draws of the output law weighted by length: the length of the
    request a client is in the middle of, in equilibrium."""
    pool = output_lens(rng, 4096, law).astype(float)
    return rng.choice(pool, size=n, p=pool / pool.sum())


def closed_loop(mix: dict, seed: int, vocab: int, max_prompt: int) -> List[List[Job]]:
    """Each client's jobs in the order it sends them."""
    c, m = mix["clients"], mix["requests"]
    master = np.random.default_rng(mix["master_seed"])
    plens = np.minimum(prompt_lens(master, c * m, mix["prompt"]), max_prompt).reshape(c, m)
    olens = output_lens(master, c * m, mix["output"]).reshape(c, m)
    if mix.get("equilibrium_start", False):
        share = master.random(c)
        first = np.maximum(1, (share * length_biased(master, mix["output"], c)).astype(int))
    rng = np.random.default_rng(subseed(seed, "order"))
    for i in range(c):
        perm = rng.permutation(m)
        plens[i], olens[i] = plens[i][perm], olens[i][perm]
    if mix.get("equilibrium_start", False):
        olens[:, 0] = first[rng.permutation(c)]
    toks = _tokens(seed, plens.reshape(-1), vocab)
    return [[Job(i * m + j, toks[i * m + j], int(olens[i, j]), None, i) for j in range(m)]
            for i in range(c)]


def prompt_bounds(mix: dict, max_prompt: int) -> Tuple[int, int]:
    """The shortest and longest prompt the mix can send."""
    p = mix["prompt"]
    return min(int(p["min"]), max_prompt), min(int(p["max"]), max_prompt)
