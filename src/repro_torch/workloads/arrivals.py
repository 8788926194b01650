"""Arrival-process library: every way requests can hit the cluster.

The paper's evaluation varies prompt-length *distributions* but keeps Poisson
arrivals; real traffic is anything but Poisson (BurstGPT's namesake property
is burstiness; production fleets see diurnal cycles and flash crowds).  Each
generator here returns a sorted arrival-time array for ``n`` requests at a
target *mean* rate ``rps``, so scenarios are comparable at equal offered
load and differ only in how that load clumps:

  * ``poisson``      — memoryless baseline (inter-arrival CV = 1);
  * ``mmpp``         — two-state Markov-modulated Poisson (burst/calm
                       phases; BurstGPT-like, CV ≈ ``burstiness``);
  * ``gamma``        — gamma-renewal process; ``cv`` < 1 gives *smoother*
                       than Poisson (paced clients), > 1 burstier;
  * ``diurnal``      — nonhomogeneous Poisson with a sinusoidal day/night
                       rate profile (thinning construction);
  * ``flash_crowd``  — Poisson background plus superimposed short spikes at
                       ``spike_mult`` × the base rate (launch-day traffic).

All generators consume only the passed ``rng`` so traces are reproducible
from ``(process, n, rps, seed)``; registry access goes through
``make_arrivals`` (the campaign runner's axis) or ``ARRIVAL_PROCESSES``.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def poisson_arrivals(rng: np.random.Generator, n: int, rps: float) -> np.ndarray:
    """Homogeneous Poisson process: exponential i.i.d. gaps."""
    return np.cumsum(rng.exponential(1.0 / rps, n))


def mmpp_gaps(rng: np.random.Generator, n: int, rps: float,
              burstiness: float = 2.5, mean_dwell: float = 20.0) -> np.ndarray:
    """Two-state MMPP inter-arrival gaps (NOT cumulative): burst phase at
    ``burstiness * rps``, calm phase at ``rps / burstiness``, dwell times
    geometric with mean ``mean_dwell`` requests per phase.  Extracted from
    the original BurstGPT generator — the RNG call sequence is preserved
    exactly so every pre-existing seeded trace stays bit-identical."""
    if burstiness <= 1.0:
        return rng.exponential(1.0 / rps, n)
    b = burstiness
    hi, lo = b * rps, rps / b
    gaps = np.empty(n)
    i = 0
    state_hi = bool(rng.integers(0, 2))
    while i < n:
        dwell = max(1, int(rng.exponential(mean_dwell)))
        rate = hi if state_hi else lo
        j = min(n, i + dwell)
        gaps[i:j] = rng.exponential(1.0 / rate, j - i)
        i = j
        state_hi = not state_hi
    return gaps


def mmpp_arrivals(rng: np.random.Generator, n: int, rps: float,
                  burstiness: float = 2.5) -> np.ndarray:
    return np.cumsum(mmpp_gaps(rng, n, rps, burstiness))


def gamma_arrivals(rng: np.random.Generator, n: int, rps: float,
                   cv: float = 2.0) -> np.ndarray:
    """Gamma-renewal process with inter-arrival coefficient of variation
    ``cv``: shape k = 1/cv², scale = cv²/rps keeps the mean gap at 1/rps.
    cv=1 degenerates to Poisson; cv<1 models paced/batched clients."""
    k = 1.0 / (cv * cv)
    theta = (cv * cv) / rps
    return np.cumsum(rng.gamma(k, theta, n))


def diurnal_arrivals(rng: np.random.Generator, n: int, rps: float,
                     period: float | None = None, depth: float = 0.8,
                     cycles: float = 2.5) -> np.ndarray:
    """Nonhomogeneous Poisson with rate λ(t) = rps·(1 + depth·sin(2πt/T)),
    built by thinning a homogeneous process at the peak rate.  ``depth`` in
    [0, 1) sets how deep the night trough goes; the long-run mean stays
    ``rps``.  ``period`` defaults to the trace span over ``cycles`` cycles
    (a compressed 24 h), so short traces still see whole peak+trough waves
    instead of sampling only the rising edge."""
    if period is None:
        period = n / (rps * cycles)
    lam_max = rps * (1.0 + depth)
    out = np.empty(n)
    t, i = 0.0, 0
    while i < n:
        t += rng.exponential(1.0 / lam_max)
        lam_t = rps * (1.0 + depth * np.sin(2.0 * np.pi * t / period))
        if rng.random() * lam_max <= lam_t:
            out[i] = t
            i += 1
    return out


def flash_crowd_arrivals(rng: np.random.Generator, n: int, rps: float,
                         spike_mult: float = 8.0, spike_frac: float = 0.25,
                         mean_spikes: float = 3.0) -> np.ndarray:
    """Poisson background with ``spike_frac`` of the requests compressed
    into a few short flash crowds arriving at ``spike_mult`` × the base
    rate — the on-call scenario (a viral link, a batch-job kickoff).  The
    number of spikes is Poisson with mean ``mean_spikes`` (at least 1);
    overall mean rate stays ≈ ``rps``."""
    n_spike = int(round(n * spike_frac))
    n_base = n - n_spike
    # background must run slower than rps so the combined mean lands on rps
    base_rate = rps * (1.0 - spike_frac)
    base = np.cumsum(rng.exponential(1.0 / max(base_rate, 1e-9), n_base)) \
        if n_base else np.empty(0)
    span = base[-1] if n_base else n / rps
    n_events = max(1, int(rng.poisson(mean_spikes)))
    starts = np.sort(rng.uniform(0.0, span * 0.9, n_events))
    per_spike = np.full(n_events, n_spike // n_events)
    per_spike[: n_spike % n_events] += 1
    spikes = []
    for s0, m in zip(starts, per_spike):
        if m == 0:
            continue
        spikes.append(s0 + np.cumsum(
            rng.exponential(1.0 / (spike_mult * rps), m)))
    allts = np.concatenate([base] + spikes) if spikes else base
    return np.sort(allts)[:n]


ARRIVAL_PROCESSES: Dict[str, Callable[..., np.ndarray]] = {
    "poisson": poisson_arrivals,
    "mmpp": mmpp_arrivals,
    "gamma": gamma_arrivals,
    "diurnal": diurnal_arrivals,
    "flash": flash_crowd_arrivals,
}


def make_arrivals(process: str, rng: np.random.Generator, n: int, rps: float,
                  **kw) -> np.ndarray:
    """Registry entry point: sorted arrival times for ``n`` requests at mean
    rate ``rps`` under the named process (the campaign runner's arrival
    axis)."""
    try:
        fn = ARRIVAL_PROCESSES[process]
    except KeyError:
        raise ValueError(f"unknown arrival process {process!r}; "
                         f"pick from {tuple(ARRIVAL_PROCESSES)}") from None
    return fn(rng, n, rps, **kw)
