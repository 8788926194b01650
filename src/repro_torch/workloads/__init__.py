"""Workload generation: traces, arrival processes, and multi-tenant mixes.

  * burstgpt.py — the paper's BurstGPT-shaped traces (Fig. 5 prompt shapes,
    MMPP arrivals, optional mixed priority classes);
  * sharegpt.py — multi-turn user sessions with true shared prefixes
    (Figs. 11-12 prefix-cache study);
  * arrivals.py — the arrival-process library (poisson / mmpp / gamma /
    diurnal / flash), every generator deterministic in (process, n, rps,
    seed);
  * tenants.py — TenantSpec + mixed_trace + named SUITES: compose per-tenant
    shapes, priority classes, SLO deadlines and sticky user pools into one
    labeled trace for the campaign runner.
"""
from repro_torch.workloads.arrivals import ARRIVAL_PROCESSES, make_arrivals
from repro_torch.workloads.burstgpt import DISTRIBUTIONS, burstgpt_trace
from repro_torch.workloads.sharegpt import sharegpt_trace
from repro_torch.workloads.tenants import (SUITES, TenantSpec, mixed_trace,
                                     suite_trace)

__all__ = [
    "ARRIVAL_PROCESSES", "make_arrivals",
    "DISTRIBUTIONS", "burstgpt_trace", "sharegpt_trace",
    "SUITES", "TenantSpec", "mixed_trace", "suite_trace",
]
