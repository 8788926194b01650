"""Port of the queue half of ``repro.core.gimbal``: the ablation variants of
the paper's evaluation (§V-A.7) and the request-level queue each one uses.

  * "vllm"       — RR router + FCFS queue + static experts   (baseline)
  * "dplb"       — Alg.1 router only
  * "sjfs"       — SJF queue only
  * "edr"        — expert dynamic replacement only
  * "eplb"       — count-only EPLB expert level
  * "gimbal"     — all three
  * "gimbal+rep" — gimbal with hot-expert replication
  * "rr" | "prefix" | "kv" | "sticky" | "combined" — engine-level dispatch
    variants (SJF + EDR held fixed, only the dispatch rule varies)

The router and expert-level factories (``make_router``, ``make_rebalancer``,
``make_cluster_expert_level``) wait for the cluster plane and the expert
level of the port (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.sjf import SJFQueue
from repro_torch.core.types import GimbalConfig

DISPATCH_VARIANTS = ("rr", "prefix", "kv", "sticky", "combined")
VARIANTS = ("vllm", "dplb", "sjfs", "edr", "eplb", "gimbal",
            "gimbal+rep") + DISPATCH_VARIANTS


def variant_flags(variant: str) -> Dict[str, bool]:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")
    return {
        "dplb": variant in ("dplb", "gimbal", "gimbal+rep"),
        "sjf": variant in ("sjfs", "gimbal", "gimbal+rep")
               or variant in DISPATCH_VARIANTS,
        "edr": variant in ("edr", "eplb", "gimbal", "gimbal+rep")
               or variant in DISPATCH_VARIANTS,
        "rep": variant == "gimbal+rep",
        "dispatch": variant in DISPATCH_VARIANTS and variant != "rr",
    }


def make_queue(variant: str, cfg: Optional[GimbalConfig] = None) -> SJFQueue:
    f = variant_flags(variant)
    return SJFQueue(cfg or GimbalConfig(), policy="sjf" if f["sjf"] else "fcfs")
