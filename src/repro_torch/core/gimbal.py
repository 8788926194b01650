"""Port of ``repro.core.gimbal``: the ablation variants of the paper's
evaluation (§V-A.7), and the router, request-level queue and expert level
each one uses.

  * "vllm"       — RR router + FCFS queue + static experts   (baseline)
  * "dplb"       — Alg.1 router only
  * "sjfs"       — SJF queue only
  * "edr"        — expert dynamic replacement only
  * "eplb"       — count-only EPLB expert level
  * "gimbal"     — all three
  * "gimbal+rep" — gimbal with hot-expert replication
  * "rr" | "prefix" | "kv" | "sticky" | "combined" — engine-level dispatch
    variants (SJF + EDR held fixed, only the dispatch rule varies)
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.core.dispatch import DISPATCH_WEIGHTS, ScoredRouter
from repro_torch.core.eplb import (ClusterExpertLevel, ExpertRebalancer,
                                   NullExpertLevel, SyntheticExpertLevel)
from repro_torch.core.prefix_directory import PrefixDirectory
from repro_torch.core.router import GimbalRouter, RoundRobinRouter
from repro_torch.core.sjf import SJFQueue
from repro_torch.core.types import GimbalConfig
from repro_torch.models.config import ModelConfig

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
        # scored engine-level dispatch ("rr" keeps SJF+EDR but routes blind,
        # making it the clean baseline for the dispatch axis)
        "dispatch": variant in DISPATCH_VARIANTS and variant != "rr",
    }


def make_router(variant: str, engine_ids: Sequence[int],
                cfg: Optional[GimbalConfig] = None,
                directory: Optional[PrefixDirectory] = None):
    f = variant_flags(variant)
    if f["dispatch"]:
        return ScoredRouter(engine_ids, cfg or GimbalConfig(),
                            directory=directory,
                            weights=DISPATCH_WEIGHTS[variant])
    cls = GimbalRouter if f["dplb"] else RoundRobinRouter
    return cls(engine_ids, cfg or GimbalConfig())


def make_queue(variant: str, cfg: Optional[GimbalConfig] = None) -> SJFQueue:
    f = variant_flags(variant)
    return SJFQueue(cfg or GimbalConfig(), policy="sjf" if f["sjf"] else "fcfs")


def _expert_policy(variant: str) -> str:
    if variant == "eplb":                 # count-only EPLB baseline
        return "eplb"
    return "gimbal" if variant_flags(variant)["edr"] else "static"


def _redundancy(variant: str, model_cfg: ModelConfig, num_devices: int,
                cfg: GimbalConfig) -> int:
    """Replica-slot count for this variant: GimbalConfig.redundancy, or one
    redundant slot per device (keeping E+R divisible by g) when unset."""
    if not variant_flags(variant)["rep"]:
        return 0
    r = cfg.redundancy if cfg.redundancy is not None else num_devices
    if (model_cfg.num_experts + r) % num_devices:
        raise ValueError(f"{num_devices} devices must divide "
                         f"E+R={model_cfg.num_experts + r}")
    return r


def make_rebalancer(variant: str, model_cfg: ModelConfig, num_devices: int,
                    cfg: Optional[GimbalConfig] = None, anchor: int = 0
                    ) -> Optional[ExpertRebalancer]:
    if not model_cfg.is_moe:
        return None  # expert level inapplicable to dense archs
    cfg = cfg or GimbalConfig()
    return ExpertRebalancer(model_cfg, num_devices,
                            policy=_expert_policy(variant), anchor=anchor,
                            cfg=cfg,
                            redundancy=_redundancy(variant, model_cfg,
                                                   num_devices, cfg))


def make_cluster_expert_level(variant: str, model_cfg: ModelConfig,
                              num_devices: int,
                              cfg: Optional[GimbalConfig] = None,
                              anchor: int = 0, prior_seed: Optional[int] = None,
                              hot_boost: float = 8.0):
    """The ONE expert level shared by every engine core in a cluster
    (§V-A.1: experts EP-shard across all engines' devices).  Serving passes
    it to each Engine; ``prior_seed`` seeds it with the synthetic prior.
    Non-MoE archs get the NullExpertLevel."""
    if not model_cfg.is_moe:
        return NullExpertLevel()
    cfg = cfg or GimbalConfig()
    return ClusterExpertLevel(model_cfg, num_devices,
                              policy=_expert_policy(variant), anchor=anchor,
                              cfg=cfg,
                              redundancy=_redundancy(variant, model_cfg,
                                                     num_devices, cfg),
                              prior_seed=prior_seed, hot_boost=hot_boost)


def make_sim_expert_level(variant: str, model_cfg: ModelConfig, num_devices: int,
                          cfg: Optional[GimbalConfig] = None, anchor: int = 0,
                          seed: int = 0, hot_boost: float = 8.0):
    """Simulator twin of make_cluster_expert_level: same policy wiring, the
    synthetic Fig.3/4 statistics installed as the prior (``seed`` plays the
    reference's ``jax.random.key(seed)``), plus the cost model's
    (moe_mult, cross_frac) coupling factors."""
    if not model_cfg.is_moe:
        return NullExpertLevel()
    cfg = cfg or GimbalConfig()
    return SyntheticExpertLevel(model_cfg, num_devices,
                                policy=_expert_policy(variant), anchor=anchor,
                                cfg=cfg, seed=seed, hot_boost=hot_boost,
                                redundancy=_redundancy(variant, model_cfg,
                                                       num_devices, cfg))
