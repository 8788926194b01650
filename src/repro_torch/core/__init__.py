"""Scheduling core of the port: the request level (SJF queue, preemption,
SLO accounting), the per-engine ``SchedulerCore``, the engine level (routers,
scored dispatch, the prefix directory) and the expert level (placement
solvers, affinity statistics, the Algorithm 3 rebalancer), ported from
``repro.core``."""
from repro_torch.core.types import (PRIORITY_CLASSES, EngineMetrics,
                                    GimbalConfig, Request, class_rank)
from repro_torch.core.router import GimbalRouter, RoundRobinRouter
from repro_torch.core.sjf import SJFQueue, fcfs_order, sjf_order
from repro_torch.core.preempt import (VICTIM_POLICIES, eligible_victims,
                                      reset_for_resume, select_victim)
from repro_torch.core.affinity import (AffinityTracker, accumulate_stats,
                                      synthetic_stats)
from repro_torch.core.placement import (
    assignment_to_perm, comm_cut, eplb_placement, eplb_placement_rep,
    gimbal_placement, gimbal_placement_rep, migration_cost, milp_exact,
    objective, perm_to_assignment, perm_to_slot_map, placement_coupling,
    rep_comm_cut, rep_migration_cost, rep_row_imbalance, row_imbalance,
    static_placement)
from repro_torch.core.eplb import (ClusterExpertLevel, ExpertRebalancer,
                                   NullExpertLevel, RebalanceEvent,
                                   SyntheticExpertLevel)
from repro_torch.core.gimbal import (DISPATCH_VARIANTS, VARIANTS,
                                     make_cluster_expert_level, make_queue,
                                     make_rebalancer, make_router,
                                     make_sim_expert_level, variant_flags)
from repro_torch.core.dispatch import (DISPATCH_WEIGHTS, DispatchCore,
                                       DispatchWeights, ScoredRouter)
from repro_torch.core.prefix_cache import PrefixCache, block_hashes
from repro_torch.core.prefix_directory import PrefixDirectory
from repro_torch.core.scheduler import (Backend, RunningSeq, SchedEvent,
                                        SchedulerCore)

__all__ = [
    "PRIORITY_CLASSES", "EngineMetrics", "GimbalConfig", "Request", "class_rank",
    "GimbalRouter", "RoundRobinRouter",
    "SJFQueue", "fcfs_order", "sjf_order",
    "VICTIM_POLICIES", "eligible_victims", "reset_for_resume", "select_victim",
    "AffinityTracker", "accumulate_stats", "synthetic_stats",
    "assignment_to_perm", "comm_cut", "eplb_placement", "eplb_placement_rep",
    "gimbal_placement", "gimbal_placement_rep", "migration_cost", "milp_exact",
    "objective", "perm_to_assignment", "perm_to_slot_map", "placement_coupling",
    "rep_comm_cut", "rep_migration_cost", "rep_row_imbalance", "row_imbalance",
    "static_placement",
    "ClusterExpertLevel", "ExpertRebalancer", "NullExpertLevel", "RebalanceEvent",
    "SyntheticExpertLevel",
    "DISPATCH_VARIANTS", "VARIANTS", "make_cluster_expert_level", "make_queue",
    "make_rebalancer", "make_router", "make_sim_expert_level", "variant_flags",
    "DISPATCH_WEIGHTS", "DispatchCore", "DispatchWeights", "ScoredRouter",
    "PrefixCache", "block_hashes", "PrefixDirectory",
    "Backend", "RunningSeq", "SchedEvent", "SchedulerCore",
]
