"""Scheduling core of the port: the request level (SJF queue, preemption,
SLO accounting) and the per-engine ``SchedulerCore``, copied from
``repro.core``, plus the ``NullExpertLevel``."""
from repro_torch.core.types import (PRIORITY_CLASSES, EngineMetrics,
                                    GimbalConfig, Request, class_rank)
from repro_torch.core.sjf import SJFQueue, fcfs_order, sjf_order
from repro_torch.core.preempt import (VICTIM_POLICIES, eligible_victims,
                                      reset_for_resume, select_victim)
from repro_torch.core.eplb import NullExpertLevel
from repro_torch.core.gimbal import (DISPATCH_VARIANTS, VARIANTS, make_queue,
                                     variant_flags)
from repro_torch.core.prefix_cache import PrefixCache, block_hashes
from repro_torch.core.scheduler import (Backend, RunningSeq, SchedEvent,
                                        SchedulerCore)

__all__ = [
    "PRIORITY_CLASSES", "EngineMetrics", "GimbalConfig", "Request", "class_rank",
    "SJFQueue", "fcfs_order", "sjf_order",
    "VICTIM_POLICIES", "eligible_victims", "reset_for_resume", "select_victim",
    "NullExpertLevel",
    "DISPATCH_VARIANTS", "VARIANTS", "make_queue", "variant_flags",
    "PrefixCache", "block_hashes",
    "Backend", "RunningSeq", "SchedEvent", "SchedulerCore",
]
