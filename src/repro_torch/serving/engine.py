"""A single DP inference engine of the port: a thin shell over the unified
SchedulerCore (core/scheduler.py) with the real-compute TorchBackend
(serving/backend.py), ported from ``repro.serving.engine`` with the same
constructor and public surface.

By default the engine builds its own expert level from ``variant`` (the
paper's Algorithm 3, with replicas under "gimbal+rep"); pass a shared
``ClusterExpertLevel`` (core/gimbal.make_cluster_expert_level) to let every
engine of a cluster observe into and apply one placement, or ``None`` / a
``NullExpertLevel`` for none.

Timing is *logical*: callers pass ``now``, so behaviour is deterministic.
"""
from __future__ import annotations

from typing import Any, List, Optional

from repro_torch import tracing
from repro_torch.core.eplb import NullExpertLevel
from repro_torch.core.gimbal import make_queue, make_rebalancer
from repro_torch.core.scheduler import SchedulerCore
from repro_torch.core.types import EngineMetrics, GimbalConfig, Request
from repro_torch.models.config import ModelConfig
from repro_torch.serving.backend import TorchBackend


class _Private:
    """Sentinel: build this engine its own expert level."""

    def __repr__(self):
        return "<build a private expert level>"


_PRIVATE = _Private()


class Engine:
    def __init__(self, engine_id: int, model_cfg: ModelConfig, params: Any, *,
                 variant: str = "gimbal", gimbal_cfg: Optional[GimbalConfig] = None,
                 max_slots: int = 4, max_seq: int = 256, prefill_budget: int = 512,
                 num_expert_devices: int = 4, eos_id: Optional[int] = None,
                 dispatch_mode: str = "dense", expert_level: Any = _PRIVATE,
                 kv_layout: str = "slot", kv_block_size: int = 16,
                 kv_quant: Optional[str] = None, use_kernels: bool = False,
                 role: str = "unified", prefill_mode: str = "chunked",
                 device=None):
        """``expert_level`` should be the ONE ClusterExpertLevel shared by
        every engine of a cluster: routed stats from every engine aggregate
        into the same tracker and all engines apply the same placements.
        When omitted, the engine builds a private level over
        ``num_expert_devices`` devices."""
        self.engine_id = engine_id
        self.cfg = model_cfg
        self.gcfg = gimbal_cfg or GimbalConfig()
        self.role = role
        if expert_level is _PRIVATE:
            rebalancer = make_rebalancer(variant, model_cfg,
                                         num_expert_devices, self.gcfg)
        else:
            rebalancer = (None if isinstance(expert_level, NullExpertLevel)
                          else expert_level)
        self.backend = TorchBackend(model_cfg, params, max_slots=max_slots,
                                    max_seq=max_seq, eos_id=eos_id,
                                    dispatch_mode=dispatch_mode,
                                    rebalancer=rebalancer,
                                    kv_layout=kv_layout,
                                    kv_block_size=kv_block_size,
                                    kv_quant=kv_quant, use_kernels=use_kernels,
                                    device=device)
        self.core = SchedulerCore(self.backend, make_queue(variant, self.gcfg),
                                  self.gcfg, prefill_budget=prefill_budget,
                                  engine_id=engine_id, expert_level=rebalancer,
                                  prefill_mode=prefill_mode)

    # ------------------------------------------------------------------ public API
    def submit(self, r: Request, now: float = 0.0) -> bool:
        """False when SLO-aware admission control shed the request."""
        return self.core.submit(r, now)

    def metrics(self, now: float) -> EngineMetrics:
        return self.core.metrics(now)

    def num_active(self) -> int:
        return self.core.num_running()

    def step(self, now: float) -> List[Request]:
        """One continuous-batching iteration.  Returns requests finished this
        step (all decisions in SchedulerCore.step).  A step first reads
        whether a profiler records (``tracing.poll``); while one does, the
        step keeps its spans and counters."""
        tracing.poll()
        with tracing.span("step"):
            _, finished = self.core.step(now)
        return finished

    def drain_all(self, migrate: bool = False) -> List[Request]:
        """Pull every request (waiting + running) off this engine."""
        return self.core.drain(migrate=migrate)

    # ------------------------------------------------------------------ delegation
    @property
    def queue(self):
        return self.core.queue

    @property
    def prefix(self):
        return self.core.prefix

    @property
    def rebalancer(self):
        return self.core.expert

    @property
    def kv(self):
        return self.backend.kv

    @property
    def params(self):
        return self.backend.params

    @property
    def slot_req(self):
        return self.backend.slot_req

    @property
    def slot_last_token(self):
        return self.backend.slot_last_token

    @property
    def max_slots(self) -> int:
        return self.backend.max_slots

    @property
    def max_seq(self) -> int:
        return self.backend.max_seq

    @property
    def steps(self) -> int:
        return self.core.steps

    @property
    def preemptions(self) -> int:
        return self.core.preemptions

    @property
    def relocations(self) -> int:
        return self.backend.relocations

    @property
    def prefill_budget(self) -> int:
        return self.core.prefill_budget

    @prefill_budget.setter
    def prefill_budget(self, v: int) -> None:
        self.core.prefill_budget = v

    @property
    def healthy(self) -> bool:
        return self.core.healthy

    @healthy.setter
    def healthy(self, v: bool) -> None:
        self.core.healthy = v
