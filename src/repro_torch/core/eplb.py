"""Expert Dynamic Replacement: the Algorithm 3 loop, ported from
``repro.core.eplb``.

``ExpertRebalancer`` owns the AffinityTracker, re-evaluates placement every
tau engine steps, and emits a ``RebalanceEvent`` per relocation.  The anchor
device index is fixed at startup (paper: "manually specified before system
startup"), so affinity-linked experts never migrate repeatedly.

Placements are *slot maps* (core/placement.py): S = E + R physical slots ->
logical experts.  With ``redundancy`` R > 0 the solvers replicate the hottest
experts into the R redundant slots (DeepSeek-EPLB-style) and dispatch splits
their token streams across the copies.

``ClusterExpertLevel`` is the cluster-wide instance shared by every engine
core (§V-A.1): real routed stats from every ``TorchBackend`` aggregate into
the same AffinityTracker.  With ``prior_seed`` it starts from synthetic
Fig.3/4-shaped statistics (the simulator's operating mode, and a warm-start
prior for serving that observed traffic decays into).  The shared level ticks once per engine-step of EVERY sharing core, so
``tau`` counts aggregate core steps across the cluster.

``NullExpertLevel`` stands in for non-MoE architectures.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.affinity import AffinityTracker, synthetic_stats
from repro_torch.core.placement import (eplb_placement, eplb_placement_rep,
                                        gimbal_placement, gimbal_placement_rep,
                                        perm_to_slot_map, placement_coupling,
                                        rep_comm_cut, rep_migration_cost,
                                        rep_row_imbalance, static_placement)
from repro_torch.core.types import GimbalConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import ExpertPlacement


@dataclasses.dataclass
class RebalanceEvent:
    step: int
    moved_experts: int
    bytes_moved: int
    imbalance_before: float
    imbalance_after: float
    cut_before: float
    cut_after: float


class ExpertRebalancer:
    """policy: 'static' (vLLM default) | 'eplb' (count-only) | 'gimbal' (Alg. 3).

    ``redundancy`` R adds R replica slots for hot experts ((E+R) must divide
    the device count); R=0 reproduces the historical pure-permutation
    behaviour bit-for-bit (same solvers, same greedy tie-breaks)."""

    def __init__(self, model_cfg: ModelConfig, num_devices: int,
                 policy: str = "gimbal", anchor: int = 0,
                 cfg: Optional[GimbalConfig] = None, top_e: int = 16,
                 stats_decay: float = 0.8, redundancy: int = 0):
        if policy not in ("static", "eplb", "gimbal"):
            raise ValueError(f"unknown expert policy {policy!r}")
        self.model_cfg = model_cfg
        self.g = num_devices
        self.policy = policy
        self.anchor = anchor
        self.cfg = cfg or GimbalConfig()
        self.top_e = top_e
        self.redundancy = redundancy
        e = model_cfg.num_experts
        # the initial layout is the unreplicated static placement, so E
        # itself must divide g too, not just E+R
        if e % num_devices or (e + redundancy) % num_devices:
            raise ValueError(f"device count {num_devices} must divide E={e} "
                             f"and E+R={e + redundancy}")
        n_moe = sum(model_cfg.layer_is_moe(i) for i in range(model_cfg.num_layers))
        self.tracker = AffinityTracker(max(n_moe, 1), e, decay=stats_decay)
        # initial layout: the unreplicated static placement even when R > 0 —
        # physical backends start with exactly E weight rows, and replicas
        # only materialize when the first rebalance targets the observed hot
        # set (apply_placement then gathers the weight copies)
        self.slot_map = perm_to_slot_map(static_placement(e, num_devices))
        self.step = 0
        self.events: List[RebalanceEvent] = []
        self.moe_mult = 1.0
        self.cross_frac = 0.0
        # (step, moe_mult) after every placement update — the hotspot-
        # multiplier trajectory benchmarks/campaign.py emits
        self.factor_trail: List[Tuple[int, float]] = []
        self._update_factors()

    # --- hot path -----------------------------------------------------------------
    def observe(self, expert_ids) -> None:
        """Feed per-layer logical expert ids (L, B, S, K) from moe stats.
        In a shared cluster-wide level this aggregates traffic from EVERY
        engine into one statistics pool; synthetic prior mass (if seeded)
        decays away at the tracker's exponential rate as real traffic
        arrives."""
        self.tracker.update(expert_ids)

    def tick(self) -> Optional[np.ndarray]:
        """Advance one engine step; returns a NEW slot map when a relocation
        fires (Alg. 3 lines 6-9: every tau steps), else None."""
        self.step += 1
        if self.policy == "static" or self.step % self.cfg.tau != 0:
            return None
        return self.rebalance()

    def rebalance(self) -> np.ndarray:
        A, W = self.tracker.A, self.tracker.W
        if A.sum() == 0:
            return self.slot_map
        old = self.slot_map
        imb_before = rep_row_imbalance(A, old, self.g)
        cut_before = rep_comm_cut(W, old, self.g)
        if self.redundancy:
            if self.policy == "eplb":
                new = eplb_placement_rep(A, self.g, self.redundancy)
            else:
                new = gimbal_placement_rep(A, W, self.g, self.redundancy,
                                           anchor=self.anchor, top_e=self.top_e)
        else:           # historical pure-permutation solvers, bit-identical
            if self.policy == "eplb":
                new = perm_to_slot_map(eplb_placement(A, self.g))
            else:
                new = perm_to_slot_map(gimbal_placement(
                    A, W, self.g, anchor=self.anchor, top_e=self.top_e))
        moved, nbytes = rep_migration_cost(old, new, self.g,
                                           self.bytes_per_expert())
        self.events.append(RebalanceEvent(
            step=self.step, moved_experts=moved, bytes_moved=nbytes,
            imbalance_before=imb_before,
            imbalance_after=rep_row_imbalance(A, new, self.g),
            cut_before=cut_before,
            cut_after=rep_comm_cut(W, new, self.g)))
        self.slot_map = new
        self._update_factors()
        return new

    def _update_factors(self) -> None:
        """Engine-coupling factors from the CURRENT placement (sim/costmodel
        consumes them; replica-aware — a hot expert's load splits across its
        copies' devices):

          * ``moe_mult``   — hotspot multiplier, hottest device load / mean
                             (per layer, averaged);
          * ``cross_frac`` — fraction of inter-layer expert traffic crossing
                             a device boundary under the current placement.
        """
        A, W = self.tracker.A, self.tracker.W
        if A.sum() == 0:
            return
        self.moe_mult, self.cross_frac = placement_coupling(
            A, W, self.slot_map, self.g)
        self.factor_trail.append((self.step, self.moe_mult))

    def bytes_per_expert(self) -> int:
        c = self.model_cfg
        n_moe = sum(c.layer_is_moe(i) for i in range(c.num_layers))
        # the torch dtype's size: numpy knows no bfloat16 without ml_dtypes
        per_layer = 3 * c.d_model * c.moe_d_ff * c.adtype.itemsize
        return int(per_layer * n_moe)

    # --- counters (identical in serving and simulation) -------------------------
    @property
    def migrations(self) -> int:
        return len(self.events)

    @property
    def bytes_moved(self) -> int:
        return sum(e.bytes_moved for e in self.events)

    @property
    def num_slots(self) -> int:
        return len(self.slot_map)

    # --- placement consumed by the model ---------------------------------------------
    def placement(self) -> ExpertPlacement:
        return ExpertPlacement.from_slot_map(self.slot_map,
                                             self.tracker.num_experts)

    def placement_stack(self, n_scanned_layers: int) -> np.ndarray:
        """(L, S) slot map broadcast over layers — the paper's single global
        partition applied at every MoE layer."""
        return np.broadcast_to(self.slot_map,
                               (n_scanned_layers, len(self.slot_map))).copy()


class ClusterExpertLevel(ExpertRebalancer):
    """THE cluster-wide expert level, shared by every engine core (§V-A.1:
    experts are EP-sharded across all engines' devices).

    ``prior_seed`` is not None seeds the AffinityTracker with synthetic
    Fig.3/4-shaped (A, W) statistics — the simulator's operating mode, where
    no real traffic routes, and a warm-start prior for serving that observed
    traffic exponentially decays into (tracker decay < 1).  ``hot_boost``
    scales how hot the prior's hot experts run (the hot-expert-skew knob the
    campaign's hotspot cells turn)."""

    def __init__(self, model_cfg: ModelConfig, num_devices: int,
                 policy: str = "gimbal", anchor: int = 0,
                 cfg: Optional[GimbalConfig] = None, top_e: int = 16,
                 stats_decay: float = 0.8, redundancy: int = 0,
                 prior_seed: Optional[int] = None, hot_boost: float = 8.0):
        super().__init__(model_cfg, num_devices, policy=policy, anchor=anchor,
                         cfg=cfg, top_e=top_e, stats_decay=stats_decay,
                         redundancy=redundancy)
        if prior_seed is not None:
            A, W, _ = synthetic_stats(
                prior_seed,
                max(model_cfg.num_moe_layers(), 1), model_cfg.num_experts,
                top_k=model_cfg.moe_top_k, hot_boost=hot_boost)
            self.tracker.A[...] = A
            self.tracker.W[...] = W
            self.factor_trail.clear()
            self._update_factors()


class SyntheticExpertLevel(ClusterExpertLevel):
    """Back-compat alias: ClusterExpertLevel seeded with the synthetic prior
    (the simulator's historical entry point)."""

    def __init__(self, model_cfg: ModelConfig, num_devices: int,
                 policy: str = "gimbal", anchor: int = 0,
                 cfg: Optional[GimbalConfig] = None, top_e: int = 16,
                 seed: int = 0, redundancy: int = 0, hot_boost: float = 8.0):
        super().__init__(model_cfg, num_devices, policy=policy, anchor=anchor,
                         cfg=cfg, top_e=top_e, redundancy=redundancy,
                         prior_seed=seed, hot_boost=hot_boost)


class NullExpertLevel:
    """Expert level for non-MoE architectures: no placement to manage, unit
    coupling factors, empty event stream — so callers never branch on arch."""

    moe_mult = 1.0
    cross_frac = 0.0
    slot_map = None
    perm = None
    factor_trail: List[Tuple[int, float]] = []

    def __init__(self):
        self.events: List[RebalanceEvent] = []

    def observe(self, expert_ids) -> None:
        pass

    def tick(self) -> Optional[np.ndarray]:
        return None

    @property
    def migrations(self) -> int:
        return 0

    @property
    def bytes_moved(self) -> int:
        return 0
