"""TorchBackend: the real-compute execution substrate behind SchedulerCore,
ported from ``repro.serving.backend.JaxBackend``.

Owns everything physical about serving — the prefill/decode calls, the
device KV cache (fixed slots or paged), the per-slot last-token state, and
expert-weight relocation when the expert level fires.  Every scheduling
*decision* (admission, preemption, completion) is made by
core/scheduler.py; this module only executes them.  Prompts are padded to power-of-two buckets, as
the reference pads them for its jit cache, so that MoE capacities (which
depend on the token count) match the reference.  The padded row is
prefilled whole, so an SSM's decode state has run through the pad tokens,
as the reference's has (ROADMAP.md, Queue 3).

Timing is logical: ``step_time`` returns the caller-supplied ``now``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import device as devlib
from repro_torch import tracing
from repro_torch.core.types import Request
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvcache import PagedKVCache, SlotKVCache, write_slot


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class TorchBackend:
    """Backend protocol implementation over the real PyTorch model.

    ``charge_prefix_hits`` is False: the live engine recomputes the full
    prefill (its prefix cache is a routing/affinity signal, not block reuse),
    so admission must charge the full prompt length against the budget.
    Decode runs all ``max_slots`` rows, inactive ones included, as the
    reference does: inactive rows still route through the MoE and take
    capacity positions, so the batch must match for drops to match.
    """

    charge_prefix_hits = False

    def __init__(self, model_cfg: ModelConfig, params: Any, *,
                 max_slots: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None, dispatch_mode: str = "dense",
                 rebalancer=None, kv_layout: str = "slot",
                 kv_block_size: int = 16, kv_quant: Optional[str] = None,
                 use_kernels: bool = False, device=None):
        """``use_kernels`` takes paged flash-decode on the paged layout; the
        slot layout's attention is plain PyTorch.  Unlike the reference's
        backend, an MLA model decodes in latent space (``mla_decode``'s
        ``absorb=True``: the same mathematics, with no per-position keys or
        values built); its prefill decompresses, as the reference's does.
        The MoE kernels follow ``dispatch_mode="fused"`` on either layout."""
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        self.device = devlib.resolve(device)
        self.cfg = model_cfg
        self.params = params
        self.rebalancer = rebalancer
        self.kv_layout = kv_layout
        self.use_kernels = use_kernels
        if kv_layout == "paged":
            self.kv = PagedKVCache(model_cfg, max_slots, max_seq,
                                   block_size=kv_block_size,
                                   quantize=(kv_quant == "int8"), device=self.device)
            # block-granular accounting: SchedulerCore rounds every per-request
            # charge up to whole blocks and gates admission on distinct blocks
            self.kv_block_size = kv_block_size
            kv_capacity = self.kv.capacity_tokens
        else:
            self.kv = SlotKVCache(model_cfg, max_slots, max_seq, device=self.device)
            self.kv_block_size = 1
            kv_capacity = max_slots * max_seq
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.dispatch_mode = dispatch_mode
        self.max_concurrency = max_slots
        self.kv_capacity = kv_capacity
        # prompts are physically truncated to the slot length (see start())
        self.max_ctx_tokens: Optional[int] = max_seq
        self.n_layers = model_cfg.num_layers
        # optional offline-profiled cost model powering est_iter_time; None =
        # SLO-aware shedding never fires here
        self.cost_hint = None
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.slot_last_token = np.zeros(max_slots, np.int32)
        self.relocations = 0
        self._n_scan = model_cfg.num_moe_layers()
        self._applied_map: Optional[np.ndarray] = None   # slot -> logical

    # ------------------------------------------------------------------ placement
    def _placements(self):
        if self.rebalancer is None:
            return None
        return torch.as_tensor(self.rebalancer.placement_stack(self._n_scan),
                               dtype=torch.int32, device=self.device)

    def _sync_placement(self) -> None:
        """Catch up with the (possibly cluster-shared) expert level: weights
        and placement always move together."""
        rb = self.rebalancer
        if rb is None or getattr(rb, "slot_map", None) is None:
            return
        tgt = np.asarray(rb.slot_map)
        cur = self._applied_map
        if cur is None:
            cur = np.arange(self.cfg.num_experts)   # initial identity layout
        if not np.array_equal(cur, tgt):
            self.apply_placement(tgt)

    @property
    def _stats(self) -> bool:
        return self.cfg.is_moe and self.rebalancer is not None

    # ------------------------------------------------------------------ Backend protocol
    @torch.no_grad()
    def start(self, r: Request, now: float) -> Tuple[int, Optional[np.ndarray]]:
        with tracing.span("prefill"):
            return self._prefill(r)

    def _prefill(self, r: Request) -> Tuple[int, Optional[np.ndarray]]:
        self._sync_placement()
        plen = min(r.prompt_len, self.max_seq - 1)
        if r.prompt_tokens is not None:
            toks = np.asarray(r.prompt_tokens, np.int32).reshape(-1)[:plen]
        else:
            rng = np.random.default_rng(r.req_id)
            toks = rng.integers(0, self.cfg.vocab_size, plen).astype(np.int32)
        if self.kv_layout == "paged":
            # share only when the core's block accounting also shared: real
            # tokens, not a migrated sequence (its KV travelled, all private)
            share = (r.prompt_tokens is not None
                     and not getattr(r, "kv_migrated", False))
            slot = self.kv.alloc(plen, toks.tolist() if share else None)
        else:
            slot = self.kv.alloc()
        if slot is None:
            raise RuntimeError("SchedulerCore admitted past slot capacity")
        bl = _bucket(plen)
        padded = np.zeros(bl, np.int64)
        padded[:plen] = toks
        with tracing.span("prefill.model"):
            slot_cache = M.init_cache(self.cfg, 1, bl, device=self.device)
            logits, slot_cache, aux = M.prefill(
                self.params, self.cfg, torch.as_tensor(padded, device=self.device)[None],
                slot_cache, placements=self._placements(),
                dispatch_mode=self.dispatch_mode)
        with tracing.span("prefill.kv_write"):
            if self.kv_layout == "paged":
                self.kv.write_prefill(slot, slot_cache)
            else:
                write_slot(self.kv.cache, slot_cache, slot, self.kv.write_axes)
        self.slot_req[slot] = r
        self.kv.slot_len[slot] = plen
        with tracing.span("prefill.readback"):
            self.slot_last_token[slot] = int(torch.argmax(logits[0, plen - 1]))
            stats = None
            if "expert_ids" in aux:
                stats = aux["expert_ids"].cpu().numpy()[:, :, :plen]
        return slot, stats

    @torch.no_grad()
    def decode(self, active: Sequence[Tuple[int, Request]], now: float
               ) -> Tuple[Set[int], Optional[np.ndarray]]:
        with tracing.span("decode"):
            return self._decode(active)

    def _decode(self, active: Sequence[Tuple[int, Request]]
                ) -> Tuple[Set[int], Optional[np.ndarray]]:
        self._sync_placement()
        tracing.count("decode_rows_live", len(active))
        tracing.count("decode_rows", self.max_slots)
        with tracing.span("decode.inputs"):
            tokens = torch.as_tensor(self.slot_last_token.astype(np.int64),
                                     device=self.device)[:, None]
            pos = self.kv.positions()
            if self.kv_layout == "paged":
                for slot, _r in active:
                    self.kv.prepare_append(slot)     # alloc/CoW tail pages
                tables = self.kv.device_tables()
            placements = self._placements()
        with tracing.span("decode.model"):
            if self.kv_layout == "paged":
                logits, _, aux = M.decode_step_paged(
                    self.params, self.cfg, tokens, self.kv.pages, tables, pos,
                    placements=placements, stats=self._stats,
                    dispatch_mode=self.dispatch_mode, use_kernel=self.use_kernels)
            else:
                # MLA scores in latent space over the compressed cache; GQA
                # ignores ``mla_absorb``
                logits, _, aux = M.decode_step(
                    self.params, self.cfg, tokens, self.kv.cache, pos,
                    placements=placements, stats=self._stats,
                    dispatch_mode=self.dispatch_mode, mla_absorb=True)
        with tracing.span("decode.readback"):
            nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        eos: Set[int] = set()
        rows = []
        for slot, r in active:
            rows.append(slot)
            self.slot_last_token[slot] = nxt[slot]
            self.kv.slot_len[slot] = min(self.kv.slot_len[slot] + 1,
                                         self.max_seq - 1)
            if self.eos_id is not None and nxt[slot] == self.eos_id:
                eos.add(r.req_id)
        stats = None
        if "expert_ids" in aux and rows:
            with tracing.span("decode.stats"):
                stats = aux["expert_ids"].cpu().numpy()[:, rows]   # (L, B, 1, K)
        return eos, stats

    def release(self, handle: int, r: Request) -> None:
        self.slot_req[handle] = None
        self.kv.free(handle)

    def step_time(self, now: float, prefill_tokens: int, decode_batch: int,
                  avg_ctx: float, queue_len: int,
                  layer_jobs: Optional[Sequence[int]] = None) -> float:
        return now      # logical clock: the caller owns time

    def transfer_time(self, kv_tokens: int) -> float:
        """Disaggregated hand-off cost: free on the logical clock."""
        return 0.0

    def est_iter_time(self, prefill_tokens: int, decode_batch: int,
                      avg_ctx: float, queue_len: int) -> float:
        """Admission-control hint from ``cost_hint`` (an offline-profiled cost
        model); 0.0 without one, so SLO-aware shedding never fires."""
        if self.cost_hint is None:
            return 0.0
        return self.cost_hint.iteration_time(prefill_tokens, decode_batch,
                                             avg_ctx, queue_len=queue_len)

    def kv_usage(self, kv_tokens: int) -> float:
        if self.kv_layout == "paged":
            # the core passes blocks_used * block_size as kv_tokens in block mode
            return min(kv_tokens / max(self.kv_capacity, 1), 1.0)
        return self.kv.usage()

    def apply_placement(self, new_map: np.ndarray) -> None:
        """The expert level re-solved placement: gather the stacked expert
        weights into the new slot layout (``new_map``: S = E + R slots ->
        logical expert; a replicated expert's weights are copied into each of
        its slots).  Param trees without a stacked 'moe' block are left
        untouched and do NOT count as a relocation."""
        blocks = self.params["blocks"]
        if "moe" not in blocks:
            return
        new_map = np.asarray(new_map)
        old_map = self._applied_map
        if old_map is None:
            old_map = np.arange(self.cfg.num_experts)
        if np.array_equal(old_map, new_map):
            return                  # already laid out — not a relocation
        self.relocations += 1
        # each new slot gathers from ONE old slot holding its expert (the
        # expert's first old slot — every expert has >= 1)
        old_primary = np.full(self.cfg.num_experts, -1, np.int64)
        for s in range(len(old_map) - 1, -1, -1):
            old_primary[int(old_map[s])] = s
        gather_idx = old_primary[new_map]
        if (gather_idx < 0).any():
            raise ValueError("new placement names an unknown expert")
        idx = torch.as_tensor(gather_idx, device=self.device)
        moe = dict(blocks["moe"])
        for name in ("w_gate", "w_up", "w_down"):
            moe[name] = blocks["moe"][name][:, idx]
        self.params = {**self.params, "blocks": {**blocks, "moe": moe}}
        self._applied_map = new_map.copy()
