"""Port copy of ``repro.core.scheduler``: host-side Python with no framework in it,
kept line for line so both packages make byte-identical decisions; only the
port records spans (``repro_torch.tracing``, on while a profiler runs).

SchedulerCore: the backend-agnostic per-engine scheduling state machine.

One implementation of the paper's request-level decisions — SJF/FCFS waiting
queue with aging (Alg. 2), chunked-prefill admission budget, continuous-
batching capacity, priority preemption with victim selection, KV + prefix-
cache token accounting, per-step metrics — shared by the live engine
(serving/engine.py) and the discrete-event simulator (sim/simulator.py).

An admission or preemption decision cannot differ between simulation and
serving: both shells
delegate every decision to SchedulerCore and only differ in their Backend —
what a "prefill" or "decode" physically does and how long a step takes.

The Backend protocol is intentionally small:

  * capacity:     ``max_concurrency`` (decode slots / max running batch) and
                  ``kv_capacity`` (KV pool size in tokens) gate admission;
  * execution:    ``start`` / ``decode`` / ``release`` perform (or skip) the
                  actual compute and may emit per-step expert routing stats,
                  which the core feeds to the expert level (core/eplb.py);
  * time:         ``step_time`` maps one core iteration to a timestamp — the
                  live engine is logically clocked by the caller, the
                  simulator answers from the roofline cost model;
  * accounting:   ``charge_prefix_hits`` controls whether prefix-cache hits
                  reduce the prefill budget charge (the simulator models
                  vLLM's block reuse; the live engine recomputes the full
                  prefill and must not under-charge).

Event stream: every admit / preempt / finish / shed / downclass decision is
appended to ``SchedulerCore.events`` in decision order.  The differential
parity test (tests/test_scheduler_parity.py) drives the same trace through
both backends and asserts the streams are identical — the refactor's
acceptance oracle.

SLO-aware admission control (GimbalConfig.enable_shedding): at submit, a
request whose TTFT deadline is already unmeetable — estimated from queue
depth × the backend's calibrated cost model (``est_iter_time``) — is
rejected (``shed_mode="reject"``) or demoted to the lowest priority class
(``"downclass"``) instead of ballooning the queue.  Shed requests count as
SLO misses (core/slo.py), so shedding only raises attainment by letting the
survivors actually meet their deadlines — goodput degrades gracefully under
flash crowds / engine loss instead of cliff-diving.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, Set, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.core.predictor import make_predictor
from repro_torch.core.preempt import (eligible_victims, reset_for_resume,
                                select_victim)
from repro_torch.core.sjf import SJFQueue, order_key
from repro_torch.core.slo import SLOTracker
from repro_torch.core.types import (PRIORITY_CLASSES, EngineMetrics, GimbalConfig,
                              Request)
from repro_torch.core.prefix_cache import PrefixCache, block_hashes


@dataclasses.dataclass(frozen=True)
class SchedEvent:
    """One scheduling decision, in decision order.  ``step`` is the engine-
    local iteration index; timestamps are deliberately excluded so the live
    engine and the simulator emit byte-identical streams."""
    kind: str          # "admit" | "preempt" | "finish"
    step: int
    req_id: int


@dataclasses.dataclass
class RunningSeq:
    """A request holding a decode seat.  ``handle`` is backend-opaque (KV slot
    index for the JAX backend, None for the cost-model backend)."""
    r: Request
    handle: object
    admit_time: float


@dataclasses.dataclass
class LayeredPrefill:
    """A request mid-prefill under ``prefill_mode="layered"``: its prefill is
    ``n_layers`` micro-steps that interleave with decode at layer boundaries
    (instead of token-chunk boundaries).  ``tokens`` is the budget charge
    captured at admission — the token count each micro-step re-touches."""
    r: Request
    tokens: int
    layers_done: int
    admit_time: float


class Backend(Protocol):
    """What SchedulerCore needs from an execution substrate."""

    max_concurrency: int        # decode slots (JAX) / max running batch (sim)
    kv_capacity: int            # KV pool size in tokens
    max_ctx_tokens: Optional[int]   # per-request resident-KV cap (None = no cap)
    charge_prefix_hits: bool    # prefix-cache hits reduce the budget charge

    def start(self, r: Request, now: float) -> Tuple[object, Optional[np.ndarray]]:
        """Begin serving ``r`` (prefill).  Returns (handle, routing stats)."""
        ...

    def decode(self, active: Sequence[Tuple[object, Request]], now: float
               ) -> Tuple[Set[int], Optional[np.ndarray]]:
        """One decode step for every (handle, request) pair.  Returns
        (req_ids that hit EOS, routing stats)."""
        ...

    def release(self, handle: object, r: Request) -> None:
        """Free the seat/KV held by ``handle`` (finish, preempt, drain)."""
        ...

    def apply_placement(self, perm: np.ndarray) -> None:
        """The expert level re-solved placement: relocate expert state."""
        ...

    def step_time(self, now: float, prefill_tokens: int, decode_batch: int,
                  avg_ctx: float, queue_len: int,
                  layer_jobs: Optional[Sequence[int]] = None) -> float:
        """Timestamp at which this iteration's tokens materialize.
        ``layer_jobs`` (layered prefill mode only): token counts of the
        in-flight prefills each advancing ONE model layer this iteration —
        charged per CostModel.prefill_layer_time instead of the fused
        ``prefill_tokens`` path.  Chunked-mode callers never pass it."""
        ...

    def kv_usage(self, kv_tokens: int) -> float:
        """Fraction of KV capacity in use, in [0, 1] (Alg. 1 signal)."""
        ...

    def est_iter_time(self, prefill_tokens: int, decode_batch: int,
                      avg_ctx: float, queue_len: int) -> float:
        """Estimated wall seconds for one iteration (admission-control
        hint; 0.0 = no estimate available, shedding never fires)."""
        ...


_UNBLOCKED_RANK = len(PRIORITY_CLASSES) + 1


class SchedulerCore:
    """The full per-engine scheduling state machine (request + expert levels;
    the engine level consumes the metrics this core emits)."""

    def __init__(self, backend: Backend, queue: SJFQueue,
                 gcfg: Optional[GimbalConfig] = None, *,
                 prefill_budget: int = 512, engine_id: int = 0,
                 expert_level=None, prefix_cache: Optional[PrefixCache] = None,
                 prefill_mode: str = "chunked"):
        if prefill_mode not in ("chunked", "layered"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        self.backend = backend
        self.queue = queue
        self.gcfg = gcfg or GimbalConfig()
        self.prefill_budget = prefill_budget
        # --- prefill admission state machine ---------------------------------
        # "chunked" (historical): an admitted request prefills whole in its
        # admission step, fused with that step's decode batch.  "layered": an
        # admitted request's prefill becomes n_layers micro-steps — one model
        # layer per engine iteration — so decode interleaves at every layer
        # boundary and only ever stalls for ONE layer of prefill (the paper
        # family's layered-prefill admission; backends charge micro-steps via
        # ``step_time(..., layer_jobs=...)`` / CostModel.prefill_layer_time).
        # Requests with nothing to prefill (fully prefix-cached, KV-migrated
        # hand-offs) skip the pipeline and start in their admission step.
        self.prefill_mode = prefill_mode
        self.n_layers = max(int(getattr(backend, "n_layers", 1)), 1)
        self._prefilling: List[LayeredPrefill] = []
        self.engine_id = engine_id
        self.expert = expert_level
        self.prefix = prefix_cache if prefix_cache is not None else PrefixCache()
        self.running: List[RunningSeq] = []
        self.ctx_tokens: Dict[int, int] = {}   # req_id -> resident KV tokens
        self.kv_tokens = 0                     # == sum(ctx_tokens.values())
        # --- block-granular KV accounting (paged backends) -------------------
        # When the backend declares kv_block_size > 1 (PagedKVCache), the pool
        # gate switches from summed tokens to DISTINCT blocks: every per-
        # request charge rounds up to whole blocks and full prompt blocks
        # shared with an already-resident request are pinned (refcounted), not
        # double-counted — mirroring the device pool's copy-on-write prefix
        # sharing so admission reflects true block occupancy.  With
        # kv_block_size == 1 (slot layout, cost-model default) every block
        # path below is skipped and behaviour is byte-identical to before.
        self.kv_blocks = 0                      # distinct resident blocks
        self._shared_refs: Dict[int, int] = {}  # block hash -> pin count
        self._req_blocks: Dict[int, int] = {}   # req_id -> total blocks held
        self._req_shared: Dict[int, List[int]] = {}  # req_id -> pinned hashes
        # output-length predictor (core/predictor.py): built from the shared
        # GimbalConfig so both planes construct identical instances, attached
        # to the queue so SJF ranks by predicted remaining work (SRPT), and
        # fed every finish event below so the histogram predictor learns
        # from a stream that is byte-identical across planes
        self.predictor = make_predictor(self.gcfg.predictor,
                                        seed=self.gcfg.predictor_seed)
        if self.predictor is not None:
            self.queue.predictor = self.predictor
        self.steps = 0
        self.preemptions = 0
        self.hedged_away = 0          # requests the cluster hedged off this queue
        self.healthy = True
        self.events: List[SchedEvent] = []
        # SLO-attainment / goodput accounting per (tenant, class) — the same
        # tracker code in both planes, parity-tested alongside the events
        self.slo = SLOTracker()
        # requests rejected by SLO-aware admission control (terminal: they
        # never enter the queue; cluster/simulator drain accounting counts
        # them alongside finishes)
        self.shed: List[Request] = []

    # ------------------------------------------------------------------ intake
    def estimate_ttft(self, r: Request, now: float) -> float:
        """Admission-control TTFT estimate, a pure function of core state so
        the serving and sim planes decide identically.

        Without a predictor: the WHOLE queue's waiting tokens + ``r``'s own
        prompt, worked off in chunked-prefill iterations each dated by the
        backend's calibrated cost model.  Deliberately conservative-simple —
        a queue-depth × service-rate product that ignores queue discipline,
        which is why ``shed_slack`` historically needed to sit well above 1
        to compensate.

        With a predictor: only the backlog actually RANKED AHEAD of ``r``
        under the live queue ordering (order_key: aging, class, predicted-
        remaining work) counts — under SJF/SRPT a small interactive request
        does not wait behind the large batch prompts it outranks.  The
        sharper estimate is what lets shedding run at ``shed_slack = 1.0``."""
        if self.predictor is not None:
            k = order_key(r, now, self.gcfg, self.predictor)
            tokens_ahead = r.prompt_len + sum(
                w.prompt_len for w in self.queue
                if order_key(w, now, self.gcfg, self.predictor) < k)
        else:
            tokens_ahead = self.queue.waiting_tokens + r.prompt_len
        if tokens_ahead <= 0:
            return 0.0
        chunk = max(self.prefill_budget, 1)
        iters = -(-tokens_ahead // chunk)       # ceil
        avg_ctx = (float(np.mean(list(self.ctx_tokens.values())))
                   if self.ctx_tokens else 0.0)
        # the final chunk is usually PARTIAL: price it at its actual size
        # instead of a full chunk (pricing every iteration at full-chunk
        # est_iter_time over-charged remainders by up to one chunk's worth
        # of prefill, inflating shed decisions near the deadline)
        rem = tokens_ahead - (iters - 1) * chunk
        per_rem = self.backend.est_iter_time(rem, len(self.running), avg_ctx,
                                             queue_len=len(self.queue))
        if iters == 1:
            return per_rem
        per_full = self.backend.est_iter_time(chunk, len(self.running),
                                              avg_ctx,
                                              queue_len=len(self.queue))
        return (iters - 1) * per_full + per_rem

    def _maybe_shed(self, r: Request, now: float) -> bool:
        """SLO-aware admission control: True = rejected (do not enqueue).
        Only TTFT-carrying requests that have not yet produced a first token
        are candidates — a KV-migrated orphan that already hit TTFT
        elsewhere is never shed, it re-queues with its progress."""
        if (not self.gcfg.enable_shedding or r.slo_ttft is None
                or r.first_token_time is not None):
            return False
        deadline = r.arrival_time + r.slo_ttft * self.gcfg.shed_slack
        if now + self.estimate_ttft(r, now) <= deadline:
            return False
        if (self.gcfg.shed_mode == "downclass"
                and r.priority_class != PRIORITY_CLASSES[-1]):
            # demote instead of drop: it keeps its tokens but yields its
            # seat-priority to traffic that can still make its deadline
            r.priority_class = PRIORITY_CLASSES[-1]
            self.events.append(SchedEvent("downclass", self.steps, r.req_id))
            return False
        r.shed_time = now
        self.shed.append(r)
        self.slo.observe_shed(r)
        self.events.append(SchedEvent("shed", self.steps, r.req_id))
        return True

    def submit(self, r: Request, now: float = 0.0) -> bool:
        """Enqueue ``r`` (False = rejected by SLO-aware shedding)."""
        if self._maybe_shed(r, now):
            return False
        if r.prompt_tokens is not None:
            toks = list(np.asarray(r.prompt_tokens).reshape(-1))
            hits = self.prefix.match(toks, now)
            self.prefix.insert(toks, now)
            r._cached = hits if self.backend.charge_prefix_hits else 0
        if r.kv_migrated:
            # the KV pages travelled with the request: nothing to re-prefill
            # regardless of what this engine's local cache holds
            r._cached = r.prompt_len
        self.queue.push(r)
        return True

    # ------------------------------------------------------------------ metrics
    def metrics(self, now: float) -> EngineMetrics:
        """The single metrics path: Cluster/MetricsBus snapshots come from
        core accounting in both serving and simulation."""
        bs = self.kv_block_size
        # block mode: w_kv (Alg. 1) reads true block occupancy — rounded-up,
        # shared-deduplicated — not the optimistic token sum
        kv_held = self.kv_blocks * bs if bs > 1 else self.kv_tokens
        return EngineMetrics(
            engine_id=self.engine_id,
            kv_usage=self.backend.kv_usage(kv_held),
            running_load=self.kv_tokens + self.queue.waiting_tokens,
            num_running=len(self.running) + len(self._prefilling),
            num_waiting=len(self.queue),
            timestamp=now,
            healthy=self.healthy,
            num_hedged=self.hedged_away,
        )

    @property
    def idle(self) -> bool:
        return (not self.running and not self._prefilling
                and len(self.queue) == 0)

    def num_running(self) -> int:
        return len(self.running) + len(self._prefilling)

    def running_requests(self) -> List[Request]:
        return [seq.r for seq in self.running]

    # ------------------------------------------------------------------ admission
    def _charge(self, r: Request) -> int:
        """Prefill tokens this request charges against the chunked budget."""
        return r.prompt_len - min(getattr(r, "_cached", 0), r.prompt_len)

    def _kv_demand(self, r: Request) -> int:
        """Resident KV tokens ``r`` will actually hold if admitted: the
        backend may truncate prompts (JaxBackend clips to the slot length),
        so the pool must not be charged for tokens that never materialize —
        otherwise an over-long prompt the backend would happily serve
        truncated is starved forever by the capacity gate.  A KV-migrated
        orphan arrives holding its generated tokens too."""
        base = r.prompt_len + (r.generated if r.kv_migrated else 0)
        cap = self.backend.max_ctx_tokens
        return base if cap is None else min(base, cap)

    def _grow_ctx(self, req_id: int) -> None:
        """One more resident token for ``req_id``, capped at the backend's
        per-request limit (mirrors JaxBackend's slot_len clipping)."""
        cap = self.backend.max_ctx_tokens
        ctx = self.ctx_tokens[req_id]
        new = ctx + 1 if cap is None else min(ctx + 1, cap)
        self.ctx_tokens[req_id] = new
        self.kv_tokens += new - ctx
        bs = self.kv_block_size
        if bs > 1 and new != ctx:
            # decode growth past a block boundary claims one more (private)
            # block — the same point at which PagedKVCache.prepare_append
            # pops a fresh block from the device free list
            nb = -(-new // bs)
            if nb > self._req_blocks.get(req_id, 0):
                self.kv_blocks += nb - self._req_blocks[req_id]
                self._req_blocks[req_id] = nb

    # ------------------------------------------------------------ block accounting
    @property
    def kv_block_size(self) -> int:
        """KV allocation granularity: 1 (token/slot accounting) unless the
        backend declares a paged block size."""
        return getattr(self.backend, "kv_block_size", 1)

    def _prompt_hashes(self, r: Request) -> List[int]:
        """Shareable full-prompt-block hashes for ``r`` — the exact set the
        paged backend would pin: real tokens only (a KV-migrated sequence's
        pages travelled with it, all private), clipped to the backend's
        resident prompt length."""
        if (r.prompt_tokens is None or getattr(r, "kv_migrated", False)):
            return []
        cap = self.backend.max_ctx_tokens
        plen = r.prompt_len if cap is None else min(r.prompt_len, cap - 1)
        toks = list(np.asarray(r.prompt_tokens).reshape(-1))[:plen]
        return block_hashes(toks, self.kv_block_size)

    def _demand_blocks(self, r: Request, refs: Optional[Dict[int, int]] = None
                       ) -> int:
        """NEW distinct blocks ``r`` would claim if admitted now: its rounded-
        up demand minus the leading run of prompt blocks already resident
        (prefix property: device reuse stops at the first absent block)."""
        bs = self.kv_block_size
        refs = self._shared_refs if refs is None else refs
        m = 0
        for h in self._prompt_hashes(r):
            if h not in refs:
                break
            m += 1
        return -(-self._kv_demand(r) // bs) - m

    def _admit_blocks(self, r: Request) -> None:
        """Pin ``r``'s shared prompt blocks (refcount++) and charge its
        private remainder against the distinct-block pool."""
        bs = self.kv_block_size
        if bs <= 1:
            return
        hashes = self._prompt_hashes(r)
        for h in hashes:
            if h in self._shared_refs:
                self._shared_refs[h] += 1
            else:
                self._shared_refs[h] = 1
                self.kv_blocks += 1
        total = -(-self._kv_demand(r) // bs)
        self.kv_blocks += total - len(hashes)
        self._req_blocks[r.req_id] = total
        self._req_shared[r.req_id] = hashes

    def _release_blocks(self, req_id: int) -> None:
        """Undo ``_admit_blocks`` + decode growth: private blocks return to
        the pool immediately; shared blocks only when their last pin drops
        (matching the device pool's refcounted free)."""
        if self.kv_block_size <= 1:
            return
        total = self._req_blocks.pop(req_id, 0)
        hashes = self._req_shared.pop(req_id, [])
        self.kv_blocks -= total - len(hashes)
        for h in hashes:
            self._shared_refs[h] -= 1
            if self._shared_refs[h] == 0:
                del self._shared_refs[h]
                self.kv_blocks -= 1

    def _blocked(self, r: Request, n_admitted: int) -> bool:
        """Admission blocked for ``r`` under the batch/KV-capacity limits.
        Block mode gates on distinct blocks — rounding every charge up while
        not double-counting shared prefix blocks — because that, not the
        token sum, is what exhausts a paged device pool."""
        if (len(self.running) + len(self._prefilling) + n_admitted
                >= self.backend.max_concurrency):
            return True
        bs = self.kv_block_size
        if bs > 1:
            return (self.kv_blocks + self._demand_blocks(r)
                    > self.backend.kv_capacity // bs)
        return self.kv_tokens + self._kv_demand(r) > self.backend.kv_capacity

    def _eviction_unblocks(self, r: Request, n_admitted: int) -> bool:
        """True iff evicting every preemptible victim would make ``r`` fit —
        the feasibility gate before destroying any batch progress.  Block
        mode simulates the refcounted frees: a shared block only returns to
        the pool if EVERY pinning victim is evicted, and ``r``'s own demand
        is re-derived against the post-eviction resident set."""
        evictable = [v for _, v in eligible_victims(
            [(seq.handle, seq.r) for seq in self.running], r.rank, self.gcfg)]
        run_after = (len(self.running) + len(self._prefilling)
                     - len(evictable) + n_admitted)
        if run_after >= self.backend.max_concurrency:
            return False
        bs = self.kv_block_size
        if bs > 1:
            refs = dict(self._shared_refs)
            blocks_after = self.kv_blocks
            for v in evictable:
                total = self._req_blocks.get(v.req_id, 0)
                hs = self._req_shared.get(v.req_id, [])
                blocks_after -= total - len(hs)
                for h in hs:
                    refs[h] -= 1
                    if refs[h] == 0:
                        del refs[h]
                        blocks_after -= 1
            return (blocks_after + self._demand_blocks(r, refs)
                    <= self.backend.kv_capacity // bs)
        kv_after = self.kv_tokens - sum(self.ctx_tokens[v.req_id]
                                        for v in evictable)
        return kv_after + self._kv_demand(r) <= self.backend.kv_capacity

    def _evict_for(self, rank: int) -> Optional[Request]:
        """Evict one running request preemptible by class ``rank``: KV seat
        released, generation state reset for recompute-on-resume (greedy
        decode regenerates identical tokens), the conservative ``_cached = 0``
        re-charges the full prefill.  The victim is RETURNED, not re-queued —
        the caller re-queues after admission so a same-step victim (which
        counts as aged in the reorder, and aging outranks class) can never
        win a freed seat straight back from the request it was evicted for."""
        pick = select_victim([(seq.handle, seq.r) for seq in self.running],
                             rank, self.gcfg,
                             admit_order=[seq.admit_time for seq in self.running],
                             predictor=self.predictor)
        if pick is None:
            return None
        _, victim = pick
        seq = next(s for s in self.running if s.r is victim)
        self.running.remove(seq)
        self.kv_tokens -= self.ctx_tokens.pop(victim.req_id)
        self._release_blocks(victim.req_id)
        self.backend.release(seq.handle, victim)
        reset_for_resume(victim)
        victim._cached = 0
        self.preemptions += 1
        self.events.append(SchedEvent("preempt", self.steps, victim.req_id))
        return victim

    def schedule(self, now: float) -> Tuple[List[Request], List[Request]]:
        """The unified admission + preemption scan (Alg. 2 order, chunked-
        prefill budget, capacity gates, priority eviction).

        Head-blocking per class: once a request of some rank is blocked (on
        KV, batch size, OR budget), equal-or-less-urgent requests behind it
        may not leapfrog it and steal what it is waiting for; with preemption
        enabled, strictly-more-urgent requests behind a blocked head may
        still be scanned so an interactive arrival behind an aged-batch head
        reaches its victims.  An oversized head (charge > whole budget) is
        admitted alone; an unseated head charges nothing — it cannot run
        this step and must not shield urgent waiters behind it.

        Returns (admitted, victims); victims must be re-queued by the caller
        only after admission completes."""
        order = self.queue.reorder(now)
        # layered mode: requests mid-pipeline re-touch their tokens every
        # micro-step, so in-flight charges stay against the budget until
        # their last layer — bounding total concurrent prefill work to one
        # budget's worth across the pipeline (chunked: always 0)
        budget = self.prefill_budget - sum(p.tokens for p in self._prefilling)
        admitted: List[Request] = []
        victims: List[Request] = []
        blocked_rank = _UNBLOCKED_RANK      # most-urgent rank blocked so far
        for r in list(order):
            if r.rank >= blocked_rank:
                continue
            need = self._charge(r)
            if need > budget and (admitted or self._prefilling):
                if self.gcfg.enable_preemption:
                    # budget-blocked head: strictly-more-urgent requests
                    # behind it may still be scanned (symmetric with the
                    # capacity-blocked case below)
                    blocked_rank = min(blocked_rank, r.rank)
                    continue
                break
            # priority preemption: evict lower-class running work to make
            # room, but only for requests admissible this iteration (budget-
            # gated above) and only when eviction can actually unblock r
            if (self.gcfg.enable_preemption
                    and self._blocked(r, len(admitted))
                    and self._eviction_unblocks(r, len(admitted))):
                while self._blocked(r, len(admitted)):
                    v = self._evict_for(r.rank)
                    if v is None:
                        break
                    victims.append(v)
            if self._blocked(r, len(admitted)):
                if self.gcfg.enable_preemption:
                    blocked_rank = min(blocked_rank, r.rank)
                    continue
                break
            budget -= need
            admitted.append(r)
            self.kv_tokens += self._kv_demand(r)
            self._admit_blocks(r)
            self.queue.remove(r)
            self.events.append(SchedEvent("admit", self.steps, r.req_id))
        return admitted, victims

    def _begin(self, r: Request, now: float, end: float,
               admit_time: Optional[float] = None) -> None:
        """Start serving ``r``: backend prefill, decode seat, first token at
        ``end``.  A KV-migrated orphan resumes with its progress: its first
        token was already delivered elsewhere, so neither TTFT nor the
        generated count reset (KV-lost orphans re-prefill and re-earn their
        first token like any fresh admit)."""
        handle, stats = self.backend.start(r, now)
        if stats is not None and self.expert is not None:
            with tracing.span("expert.observe"):
                self.expert.observe(stats)
        self.running.append(RunningSeq(
            r, handle, admit_time=now if admit_time is None else admit_time))
        r.engine_id = self.engine_id
        resumed = r.kv_migrated and r.first_token_time is not None
        self.ctx_tokens[r.req_id] = self._kv_demand(r)  # incl. migrated gen
        r.kv_migrated = False
        if not resumed:
            r.first_token_time = end
            r.generated = 1
            self._grow_ctx(r.req_id)    # + the first generated token;
            #                             keep kv_tokens == sum(ctx)

    # ------------------------------------------------------------------ the loop
    def step(self, now: float) -> Tuple[float, List[Request]]:
        """One continuous-batching iteration starting at ``now``.

        Order of play: (1) unified admission/preemption scan; (2) the backend
        dates this iteration (prefill + decode batch shaped by pre-admission
        state, like a fused chunked-prefill iteration); (3) admitted requests
        prefill and emit their first token; (4) previously-running requests
        decode one token; (5) the expert level ticks.  Returns
        (end timestamp, requests finished this step)."""
        if not self.healthy:
            return now, []
        with tracing.span("schedule"):
            admitted, victims = self.schedule(now)
        # the decode batch: admitted in a PRIOR step and not evicted above
        # (schedule() runs first, so victims never decode after losing KV)
        decoding = list(self.running)
        avg_ctx = (float(np.mean([self.ctx_tokens[seq.r.req_id]
                                  for seq in decoding])) if decoding else 0.0)
        if self.prefill_mode == "layered":
            # admitted requests with real prefill work enter the layer
            # pipeline; the admission step is their first micro-step
            for r in admitted:
                if self._charge(r) > 0:
                    r.engine_id = self.engine_id
                    self.ctx_tokens[r.req_id] = self._kv_demand(r)
                    self._prefilling.append(
                        LayeredPrefill(r, self._charge(r), 0, now))
            # this iteration = one decode step + ONE layer of prefill per
            # in-flight request (decode stalls for a layer, not a chunk)
            end = self.backend.step_time(
                now, 0, len(decoding), avg_ctx, queue_len=len(self.queue),
                layer_jobs=[p.tokens for p in self._prefilling])
            # nothing-to-prefill admits (fully cached / KV-migrated
            # hand-offs) skip the pipeline and start like a chunked admit
            for r in admitted:
                if self._charge(r) == 0:
                    self._begin(r, now, end)
            # advance every in-flight prefill one layer; completions emit
            # their first token at `end` and decode from the next step
            for p in list(self._prefilling):
                p.layers_done += 1
                if p.layers_done >= self.n_layers:
                    self._prefilling.remove(p)
                    self._begin(p.r, now, end, admit_time=p.admit_time)
        else:
            prefill_tokens = sum(self._charge(r) for r in admitted)
            end = self.backend.step_time(now, prefill_tokens, len(decoding),
                                         avg_ctx, queue_len=len(self.queue))
            # admitted requests prefill; first token materializes at `end`
            for r in admitted:
                self._begin(r, now, end)
        # victims re-queue only AFTER admission (see _evict_for)
        self.queue.extend(victims)
        # one decode step over every previously-running request
        finished: List[Request] = []
        if decoding:
            eos, stats = self.backend.decode(
                [(seq.handle, seq.r) for seq in decoding], now)
            if stats is not None and self.expert is not None:
                with tracing.span("expert.observe"):
                    self.expert.observe(stats)
            cap = self.backend.max_ctx_tokens
            for seq in decoding:
                r = seq.r
                r.generated += 1
                self._grow_ctx(r.req_id)    # decode growth holds KV too
                # finish-at-cap: once this request's KV slot is full there is
                # nowhere to write the next token — the request MUST finish,
                # or decode would clamp KV writes to the same position
                # forever and silently corrupt every later token (the
                # pre-fix behaviour).  Resident tokens = the prompt the
                # backend keeps (truncated to cap-1, leaving one write
                # position) + one committed write per decode step; the
                # decode that fills the last position is the final one.
                at_cap = cap is not None and \
                    min(r.prompt_len, cap - 1) + (r.generated - 1) >= cap
                if (r.generated >= r.max_new_tokens or r.req_id in eos
                        or at_cap):
                    r.finish_time = end
                    finished.append(r)
                    self.running.remove(seq)
                    self.kv_tokens -= self.ctx_tokens.pop(r.req_id)
                    self._release_blocks(r.req_id)
                    self.backend.release(seq.handle, r)
                    self.events.append(SchedEvent("finish", self.steps, r.req_id))
                    self.slo.observe(r)
                    if self.predictor is not None:
                        self.predictor.observe(r)   # histogram EMA update
        # expert-level tick (Alg. 3 lines 6-9)
        self.steps += 1
        if self.expert is not None:
            with tracing.span("expert.tick"):
                new_perm = self.expert.tick()
            if new_perm is not None:
                with tracing.span("expert.relocate"):
                    self.backend.apply_placement(new_perm)
        return end, finished

    # ------------------------------------------------------------------ fault tolerance
    def drain(self, migrate: bool = False) -> List[Request]:
        """Pull every request (waiting + running) off this engine.

        ``migrate=False`` (node crash): a running request's KV is gone — its
        progress resets and it re-prefills from scratch elsewhere.

        ``migrate=True`` (graceful drain / orchestrated failover): the KV
        pages travel with the request — ``first_token_time``/``generated``
        survive, the target charges no re-prefill, and admission accounts
        the migrated generated tokens as resident KV.  (The scheduling /
        latency semantics of a KV transfer; the live backend still re-runs
        the prompt prefill physically rather than receiving pages.)"""
        out = self.queue.drain()
        # mid-pipeline layered prefills: no first token yet, and partial
        # layer progress is NOT transferable KV — they re-queue elsewhere
        # as fresh work regardless of ``migrate``
        for p in list(self._prefilling):
            r = p.r
            r.kv_migrated = False
            r.engine_id = None
            self.kv_tokens -= self.ctx_tokens.pop(r.req_id, 0)
            self._release_blocks(r.req_id)
            out.append(r)
        self._prefilling.clear()
        for seq in list(self.running):
            r = seq.r
            if migrate:
                r.kv_migrated = True
            else:
                r.first_token_time = None
                r.generated = 0
                r.kv_migrated = False
            r.engine_id = None
            self.kv_tokens -= self.ctx_tokens.pop(r.req_id, 0)
            self._release_blocks(r.req_id)
            self.backend.release(seq.handle, r)
            out.append(r)
        self.running.clear()
        return out

    def pop_handoff(self, req_id: int) -> Optional[Request]:
        """Disaggregated prefill→decode hand-off: release ONE running request
        that has finished its prefill (first token emitted) so the cluster
        can move it to a decode-role engine.  KV semantics are the migrated
        drain path's — pages travel with the request, progress survives, and
        the target charges no re-prefill (``submit`` sets ``_cached``).
        Returns None when ``req_id`` is not running here."""
        seq = next((s for s in self.running if s.r.req_id == req_id), None)
        if seq is None:
            return None
        r = seq.r
        self.running.remove(seq)
        self.kv_tokens -= self.ctx_tokens.pop(req_id, 0)
        self._release_blocks(req_id)
        self.backend.release(seq.handle, r)
        r.kv_migrated = True
        r.engine_id = None
        self.events.append(SchedEvent("handoff", self.steps, req_id))
        return r

    def event_log(self) -> List[Tuple[str, int, int]]:
        """The (kind, step, req_id) decision stream — the parity oracle."""
        return [(e.kind, e.step, e.req_id) for e in self.events]
