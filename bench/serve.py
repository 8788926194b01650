"""Drives the port's normal serving path, ``Engine`` -> ``SchedulerCore`` ->
``TorchBackend`` -> ``models`` -> kernels, on the wall clock, and times it
from the outside.

``now`` handed to ``Engine.submit`` and ``Engine.step`` is wall seconds
from the run's clock origin, so the scheduler's aging works in real
seconds.  The harness wraps the engine's backend calls and its expert
level (``Probe``) to time them on the host, to stamp tokens and to keep
the served tokens for the check; it changes nothing they compute.
``backend.start`` and ``backend.decode`` both end in a copy to the host, so
each timer holds the device work of its call.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from bench import spec
from bench.roofline import flash_decode_paged, model_flops, moe_gemm
from bench.stats import Req
from bench.traffic import Job

# widths of every configuration file that must equal the port's own config
# (file key -> ModelConfig field); the layout adds its own (``widths``)
WIDTHS = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
          "vocab_size": "vocab_size", "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "torch_dtype": "dtype"}
WARMUP_ID = 1 << 40          # request ids of the set-up's shape warm-up


def widths(config: dict) -> Dict[str, str]:
    """``WIDTHS`` and the configuration's layout's own."""
    return {**WIDTHS, **spec.layout_module(config).WIDTHS}


def port_config(config: dict, port_cfg=None):
    """The port's ModelConfig for the file: its own config of the
    architecture at the file's depth, every width checked against the
    file, so a change to the program's config files cannot change a cell."""
    from repro_torch.configs import get_config
    cfg = (port_cfg or get_config(config["port_arch"])).replace(
        num_layers=config["num_hidden_layers"])
    want = {f: config[k] for k, f in widths(config).items() if k in config}
    for field, value in want.items():
        got = getattr(cfg, field)
        same = abs(got - value) <= 1e-12 * abs(value) if isinstance(value, float) else got == value
        if not same:
            raise ValueError(f"{field}: the port's config has {got!r}, the file {value!r}")
    eng = config["engine"]
    if config["moe_capacity_multiple"] != 8 or eng["prefill_bucket_min"] != 16:
        raise ValueError("the port rounds a capacity up to 8 and pads prompts from 16")
    return cfg


def build_engine(config: dict, cfg, params, device):
    from repro_torch.core.types import GimbalConfig
    from repro_torch.serving.engine import Engine
    e = config["engine"]
    return Engine(0, cfg, params, variant=e["variant"], gimbal_cfg=GimbalConfig(**e["gimbal"]),
                  max_slots=e["max_slots"], max_seq=e["max_seq"],
                  prefill_budget=e["prefill_budget"],
                  num_expert_devices=e["num_expert_devices"],
                  dispatch_mode=e["dispatch_mode"], kv_layout=e["kv_layout"],
                  kv_block_size=e["kv_block_size"], use_kernels=e["use_kernels"],
                  device=device)


@dataclasses.dataclass
class Step:
    t0: float
    t1: float = 0.0
    prefill_s: float = 0.0
    n_prefill: int = 0
    decode_s: float = 0.0
    n_decode: int = 0
    expert_s: float = 0.0
    flops: float = 0.0
    profiled: bool = False


class Probe:
    """Host timers around the engine's calls into its layers, token stamps,
    the served tokens, and (while ``profiling``) the work the kernels'
    inputs need."""

    def __init__(self, engine, config: dict, reqs: Dict[int, Req], clock: Callable[[], float]):
        import repro_torch.models.moe as moe_mod
        self.engine, self.config, self.reqs, self.clock = engine, config, reqs, clock
        self.steps: List[Step] = []
        self.cur: Optional[Step] = None
        self.profiling = False
        self.phase = None
        self.routes = []               # (phase, MoE layer, expert ids) while profiling
        # every decode call's router outputs, one entry a MoE layer:
        # (rows [(slot, request id, generated)], MoE layer, ids, slots, positions)
        self.decode_routes = []
        self.decode_calls = 0
        self._moe_layer = 0
        self.decode_lengths = []       # active rows' lengths a decode while profiling
        self.seen: Dict[int, int] = {}
        self.spans = []                # (name, start ns, end ns) host spans while profiling
        self._inner = 0
        self._moe = moe_mod
        self._route = moe_mod.route_replicated
        b = engine.backend
        self._start, self._decode, self._apply = b.start, b.decode, b.apply_placement
        b.start, b.decode, b.apply_placement = self.start, self.decode, self.apply_placement
        level = engine.core.expert
        if level is not None:
            self._observe, self._tick = level.observe, level.tick
            level.observe, level.tick = self.observe, self.tick
        moe_mod.route_replicated = self.route

    def close(self) -> None:
        self._moe.route_replicated = self._route

    def _span(self, name: str):
        return _Span(self, name) if self.profiling else contextlib.nullcontext()

    # -------------------------------------------------------------- wrappers
    def start(self, r, now):
        plen = min(r.prompt_len, self.engine.max_seq - 1)
        self.phase = ("prefill", plen)
        self._moe_layer = 0
        t = self.clock()
        self._inner += 1
        with self._span("prefill"):
            out = self._start(r, now)
        self._inner -= 1
        dt = self.clock() - t
        self.cur.prefill_s += dt
        self.cur.n_prefill += 1
        self.cur.flops += model_flops.prefill(self.config, plen)
        rec = self.reqs.get(r.req_id)
        if rec is not None:
            rec.start_call = t
            rec.served.append(int(self.engine.backend.slot_last_token[out[0]]))
        return out

    def decode(self, active, now):
        cap = self.engine.max_seq - 1
        lengths = [min(r.prompt_len, cap) + r.generated for _, r in active]
        self.phase = ("decode", [slot for slot, _ in active])
        self._rows = [(slot, r.req_id, r.generated) for slot, r in active]
        self._moe_layer = 0
        self.decode_calls += 1
        t = self.clock()
        self._inner += 1
        with self._span("decode"):
            out = self._decode(active, now)
        self._inner -= 1
        self.cur.decode_s += self.clock() - t
        self.cur.n_decode += 1
        self.cur.flops += model_flops.decode(self.config, lengths)
        last = self.engine.backend.slot_last_token
        for slot, r in active:
            rec = self.reqs.get(r.req_id)
            if rec is not None:
                rec.served.append(int(last[slot]))
        if self.profiling:
            self.decode_lengths.append(lengths)
        return out

    def _level(self, fn, *a):
        t = self.clock()
        with self._span("expert_level"):
            out = fn(*a)
        if self._inner == 0:
            self.cur.expert_s += self.clock() - t
        return out

    def observe(self, stats):
        return self._level(self._observe, stats)

    def tick(self):
        return self._level(self._tick)

    def apply_placement(self, new_map):
        return self._level(self._apply, new_map)

    def route(self, logits, k, replica_slots, replica_count, num_slots):
        out = self._route(logits, k, replica_slots, replica_count, num_slots)
        if self.profiling:
            self.routes.append((self.phase, self._moe_layer, out[1]))
        if self.phase[0] == "decode":
            self.decode_routes.append((self._rows, self._moe_layer, out[1], out[2], out[3]))
        self._moe_layer += 1
        return out

    # -------------------------------------------------------------- steps
    def step(self, now: float):
        self.cur = Step(t0=now, profiled=self.profiling)
        with self._span("step"):
            finished = self.engine.step(now)
        t1 = self.clock()
        self.cur.t1 = t1
        self.steps.append(self.cur)
        for seq in self.engine.core.running:
            self._stamp(seq.r, t1)
        for r in finished:
            self._stamp(r, t1)
            rec = self.reqs.get(r.req_id)
            if rec is not None:
                rec.finished = t1
        return finished, t1

    def _stamp(self, r, t1: float) -> None:
        rec = self.reqs.get(r.req_id)
        if rec is None:
            return
        n = r.generated - self.seen.get(r.req_id, 0)
        if n > 0:
            rec.stamps.extend([t1] * n)
            self.seen[r.req_id] = r.generated

    # -------------------------------------------------------------- decode capacity
    def decode_drops(self, rids, prompt_lens: Dict[int, int], cap: int):
        """For each request of ``rids``: {MoE layer: {position: expert ids the
        capacity rule dropped from its row in that decode step}}.  Which
        selections a decode step drops depends on every row of the batch,
        idle ones included, so the reference takes these from the program
        (``check.py``) and ``capacity_mismatches`` checks them by
        themselves."""
        want = set(rids)
        out = {r: {} for r in rids}
        for rows, layer, ids, _, pos in self.decode_routes:
            mine = [(slot, rid, g) for slot, rid, g in rows if rid in want]
            if not mine:
                continue
            ids_h, pos_h = ids.cpu().numpy(), pos.cpu().numpy()
            for slot, rid, g in mine:
                dropped = ids_h[slot][pos_h[slot] >= cap]
                if dropped.size:
                    p = prompt_lens[rid] + g - 1
                    out[rid].setdefault(layer, {})[p] = set(int(e) for e in dropped)
        return out

    def routes_unseen(self) -> int:
        """Router calls of decode steps that ``route`` did not record: one is
        due from each MoE layer in each ``backend.decode``.  Not 0 when the
        program reaches its router otherwise than through
        ``models.moe.route_replicated``; the capacity check and the
        decode drops the reference follows would then see nothing."""
        lay = spec.layout_module(self.config)
        layers = sum(lay.is_moe_layer(self.config, l)
                     for l in range(self.config["num_hidden_layers"]))
        return self.decode_calls * layers - len(self.decode_routes)

    def capacity_mismatches(self, seed: int, n: int = 256) -> int:
        """Selections whose capacity position the router returned otherwise
        than the plain token-major count over its own physical slots, in
        ``n`` decode calls drawn from the seed."""
        import torch
        from bench.traffic import subseed
        if not self.decode_routes:
            return 0
        rng = np.random.default_rng(subseed(seed, "capacity"))
        picks = rng.choice(len(self.decode_routes), min(n, len(self.decode_routes)),
                           replace=False)
        bad = 0
        for i in picks:
            _, _, _, slots, pos = self.decode_routes[i]
            flat = slots.reshape(-1).long()
            onehot = torch.nn.functional.one_hot(flat, int(flat.max()) + 1)
            want = ((onehot.cumsum(0) - 1) * onehot).sum(-1).reshape(pos.shape)
            bad += int((want != pos.long()).sum())
        return bad

    # -------------------------------------------------------------- needed work
    def kernel_bounds(self) -> Dict[str, float]:
        """Least seconds of the profiled sub-window's launches of each kernel
        the roofline metrics read, from the work their inputs need and the
        layers' widths, heads and windows (the configuration's layout)."""
        import torch
        c = self.config
        lay = spec.layout_module(c)
        layers = range(c["num_hidden_layers"])
        moe_layers = [l for l in layers if lay.is_moe_layer(c, l)]
        out = {"moe_gemm": 0.0, "flash_decode_paged": 0.0}
        for (kind, what), m, ids in self.routes:
            rows = ids[:what] if kind == "prefill" else ids[torch.as_tensor(what, device=ids.device)]
            reached = int(torch.unique(rows).numel())
            launches, d, f = lay.moe_launches(c, moe_layers[m])
            out["moe_gemm"] += moe_gemm.layer_seconds(d, f, reached, rows.numel(), launches)
        if c["engine"]["kv_layout"] == "paged" and c["engine"]["use_kernels"]:
            # layers alike in heads and window: one count each
            paged = collections.Counter((lay.paged_heads(c, l), lay.window(c, l)) for l in layers
                                        if lay.paged_heads(c, l) is not None)
            for lengths in self.decode_lengths:
                for ((hq, hkv, hd), window), n in paged.items():
                    spans = lengths if window is None else [min(x, window) for x in lengths]
                    out["flash_decode_paged"] += n * \
                        flash_decode_paged.layer_seconds(spans, hq, hkv, hd)
        return out


class _Span:
    """A host span on the profiler's clock (``time.time_ns``, the epoch
    nanoseconds its events carry), kept while profiling."""

    def __init__(self, probe: Probe, name: str):
        self.probe, self.name = probe, name

    def __enter__(self):
        self.t = time.time_ns()

    def __exit__(self, *exc):
        self.probe.spans.append((self.name, self.t, time.time_ns()))
        return False


# ------------------------------------------------------------------ traffic sources

class OpenSource:
    """Requests due on a schedule, whatever the engine does."""

    def __init__(self, jobs: List[Job], t_start: float):
        self.jobs, self.t_start, self.i = jobs, t_start, 0

    def due(self, now: float) -> List[Job]:
        out = []
        while self.i < len(self.jobs) and self.t_start + self.jobs[self.i].due <= now:
            j = self.jobs[self.i]
            out.append(dataclasses.replace(j, due=self.t_start + j.due))
            self.i += 1
        return out

    def next_due(self) -> float:
        return (self.t_start + self.jobs[self.i].due) if self.i < len(self.jobs) else float("inf")

    def finished(self, rec: Req, t: float) -> None:
        pass


class ClosedSource:
    """Clients that each send their next request as soon as the last one
    finishes (no think time); all send their first at the start."""

    def __init__(self, clients: List[List[Job]], t_start: float):
        self.clients = clients
        self.next = [0] * len(clients)
        self.ready = [(t_start, c) for c in range(len(clients))]

    def due(self, now: float) -> List[Job]:
        out, keep = [], []
        for t, c in self.ready:
            if t <= now and self.next[c] < len(self.clients[c]):
                out.append(dataclasses.replace(self.clients[c][self.next[c]], due=t))
                self.next[c] += 1
            elif t > now:
                keep.append((t, c))
        self.ready = keep
        return out

    def next_due(self) -> float:
        return min((t for t, _ in self.ready), default=float("inf"))

    def finished(self, rec: Req, t: float) -> None:
        self.ready.append((t, rec.client))


def submit(engine, reqs: Dict[int, Req], jobs: List[Job], now: float) -> None:
    from repro_torch.core.types import Request
    for j in jobs:
        rec = Req(j.rid, j.due, j.prompt, j.out_len, j.client)
        reqs[j.rid] = rec
        r = Request(req_id=j.rid, prompt_len=len(j.prompt), max_new_tokens=j.out_len,
                    arrival_time=j.due, prompt_tokens=j.prompt)
        rec.refused = not engine.submit(r, now)


def warm_shapes(engine, probe: Probe, config: dict, lo: int, hi: int, seed: int,
                clock) -> int:
    """Set-up: one request at each prefill bucket the traffic reaches (a
    prompt that fills the bucket, cut to the slot length), each decoding
    once, until the engine is idle.  Returns the buckets warmed."""
    from repro_torch.core.types import Request
    from bench.traffic import subseed
    cap = engine.max_seq - 1
    b = config["engine"]["prefill_bucket_min"]
    while b < lo:
        b *= 2
    rng = np.random.default_rng(subseed(seed, "warm"))
    n = 0
    while True:
        plen = min(b, cap)
        toks = rng.integers(0, config["vocab_size"], plen)
        engine.submit(Request(req_id=WARMUP_ID + n, prompt_len=plen, max_new_tokens=2,
                              arrival_time=clock(), prompt_tokens=toks), clock())
        n += 1
        if b >= hi:
            break
        b *= 2
    while not engine.core.idle:
        probe.step(clock())
    return n


def drive(engine, probe: Probe, source, reqs: Dict[int, Req], t_close: float, clock,
          hooks: Callable[[float], None] = lambda now: None) -> None:
    """Offer the traffic and step the engine until ``t_close``; ``hooks(now)``
    runs at each step boundary (the traced run's profiler)."""
    while True:
        now = clock()
        if now >= t_close:
            return
        jobs = source.due(now)
        if jobs:
            submit(engine, reqs, jobs, now)
        if engine.core.idle:
            wait = min(source.next_due(), t_close) - now
            if wait > 0:
                time.sleep(min(wait, 0.01))
            continue
        hooks(now)
        finished, t1 = probe.step(clock())
        for r in finished:
            rec = reqs.get(r.req_id)
            if rec is not None:
                source.finished(rec, t1)
