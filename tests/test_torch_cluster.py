"""The port's cluster plane against the JAX reference on the CPU.

Host-only: both packages' ``DispatchCore`` (every variant, with and without
prefill/decode roles, fail / restore / remove calls), ``HealthMonitor`` and
``ElasticPolicy`` on a seeded metric stream, ``MetricsBus`` snapshots, and
the latency summaries must decide and report identically.

Real engines: a reference ``Cluster`` of JAX ``Engine``s and a port
``Cluster`` of ``TorchBackend`` engines, built from the same bridged weights
(qwen3-30b-a3b smoke config, f32), driven on the same trace and logical
clock: the five dispatch variants on both KV layouts, 1 prefill + 1 decode
engine under both prefill modes, the crash, kill and elastic drills through
``run_drill``, and one shared ``ClusterExpertLevel`` with the synthetic
prior.  Assignment, lifecycle, per-engine event and KV-transfer streams must
be byte-identical, rebalance events and slot maps equal, and greedy tokens
identical.  A fused-MoE check holds the port's fixed-order combine against
the reference's ``moe_apply``.

Each reference engine jit-compiles its own decode and prefill functions;
engines of one kind share the first one's compiled functions here (they
close over nothing but the config, the dispatch mode, the kernel switch and
whether a level is present, which are equal within a kind), so the file
compiles each kind once.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import dispatch as jdispatch
from repro.core.gimbal import VARIANTS as JAX_VARIANTS
from repro.core.gimbal import make_cluster_expert_level as jax_cluster_level
from repro.core.prefix_cache import PrefixCache as JaxPrefixCache
from repro.core.types import EngineMetrics as JaxEngineMetrics
from repro.core.types import GimbalConfig as JaxGimbalConfig
from repro.core.types import Request as JaxRequest
from repro.distributed import drill as jdrill
from repro.distributed import fault as jfault
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serving import metrics as jmetrics
from repro.serving.cluster import Cluster as JaxCluster
from repro.serving.engine import Engine as JaxEngine
from repro.workloads import burstgpt_trace as jax_burstgpt
from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch as tdispatch
from repro_torch.core.gimbal import VARIANTS, make_cluster_expert_level
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.types import EngineMetrics, GimbalConfig, Request
from repro_torch.distributed import drill as tdrill
from repro_torch.distributed import fault as tfault
from repro_torch.models import moe as TMoE
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import metrics as tmetrics
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.engine import Engine
from repro_torch.workloads import burstgpt_trace

ARCH = "qwen3-30b-a3b"
GKW = dict(tau=10_000, theta_age=1.0)
BASE_KW = dict(max_slots=4, max_seq=64, prefill_budget=48)
# the main path: paged KV, fused MoE through the kernel wrappers, no level
PAGED_KW = dict(BASE_KW, kv_layout="paged", kv_block_size=16,
                dispatch_mode="fused", use_kernels=True, expert_level=None)
# the reference Engine's defaults: slot KV, dense MoE, a private level
SLOT_KW = dict(BASE_KW, num_expert_devices=2)
LAYOUTS = {"paged": PAGED_KW, "slot": SLOT_KW}


# ----------------------------------------------------------------- host only

def _metric_stream(seed, engines, steps):
    """Per step: each engine publishes (or misses) a heartbeat with a
    seeded KV use and load; the load runs high in the first half of the
    stream and low in the second."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        now = 0.1 * (s + 1)
        top = 8000 if s < steps // 2 else 2000
        beats = [(e, float(rng.random()), int(rng.integers(0, top)),
                  int(rng.integers(0, 4)), int(rng.integers(0, 4)))
                 for e in engines if rng.random() < 0.8]
        out.append((now, beats))
    return out


def _drive_dispatch(pkg, variant, roles, seed=5):
    """Seeded requests with per-user token prefixes through one DispatchCore;
    each decision inserts the prompt into the winner's prefix cache (as a
    submit does); engine 1 fails at step 8 and is restored at step 14,
    engine 2 is removed at step 20."""
    P = pkg
    core = P.DispatchCore(variant, [0, 1, 2], P.GimbalConfig(affinity_ttl=0.5))
    caches = {e: P.PrefixCache(block_size=16, capacity_blocks=12) for e in range(3)}
    for e in range(3):
        core.attach_engine(e, caches[e], role=roles[e] if roles else None)
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 500, 32) for _ in range(4)]
    hedges = []
    for step, (now, beats) in enumerate(_metric_stream(seed, [0, 1, 2], 28)):
        metrics = {e: P.EngineMetrics(e, kv_usage=kv, running_load=load,
                                      num_running=nr, num_waiting=nw,
                                      timestamp=now - 0.05)
                   for e, kv, load, nr, nw in beats}
        if step == 8:
            core.on_engine_failed(1, kv="migrated")
            caches[1].clear()
        if step == 14:
            core.on_engine_restored(1)
        if step == 20:
            core.on_engine_removed(2)
            caches[2].clear()
        for j in range(2):
            u = int(rng.integers(0, 4))
            toks = np.concatenate([prefixes[u], rng.integers(0, 500, int(rng.integers(0, 40)))])
            r = P.Request(2 * step + j, len(toks), 8, now - 0.3, user_id=f"u{u}",
                          prompt_tokens=toks, kv_migrated=bool(rng.random() < 0.3))
            eid = core.dispatch(r, metrics, now)
            caches[eid].insert(toks, now)
            if hasattr(core.router, "hedge_target"):
                hedges.append(core.router.hedge_target(r, metrics, now + 1.0))
    return core, hedges


def _host(pkg):
    if pkg == "port":
        return types.SimpleNamespace(
            DispatchCore=tdispatch.DispatchCore,
            GimbalConfig=lambda **kw: GimbalConfig(hedge_threshold=0.5, **kw),
            PrefixCache=PrefixCache, EngineMetrics=EngineMetrics, Request=Request)
    return types.SimpleNamespace(
        DispatchCore=jdispatch.DispatchCore,
        GimbalConfig=lambda **kw: JaxGimbalConfig(hedge_threshold=0.5, **kw),
        PrefixCache=JaxPrefixCache, EngineMetrics=JaxEngineMetrics, Request=JaxRequest)


@pytest.mark.parametrize("roles", [None, ("prefill", "decode", "unified")],
                         ids=["unified", "roles"])
@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_dispatch_core_matches_reference(variant, roles):
    assert VARIANTS == JAX_VARIANTS
    tc, th = _drive_dispatch(_host("port"), variant, roles)
    jc, jh = _drive_dispatch(_host("jax"), variant, roles)
    assert len(tc.assignment_log()) == 56
    assert tc.assignment_log() == jc.assignment_log()
    assert tc.lifecycle_log() == jc.lifecycle_log() == \
        [("fail:migrated", 1), ("restore", 1), ("remove", 2)]
    assert tc.directory._held == jc.directory._held
    assert th == jh
    assert type(tc.router).__name__ == type(jc.router).__name__
    assert tdispatch.DISPATCH_WEIGHTS == {k: tdispatch.DispatchWeights(**vars(v))
                                          for k, v in jdispatch.DISPATCH_WEIGHTS.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_elastic_and_bus_match_reference(seed):
    """HealthMonitor detections and recoveries, ElasticPolicy decisions and
    MetricsBus snapshots on one seeded heartbeat stream (engine 3 falls
    silent for a stretch and comes back)."""
    outs = []
    for fault, em, Bus in ((tfault, EngineMetrics, tmetrics.MetricsBus),
                           (jfault, JaxEngineMetrics, jmetrics.MetricsBus)):
        mon = fault.HealthMonitor([0, 1, 2, 3], fault.HealthConfig(
            heartbeat_timeout=0.25, suspect_strikes=2, recovery_probation=0.5))
        pol = fault.ElasticPolicy(out_tokens=3500, in_tokens=1500, sustain_checks=2,
                                  min_engines=2, max_engines=6, stale_after=0.4)
        bus = Bus(delay=0.15)
        log = []
        for now, beats in _metric_stream(seed, [0, 1, 2, 3], 60):
            for e, kv, load, nr, nw in beats:
                if e == 3 and 2.0 <= now < 3.5:
                    continue
                bus.publish(em(e, kv_usage=kv, running_load=load, num_running=nr,
                               num_waiting=nw, timestamp=now))
            snap = bus.snapshot(now)
            mon.observe(snap, now)
            log.append((sorted((e, m.timestamp) for e, m in snap.items()),
                        mon.check(now), mon.recovered(now),
                        pol.decide(snap, now=now, dead=set(mon.dead), n_engines=4)))
            if now > 4.0 and 2 in bus._log:
                bus.forget(2)
                mon.remove_engine(2)
        outs.append(log)
    assert outs[0] == outs[1]
    assert any(lg[1] for lg in outs[0]) and any(lg[2] for lg in outs[0])
    assert {lg[3] for lg in outs[0]} >= {1, -1}


def test_summaries_match_reference():
    rng = np.random.default_rng(4)
    reqs = {"port": [], "jax": []}
    for i in range(40):
        kw = dict(priority_class=["batch", "interactive"][i % 2],
                  tenant=["a", "b", "c"][i % 3],
                  slo_ttft=[None, 0.5, 2.0][int(rng.integers(0, 3))],
                  slo_tpot=[None, 0.05][int(rng.integers(0, 2))])
        arrival = float(rng.uniform(0, 5))
        done = dict(first_token_time=arrival + float(rng.exponential(0.6)),
                    generated=int(rng.integers(1, 30)), preempted=int(rng.integers(0, 2)),
                    wasted_tokens=int(rng.integers(0, 4)))
        done["finish_time"] = done["first_token_time"] + 0.04 * done["generated"]
        shed = rng.random() < 0.15
        for pkg, cls in (("port", Request), ("jax", JaxRequest)):
            r = cls(i, 10, 30, arrival, **kw)
            if shed:
                r.shed_time = arrival + 0.1
            else:
                for k, v in done.items():
                    setattr(r, k, v)
            reqs[pkg].append(r)
    for horizon in (None, 9.0):
        assert tmetrics.summarize(reqs["port"], horizon).row() == \
            jmetrics.summarize(reqs["jax"], horizon).row()
        for fn in ("summarize_by_class", "summarize_by_tenant"):
            got = getattr(tmetrics, fn)(reqs["port"], horizon)
            want = getattr(jmetrics, fn)(reqs["jax"], horizon)
            assert {k: v.row() for k, v in got.items()} == \
                {k: v.row() for k, v in want.items()}
            assert len(got) >= 2
    empty = tmetrics.summarize(reqs["port"][:0]).row()
    assert empty["n"] == 0 and empty == pytest.approx(jmetrics.summarize([]).row(),
                                                      nan_ok=True)


# ----------------------------------------------------------- real engines

@pytest.fixture(scope="module")
def models():
    jc, tc = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    tree = jax.tree.map(np.array, JM.init_params(jax.random.key(0), jc))
    return jc, tc, tree, params_from_numpy(tree, device="cpu")


_JAX_JITS = {}


def _share_jits(engine):
    """Give a reference engine the compiled functions of the first engine of
    its kind (see the module docstring)."""
    b = engine.backend
    key = (b.dispatch_mode, b.use_kernels, b.rebalancer is not None)
    first = _JAX_JITS.setdefault(key, b)
    b._jit_decode = first._jit_decode
    b._jit_decode_paged = first._jit_decode_paged
    b._prefill_for_bucket = first._prefill_for_bucket
    return engine


def _pkg(models, name):
    jc, tc, tree, pt = models
    if name == "port":
        return types.SimpleNamespace(
            cfg=tc, params=pt, Cluster=Cluster, Request=Request, gcfg=GimbalConfig,
            make_engine=lambda i, **kw: Engine(i, tc, pt, device="cpu", **kw),
            level=make_cluster_expert_level, trace=burstgpt_trace,
            run_drill=tdrill.run_drill, HealthConfig=tfault.HealthConfig)
    return types.SimpleNamespace(
        cfg=jc, params=tree, Cluster=JaxCluster, Request=JaxRequest, gcfg=JaxGimbalConfig,
        make_engine=lambda i, **kw: _share_jits(JaxEngine(i, jc, tree, **kw)),
        level=jax_cluster_level, trace=jax_burstgpt,
        run_drill=jdrill.run_drill, HealthConfig=jfault.HealthConfig)


def _session_trace(P, n=12, seed=23, n_users=3, stretch=1.0, new_tokens=(3, 6)):
    """A bursty trace with per-user shared 16-token prefixes, folded into the
    smoke engine's envelope (vocab 128, 64-token slots): ``new_tokens`` =
    (least, spread) of the generated lengths, ``stretch`` dilates arrivals."""
    rng = np.random.default_rng(seed)
    trace = P.trace(n=n, rps=40.0, seed=seed, burstiness=4.0, interactive_frac=0.3)
    prefixes = {u: rng.integers(0, 128, 16).tolist() for u in range(n_users)}
    for j, r in enumerate(trace):
        u = j % n_users
        r.user_id = f"u{u}"
        suffix = rng.integers(0, 128, 4 + r.prompt_len % 12).tolist()
        r.prompt_tokens = np.asarray(prefixes[u] + suffix, dtype=np.int64)
        r.prompt_len = len(r.prompt_tokens)
        r.max_new_tokens = new_tokens[0] + r.max_new_tokens % new_tokens[1]
        r.arrival_time *= stretch
    return trace


def _record_tokens(engine, tokens):
    """Wrap ``backend.decode`` to record each request's greedy tokens."""
    orig = engine.backend.decode

    def record(active, now):
        out = orig(active, now)
        for slot, r in active:
            tokens.setdefault(r.req_id, []).append(int(engine.backend.slot_last_token[slot]))
        return out

    engine.backend.decode = record
    return engine


def _drive(cl, trace, n_steps=600, dt=0.05):
    pending = sorted(trace, key=lambda r: (r.arrival_time, r.req_id))
    i, t = 0, 0.0
    for _ in range(n_steps):
        while i < len(pending) and pending[i].arrival_time <= t:
            cl.submit(pending[i], t)
            i += 1
        cl.step(t)
        t += dt
        if i == len(pending) and len(cl.finished) == len(pending):
            break
    return cl.finished


def _build(P, variant, engine_kw, roles=("unified", "unified"), tokens=None, **cl_kw):
    gcfg = P.gcfg(**GKW)

    def make(i):
        role = roles[i] if i < len(roles) else "unified"
        e = P.make_engine(i, variant=variant, gimbal_cfg=gcfg, role=role, **engine_kw)
        return _record_tokens(e, tokens) if tokens is not None else e

    return P.Cluster([make(i) for i in range(len(roles))], variant=variant,
                     gimbal_cfg=gcfg, **cl_kw), make


def _finished(cl):
    return sorted((r.req_id, r.engine_id, r.generated, r.first_token_time, r.finish_time)
                  for r in cl.finished)


def _same_engines(ct, cj):
    assert sorted(ct.engines) == sorted(cj.engines)
    for eid in cj.engines:
        assert ct.engines[eid].core.event_log() == cj.engines[eid].core.event_log(), eid


@pytest.mark.parametrize("layout", ["paged", "slot"])
@pytest.mark.parametrize("variant", ["rr", "prefix", "kv", "sticky", "combined"])
def test_cluster_dispatch_variants_match_reference(models, variant, layout):
    runs = {}
    for name in ("port", "jax"):
        P = _pkg(models, name)
        tokens = {}
        cl, _ = _build(P, variant, LAYOUTS[layout], tokens=tokens)
        trace = _session_trace(P)
        assert len(_drive(cl, trace)) == len(trace)
        runs[name] = (cl, tokens)
    (ct, tt), (cj, tj) = runs["port"], runs["jax"]
    assert ct.dispatch.assignment_log() == cj.dispatch.assignment_log()
    assert len(ct.dispatch.assignment_log()) == 12
    _same_engines(ct, cj)
    assert ct.prefix_stats() == cj.prefix_stats()
    assert ct.dispatch.directory._held == cj.dispatch.directory._held
    assert tt == tj and len(tt) == 12
    assert _finished(ct) == _finished(cj)
    if variant in ("prefix", "sticky", "combined"):
        assert ct.prefix_stats()["hit_blocks"] > 0
    if layout == "paged":
        for e in ct.engines.values():
            assert e.kv.blocks_used == 0


@pytest.mark.parametrize("prefill_mode", ["chunked", "layered"])
def test_disaggregated_cluster_matches_reference(models, prefill_mode):
    runs = {}
    for name in ("port", "jax"):
        P = _pkg(models, name)
        tokens = {}
        cl, _ = _build(P, "combined", dict(PAGED_KW, prefill_mode=prefill_mode),
                       roles=("prefill", "decode"), tokens=tokens)
        trace = _session_trace(P, seed=37)
        assert len(_drive(cl, trace)) == len(trace)
        runs[name] = (cl, tokens)
    (ct, tt), (cj, tj) = runs["port"], runs["jax"]
    log = ct.kv_transfer_log()
    assert log == cj.kv_transfer_log()
    assert sorted(log) == [(i, 0, 1) for i in range(12)]
    assert ct.dispatch.assignment_log() == cj.dispatch.assignment_log()
    _same_engines(ct, cj)
    kinds = [k for k, _, _ in ct.engines[0].core.event_log()]
    assert kinds.count("handoff") == 12 and "finish" not in kinds
    assert all(r.engine_id == 1 for r in ct.finished)
    assert tt == tj
    assert _finished(ct) == _finished(cj)


@pytest.mark.parametrize("drill", ["kill", "kill_restore", "kill_migrate", "elastic"])
def test_cluster_drills_match_reference(models, drill):
    runs = {}
    for name in ("port", "jax"):
        P = _pkg(models, name)
        tokens = {}
        health = P.HealthConfig(heartbeat_timeout=0.5, suspect_strikes=2)
        cl, make = _build(P, "combined", PAGED_KW, tokens=tokens, health=health)
        if drill == "elastic":
            cl.engine_factory = make
        # arrivals dilated so a crash is detected (timeout x strikes) before
        # the restore, and every drill event finds work to re-route
        trace = _session_trace(P, seed=5, n_users=4, stretch=50.0, new_tokens=(8, 12))
        runner = P.run_drill(cl, trace, drill, dt=0.05)
        runs[name] = (cl, tokens, runner)
    (ct, tt, rt), (cj, tj, rj) = runs["port"], runs["jax"]
    life = ct.dispatch.lifecycle_log()
    assert life == cj.dispatch.lifecycle_log()
    assert rt.fired == rj.fired and len(rt.fired) == len(tdrill.DRILLS[drill].events)
    assert ct.dispatch.assignment_log() == cj.dispatch.assignment_log()
    _same_engines(ct, cj)
    assert tt == tj
    assert _finished(ct) == _finished(cj)
    assert sorted(r.req_id for r in ct.finished) == list(range(12))
    expect = {"kill": [("detect", 1), ("fail:lost", 1)],
              "kill_restore": [("detect", 1), ("fail:lost", 1), ("restore", 1)],
              "kill_migrate": [("fail:migrated", 1), ("restore", 1)],
              "elastic": [("attach", 2), ("remove", 2)]}[drill]
    assert life == expect
    assert ct.rerouted == cj.rerouted > 0
    assert ct.fault_log == cj.fault_log


@pytest.mark.parametrize("variant", ["gimbal", "gimbal+rep"])
def test_shared_expert_level_cluster_matches_reference(models, variant):
    """Two slot-layout engines share one level seeded with the synthetic
    prior (seed 3); it rebalances mid-run, and every engine applies its
    slot map."""
    runs = {}
    for name in ("port", "jax"):
        P = _pkg(models, name)
        gcfg = P.gcfg(tau=4, theta_age=1.0)
        level = P.level(variant, P.cfg, 2, gcfg, prior_seed=3)
        tokens = {}
        engines = [_record_tokens(P.make_engine(i, variant=variant, gimbal_cfg=gcfg,
                                                expert_level=level, **SLOT_KW), tokens)
                   for i in range(2)]
        cl = P.Cluster(engines, variant=variant, gimbal_cfg=gcfg, expert_level=level)
        trace = _session_trace(P, n=10, seed=31)
        assert len(_drive(cl, trace)) == len(trace)
        for e in engines:
            e.backend._sync_placement()
        runs[name] = (cl, level, tokens)
    (ct, lt, tt), (cj, lj, tj) = runs["port"], runs["jax"]
    assert lt.migrations == lj.migrations >= 1
    assert [vars(e) for e in lt.events] == [vars(e) for e in lj.events]
    np.testing.assert_array_equal(lt.slot_map, lj.slot_map)
    assert len(lt.slot_map) == models[1].num_experts + (2 if variant == "gimbal+rep" else 0)
    for eid in cj.engines:
        np.testing.assert_array_equal(ct.engines[eid].backend._applied_map, lt.slot_map)
    assert ct.expert_report() == cj.expert_report()
    assert ct.dispatch.assignment_log() == cj.dispatch.assignment_log()
    _same_engines(ct, cj)
    assert tt == tj
    assert _finished(ct) == _finished(cj)


# ------------------------------------------------------------- the combine

@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("replicated", [False, True])
def test_fixed_order_combine_matches_reference(models, dtype, tol, replicated):
    """The fused MoE with capacity 8 over 64 tokens drops selections; the
    port's per-token gather combine stays within the reference's tolerance
    of its scatter-add, and repeats itself bit for bit."""
    jc, tc, tree, _ = models
    jc, tc = jc.replace(dtype=dtype, capacity_factor=0.5), tc.replace(dtype=dtype, capacity_factor=0.5)
    moe_np = {k: np.asarray(v)[0] for k, v in tree["blocks"]["moe"].items()}  # layer 0
    e = tc.num_experts
    slot_map = np.array(list(range(e)) + [1, 5], np.int32) if replicated else np.arange(e)
    gather = slot_map
    jp = {k: jnp.asarray(v if k == "w_router" else v[gather], dtype=jnp.float32 if k == "w_router" else dtype)
          for k, v in moe_np.items()}
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tp = {k: torch.tensor(np.asarray(v if k == "w_router" else v[gather], np.float32)).to(
        torch.float32 if k == "w_router" else tdt) for k, v in moe_np.items()}
    x = np.random.default_rng(2).standard_normal((4, 16, tc.d_model)).astype(np.float32)
    jplace = JMoE.ExpertPlacement.from_slot_map(jnp.asarray(slot_map), e)
    tplace = TMoE.ExpertPlacement.from_slot_map(torch.tensor(slot_map), e)
    yj, auxj = JMoE.moe_apply(jp, jc, jnp.asarray(x, dtype), placement=jplace,
                              dispatch_mode="fused", return_stats=True)
    yt, auxt = TMoE.moe_apply(tp, tc, torch.tensor(x).to(tdt), placement=tplace,
                              dispatch_mode="fused", return_stats=True)
    assert float(auxt["dropped_frac"]) > 0 and float(auxj["dropped_frac"]) > 0
    np.testing.assert_array_equal(auxt["expert_ids"].numpy(), np.asarray(auxj["expert_ids"]))
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               rtol=tol, atol=tol)
    yt2, _ = TMoE.moe_apply(tp, tc, torch.tensor(x).to(tdt), placement=tplace,
                            dispatch_mode="fused")
    assert torch.equal(yt, yt2)
