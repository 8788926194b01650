"""The port's serving engine against the JAX reference on the CPU: the same
shared-prefix, token-carrying trace through a JAX ``Engine`` and a port
``Engine`` built with the same bridged weights (qwen3-30b-a3b smoke config,
f32): the paged layout with fused MoE and no expert level, and the slot
layout with the Gimbal expert level (private or shared), replicated or not.

The scheduling decision streams must be byte-identical, greedy token
streams identical, and the expert level's rebalance events, slot maps and
relocation counts equal; on the paged layout prefix pages are shared and
the page pool drained.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.gimbal import make_cluster_expert_level as jax_cluster_level
from repro.core.types import GimbalConfig as JaxGimbalConfig
from repro.core.types import Request as JaxRequest
from repro.models import model as JM
from repro.serving.backend import JaxBackend
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.eplb import ClusterExpertLevel, NullExpertLevel
from repro_torch.core.gimbal import make_cluster_expert_level
from repro_torch.core.types import GimbalConfig, Request
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.engine import Engine

ARCH = "qwen3-30b-a3b"
ENGINE_KW = dict(variant="gimbal", max_slots=4, max_seq=64, prefill_budget=48,
                 kv_layout="paged", kv_block_size=16, dispatch_mode="fused",
                 use_kernels=True, expert_level=None)
# the reference's defaults (slot layout, private expert level, dense
# dispatch) bar the sizes and the expert devices
SLOT_KW = dict(max_slots=4, max_seq=64, prefill_budget=48, num_expert_devices=2)


@pytest.fixture(scope="module")
def models():
    jc, tc = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    tree = jax.tree.map(np.array, JM.init_params(jax.random.key(0), jc))
    return jc, tc, tree, params_from_numpy(tree, device="cpu")


def _trace(n=14, seed=41, n_users=3):
    """(req_id, tokens, max_new_tokens, arrival, class) tuples: per-user
    shared 16-token prefixes plus private suffixes.  Long batch requests
    fill every slot first; interactive ones arrive behind them, so that with
    preemption enabled they evict batch work."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 128, 16) for _ in range(n_users)]
    out, t = [], 0.0
    for i in range(n):
        toks = np.concatenate([prefixes[i % n_users], rng.integers(0, 128, int(rng.integers(0, 16)))])
        interactive = i >= 5 and rng.random() < 0.5
        out.append((i, toks, int(rng.integers(3, 6) if interactive else rng.integers(10, 16)),
                    t, "interactive" if interactive else "batch"))
        t += float(rng.exponential(0.04))
    return out


def _drive(engine, trace, request_cls, n_steps=400, dt=0.05):
    """Same submit times and logical clock for either package; records each
    request's greedy tokens by wrapping backend.decode."""
    reqs = [request_cls(i, len(toks), m, a, prompt_tokens=toks, user_id=f"u{i % 3}",
                        priority_class=c) for i, toks, m, a, c in trace]
    tokens = {}
    orig = engine.backend.decode

    def record(active, now):
        out = orig(active, now)
        for slot, r in active:
            tokens.setdefault(r.req_id, []).append(int(engine.backend.slot_last_token[slot]))
        return out

    engine.backend.decode = record
    i, t, done = 0, 0.0, []
    for _ in range(n_steps):
        while i < len(reqs) and reqs[i].arrival_time <= t:
            engine.submit(reqs[i], t)
            i += 1
        done += engine.step(t)
        t += dt
        if i == len(reqs) and len(done) == len(reqs):
            break
    return done, tokens


@pytest.mark.parametrize("preemption", [False, True])
def test_engine_matches_reference(models, preemption):
    jc, tc, tree, pt = models
    trace = _trace()
    gkw = dict(enable_preemption=preemption, tau=10_000, theta_age=1.0)
    je = JaxEngine(0, jc, tree, gimbal_cfg=JaxGimbalConfig(**gkw), **ENGINE_KW)
    te = Engine(0, tc, pt, gimbal_cfg=GimbalConfig(**gkw), device="cpu", **ENGINE_KW)
    done_j, tok_j = _drive(je, copy.deepcopy(trace), JaxRequest)
    done_t, tok_t = _drive(te, copy.deepcopy(trace), Request)
    assert len(done_j) == len(done_t) == len(trace)
    assert te.core.event_log() == je.core.event_log()
    assert tok_t == tok_j                                 # identical greedy streams
    assert te.kv.shared_hits == je.kv.shared_hits > 0
    assert te.kv.blocks_used == je.kv.blocks_used == 0
    assert te.preemptions == je.preemptions and (te.preemptions > 0) == preemption
    assert [(r.req_id, r.generated, r.first_token_time, r.finish_time) for r in done_t] == \
        [(r.req_id, r.generated, r.first_token_time, r.finish_time) for r in done_j]


def test_null_expert_level_and_unported_options_raise(models):
    """A NullExpertLevel means no level; what no package knows (an unknown
    layout) and a prior seed no ``jax.random.key`` takes raise."""
    jc, tc, tree, pt = models
    kw = dict(ENGINE_KW, expert_level=NullExpertLevel())
    eng = Engine(0, tc, pt, device="cpu", **kw)
    assert eng.rebalancer is None and eng.backend.rebalancer is None
    with pytest.raises(ValueError, match="seed"):
        make_cluster_expert_level("gimbal", tc, 2, prior_seed=2**32)
    with pytest.raises(ValueError, match="seed"):
        ClusterExpertLevel(tc, 2, prior_seed=-1)
    with pytest.raises(ValueError, match="kv_layout"):
        Engine(0, tc, pt, device="cpu", **dict(ENGINE_KW, kv_layout="blocks"))


def _same_expert_level(te, je):
    rt, rj = te.rebalancer, je.rebalancer
    assert [vars(e) for e in rt.events] == [vars(e) for e in rj.events]
    np.testing.assert_array_equal(rt.slot_map, rj.slot_map)
    assert rt.factor_trail == rj.factor_trail
    np.testing.assert_array_equal(rt.tracker.A, rj.tracker.A)
    np.testing.assert_array_equal(rt.tracker.W, rj.tracker.W)


@pytest.mark.parametrize("dispatch_mode", ["dense", "fused"])
@pytest.mark.parametrize("variant", ["gimbal", "gimbal+rep"])
def test_slot_engine_with_expert_level_matches_reference(models, variant, dispatch_mode):
    """The reference Engine's defaults (slot layout, private expert level)
    with tau=3: both rebalance mid-run, replicate hot experts under
    gimbal+rep, and still decide, generate and relocate identically."""
    jc, tc, tree, pt = models
    trace = _trace()
    kw = dict(SLOT_KW, variant=variant)
    if dispatch_mode != "dense":
        kw["dispatch_mode"] = dispatch_mode
    je = JaxEngine(0, jc, tree, gimbal_cfg=JaxGimbalConfig(tau=3), **kw)
    te = Engine(0, tc, pt, gimbal_cfg=GimbalConfig(tau=3), device="cpu", **kw)
    assert te.backend.kv_layout == "slot" and te.rebalancer is not None
    done_j, tok_j = _drive(je, copy.deepcopy(trace), JaxRequest)
    done_t, tok_t = _drive(te, copy.deepcopy(trace), Request)
    assert len(done_j) == len(done_t) == len(trace)
    assert te.core.event_log() == je.core.event_log()
    assert tok_t == tok_j
    assert te.relocations == je.relocations >= 1
    _same_expert_level(te, je)
    n_slots = tc.num_experts + (2 if variant == "gimbal+rep" else 0)
    assert len(te.rebalancer.slot_map) == n_slots
    assert te.params["blocks"]["moe"]["w_gate"].shape[1] == n_slots
    assert te.kv.num_free == te.max_slots and te.kv.usage() == 0.0


def test_replicated_relocation_preserves_outputs(models):
    """Twin of the reference's test of the same name: after tau steps
    gimbal+rep replicates hot experts (weights grow E -> E+R rows) and
    dispatch splits their token streams, and the greedy tokens still equal
    those of the static variant."""
    jc, tc, tree, pt = models
    outs = {}
    for variant in ("vllm", "gimbal+rep"):
        e = Engine(0, tc, pt, variant=variant, gimbal_cfg=GimbalConfig(tau=3),
                   max_slots=4, max_seq=64, prefill_budget=64, num_expert_devices=2,
                   device="cpu")
        rs = [Request(i, 6, 8, 0.01 * i) for i in range(2)]
        for r in rs:
            e.submit(r, 0.0)
        for step in range(30):
            e.step(float(step))
            if all(r.finish_time is not None for r in rs):
                break
        outs[variant] = [int(t) for t in e.slot_last_token]
        if variant == "gimbal+rep":
            assert e.relocations >= 1
            assert e.params["blocks"]["moe"]["w_gate"].shape[1] == tc.num_experts + 2
    assert outs["vllm"] == outs["gimbal+rep"]


def test_engines_sharing_one_cluster_level_match_reference(models):
    """Two engines share one ClusterExpertLevel: both observe into it, both
    tick it, and every backend applies its placements.  Two port engines
    and two reference engines, stepped in lockstep on the same split trace,
    give the same streams, events and slot maps."""
    jc, tc, tree, pt = models
    trace = _trace(n=10, seed=7)

    def run(pkg):
        cfg, params, gcfg, eng_cls, req_cls, make = (
            (tc, pt, GimbalConfig(tau=4), Engine, Request, make_cluster_expert_level)
            if pkg == "port" else
            (jc, tree, JaxGimbalConfig(tau=4), JaxEngine, JaxRequest, jax_cluster_level))
        level = make("gimbal+rep", cfg, 2, gcfg)
        kw = dict(SLOT_KW, variant="gimbal+rep", gimbal_cfg=gcfg, expert_level=level)
        if pkg == "port":
            kw["device"] = "cpu"
        engines = [eng_cls(i, cfg, params, **kw) for i in range(2)]
        assert engines[0].rebalancer is engines[1].rebalancer is level
        reqs = [req_cls(i, len(toks), m, a, prompt_tokens=toks, priority_class=c)
                for i, toks, m, a, c in copy.deepcopy(trace)]
        i, done, t = 0, [], 0.0
        for _ in range(200):
            while i < len(reqs) and reqs[i].arrival_time <= t:
                engines[i % 2].submit(reqs[i], t)
                i += 1
            for e in engines:
                done += e.step(t)
            t += 0.05
            if len(done) == len(reqs):
                break
        for e in engines:
            e.backend._sync_placement()
        return level, engines, done

    lt, et, dt_ = run("port")
    lj, ej, dj = run("jax")
    assert len(dt_) == len(dj) == len(trace)
    assert lt.migrations == lj.migrations >= 1
    assert [vars(e) for e in lt.events] == [vars(e) for e in lj.events]
    np.testing.assert_array_equal(lt.slot_map, lj.slot_map)
    for a, b in zip(et, ej):
        assert a.core.event_log() == b.core.event_log()
        assert a.relocations == b.relocations >= 1
        np.testing.assert_array_equal(a.backend._applied_map, lt.slot_map)
        assert list(a.slot_last_token) == list(b.slot_last_token)
    assert [(r.req_id, r.generated, r.finish_time) for r in dt_] == \
        [(r.req_id, r.generated, r.finish_time) for r in dj]


def test_apply_placement_gathers_like_reference(models):
    """A replicated slot map, then a relocation away from it: both backends
    gather the same expert weights into the same slots."""
    jc, tc, tree, pt = models
    jb = JaxBackend(jc, tree, max_slots=2, max_seq=32, kv_layout="paged")
    tb = TorchBackend(tc, pt, max_slots=2, max_seq=32, kv_layout="paged", device="cpu")
    for new_map in ([0, 1, 2, 3, 4, 5, 6, 7, 1, 5], [3, 1, 2, 0, 4, 6, 5, 7, 7, 2]):
        jb.apply_placement(np.array(new_map))
        tb.apply_placement(np.array(new_map))
        for n in ("w_gate", "w_up", "w_down"):
            got = tb.params["blocks"]["moe"][n]
            assert got.shape[1] == len(new_map)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jb.params["blocks"]["moe"][n]))
    assert tb.relocations == jb.relocations == 2
    tb.apply_placement(np.array([3, 1, 2, 0, 4, 6, 5, 7, 7, 2]))   # already laid out
    assert tb.relocations == 2
    assert torch.equal(tb.params["blocks"]["moe"]["w_router"], pt["blocks"]["moe"]["w_router"])
