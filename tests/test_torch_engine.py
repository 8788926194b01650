"""The port's serving engine against the JAX reference on the CPU: the same
shared-prefix, token-carrying trace through a JAX ``Engine`` and a port
``Engine`` built with the same bridged weights (qwen3-30b-a3b smoke config,
f32, paged KV, fused MoE, kernel path, no expert level).

The scheduling decision streams must be byte-identical, greedy token
streams identical, prefix pages shared, and the page pool drained.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.types import GimbalConfig as JaxGimbalConfig
from repro.core.types import Request as JaxRequest
from repro.models import model as JM
from repro.serving.backend import JaxBackend
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.eplb import NullExpertLevel
from repro_torch.core.types import GimbalConfig, Request
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.engine import Engine

ARCH = "qwen3-30b-a3b"
ENGINE_KW = dict(variant="gimbal", max_slots=4, max_seq=64, prefill_budget=48,
                 kv_layout="paged", kv_block_size=16, dispatch_mode="fused",
                 use_kernels=True, expert_level=None)


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
    jc, tc, tree, pt = models
    kw = dict(ENGINE_KW, expert_level=NullExpertLevel())
    eng = Engine(0, tc, pt, device="cpu", **kw)
    assert eng.rebalancer is None and eng.backend.rebalancer is None
    with pytest.raises(NotImplementedError, match="expert level"):
        Engine(0, tc, pt, device="cpu", **{k: v for k, v in ENGINE_KW.items()
                                           if k != "expert_level"})
    with pytest.raises(NotImplementedError, match="slot"):
        Engine(0, tc, pt, device="cpu", **dict(ENGINE_KW, kv_layout="slot"))


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
