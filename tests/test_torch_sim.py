"""The port's simulator plane against the JAX reference's, on the CPU.

* Parameter counts and KV bytes of all eleven registered architectures,
  and every ``CostModel`` term on the reference's ``a100`` and ``v5e``
  profiles, must equal the reference's exactly (the same float operations
  in the same order).
* Port twins of the reference's parity oracles
  (``tests/test_scheduler_parity.py``): the port's ``SimEngine`` (cost-model
  backend) against the port's real-compute ``Engine`` (``TorchBackend`` on
  the CPU, a tiny f32 MoE) must emit byte-identical scheduling event
  streams, rebalance events and block accounting; the port's simulated
  stream must also equal the reference ``SimEngine``'s.
* ``simulate()`` on one BurstGPT trace for "vllm", "gimbal" and
  "gimbal+rep", under a fault drill and as a 1P+1D cluster: every
  ``SimResult`` field equal to the reference's.
"""
import copy
import dataclasses
import math

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.gimbal import make_sim_expert_level as jax_sim_level
from repro.core.types import GimbalConfig as JaxGimbalConfig
from repro.distributed.fault import HealthConfig as JaxHealthConfig
from repro.models.config import ModelConfig as JaxModelConfig
from repro.sim import costmodel as jcost
from repro.sim.simulator import SimEngine as JaxSimEngine
from repro.sim.simulator import simulate as jax_simulate
from repro.workloads.burstgpt import burstgpt_trace as jax_burstgpt
from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_smoke_config, list_archs
from repro_torch.core.gimbal import make_cluster_expert_level, make_sim_expert_level
from repro_torch.core.types import GimbalConfig
from repro_torch.distributed.fault import HealthConfig
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import Engine
from repro_torch.sim import costmodel as tcost
from repro_torch.sim.simulator import SimEngine, simulate
from repro_torch.workloads.burstgpt import burstgpt_trace

MAX_SLOTS = 4
MAX_SEQ = 64
BUDGET = 48


def _plain(x):
    """A value as plain Python, so that the two packages' dataclasses compare
    field by field (NaN equal to NaN)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


# --- configs and the cost model ---------------------------------------------------

def test_registry_matches_reference():
    from repro import configs as jconfigs
    assert list_archs() == jconfigs.list_archs()
    assert ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_match_reference(arch):
    for tc, jc in ((get_config(arch), jax_get_config(arch)),
                   (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.total_params() == jc.total_params()
        assert tc.active_params() == jc.active_params()
        assert tc.kv_bytes_per_token() == jc.kv_bytes_per_token()
        assert (tc.q_head_dim, tc.o_head_dim, tc.ssm_d_inner, tc.ssm_heads,
                tc.num_attention_layers(), tc.num_moe_layers()) == \
            (jc.q_head_dim, jc.o_head_dim, jc.ssm_d_inner, jc.ssm_heads,
             jc.num_attention_layers(), jc.num_moe_layers())


def _cost_terms(cm):
    """Every number a CostModel exposes, over a grid of its inputs."""
    out = {k: getattr(cm, k) for k in ("active_params", "total_params", "expert_bytes",
                                       "nonexpert_bytes", "n_moe_layers",
                                       "expert_flop_frac", "kv_bytes_tok")}
    for tokens in (0, 1, 8, 100, 2048, 40_000):
        out[("expert_eff", tokens)] = cm._expert_eff(tokens)
        out[("a2a", tokens)] = cm._a2a_time(tokens, 0.37)
        for mult, cross in ((1.0, 0.5), (1.7, 0.2)):
            out[("prefill", tokens, mult)] = cm.prefill_time(tokens, mult, cross)
            out[("prefill_layer", tokens, mult)] = cm.prefill_layer_time(tokens, mult, cross)
            out[("compute", tokens, mult)] = cm._compute_time(1e12 + tokens, mult, tokens)
    for batch, ctx in ((0, 0.0), (1, 17.0), (32, 512.5), (256, 3000.0)):
        for rep in (1.0, 1.125):
            out[("decode", batch, ctx, rep)] = cm.decode_time(batch, ctx, 1.3, 0.4, rep)
            out[("iteration", batch, ctx, rep)] = cm.iteration_time(
                333, batch, ctx, 1.3, 0.4, queue_len=7, rep_factor=rep)
    out["migration"] = cm.migration_time(123_456_789)
    out["capacity"] = cm.kv_capacity_tokens()
    out["capacity_h"] = cm.kv_capacity_tokens(0.5)
    return out


@pytest.mark.parametrize("block_size", [1, 16])
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-30b-a3b", "deepseek-v2-236b"])
@pytest.mark.parametrize("hw", ["a100", "v5e"])
def test_cost_model_terms_match_reference(hw, arch, block_size):
    assert _plain(tcost.PROFILES[hw]) == _plain(jcost.PROFILES[hw])
    t = tcost.CostModel(get_config(arch), tcost.PROFILES[hw], 4, block_size=block_size)
    j = jcost.CostModel(jax_get_config(arch), jcost.PROFILES[hw], 4, block_size=block_size)
    assert _cost_terms(t) == _cost_terms(j)


# --- event-stream parity: the port's SimEngine against the port's Engine ----------

def tiny_moe():
    return ModelConfig(name="t", family="moe", num_layers=2, d_model=32,
                       num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                       vocab_size=64, num_experts=4, moe_top_k=2, moe_d_ff=32,
                       capacity_factor=8.0, dtype="float32")


def _jax_tiny_moe():
    return JaxModelConfig(**dataclasses.asdict(tiny_moe()))


def scaled_trace(trace_fn=burstgpt_trace, n=32, seed=5, interactive_frac=0.3):
    """A BurstGPT trace folded down to the tiny engine's envelope (the
    reference oracle's ``scaled_trace``)."""
    trace = trace_fn(n=n, rps=40.0, seed=seed, burstiness=4.0,
                     interactive_frac=interactive_frac)
    for r in trace:
        r.prompt_len = 4 + (r.prompt_len % 28)
        r.max_new_tokens = 4 + (r.max_new_tokens % 12)
        r.prompt_tokens = None
    return trace


def _session_trace(n=28, seed=23, n_users=4):
    """Token-carrying: per-user shared 16-token prefixes."""
    rng = np.random.default_rng(seed)
    trace = scaled_trace(n=n, seed=seed)
    prefixes = {u: rng.integers(0, 64, 16).tolist() for u in range(n_users)}
    for j, r in enumerate(trace):
        u = j % n_users
        r.user_id = f"u{u}"
        suffix = rng.integers(0, 64, r.prompt_len % 16).tolist()
        r.prompt_tokens = np.asarray(prefixes[u] + suffix, dtype=np.int64)
        r.prompt_len = len(r.prompt_tokens)
    return trace


_PARAMS = {}


def _params():
    if "p" not in _PARAMS:
        _PARAMS["p"] = TM.init_params(tiny_moe(), seed=0, device="cpu")
    return _PARAMS["p"]


def drive(core, trace, n_steps=600, dt=0.05, each_step=None):
    """Same submit times, same logical step clock, for either core."""
    pending = sorted(trace, key=lambda r: (r.arrival_time, r.req_id))
    i, t, done = 0, 0.0, []
    for _ in range(n_steps):
        while i < len(pending) and pending[i].arrival_time <= t:
            core.submit(pending[i], t)
            i += 1
        done += core.step(t)[1]
        if each_step is not None:
            each_step(core)
        t += dt
        if i == len(pending) and len(done) == len(pending):
            break
    return done


def _sim(pkg_engine, cfg, gcfg, level, **kw):
    cm = tcost if pkg_engine is SimEngine else jcost
    return pkg_engine(0, cm.CostModel(cfg, cm.PROFILES["a100"], 2,
                                      block_size=kw.pop("block_size", 1)),
                      gcfg, sjf=True, expert_level=level, prefill_budget=BUDGET,
                      max_running=MAX_SLOTS, kv_pool_tokens=MAX_SLOTS * MAX_SEQ, **kw)


@pytest.mark.parametrize("preemption", [False, True])
def test_event_streams_identical(preemption):
    gkw = dict(enable_preemption=preemption, tau=10_000, theta_age=1.0)
    gcfg, cfg = GimbalConfig(**gkw), tiny_moe()
    eng = Engine(0, cfg, _params(), variant="gimbal", gimbal_cfg=gcfg,
                 max_slots=MAX_SLOTS, max_seq=MAX_SEQ, prefill_budget=BUDGET,
                 num_expert_devices=2, device="cpu")
    sim = _sim(SimEngine, cfg, gcfg, make_sim_expert_level("gimbal", cfg, 2, gcfg))
    jgcfg = JaxGimbalConfig(**gkw)
    jsim = _sim(JaxSimEngine, _jax_tiny_moe(), jgcfg,
                jax_sim_level("gimbal", _jax_tiny_moe(), 2, jgcfg))
    trace = scaled_trace()
    done_e = drive(eng.core, [copy.copy(r) for r in trace])
    done_s = drive(sim.core, [copy.copy(r) for r in trace])
    done_j = drive(jsim.core, [copy.copy(r) for r in scaled_trace(jax_burstgpt)])
    assert len(done_e) == len(done_s) == len(done_j) == len(trace)
    log_e = eng.core.event_log()
    assert len(log_e) >= 2 * len(trace)
    assert log_e == sim.core.event_log() == jsim.core.event_log()
    if preemption:
        assert "preempt" in [k for k, _, _ in log_e]
        assert eng.core.preemptions == sim.core.preemptions > 0


def test_cluster_expert_level_event_stream_parity():
    """The live engine's routed stats, replayed through the simulator plane's
    level (same synthetic prior, decay and tick cadence), reproduce its
    RebalanceEvent stream field by field."""
    gcfg, cfg = GimbalConfig(tau=50, theta_age=1.0), tiny_moe()
    lvl_e = make_cluster_expert_level("gimbal", cfg, 2, gcfg, prior_seed=3)
    eng = Engine(0, cfg, _params(), variant="gimbal", gimbal_cfg=gcfg,
                 max_slots=MAX_SLOTS, max_seq=MAX_SEQ, prefill_budget=BUDGET,
                 expert_level=lvl_e, device="cpu")
    recorded = []
    orig_observe = lvl_e.observe
    lvl_e.observe = lambda ids: (recorded.append(np.asarray(ids)), orig_observe(ids))[1]
    trace = scaled_trace(seed=13)
    assert len(drive(eng.core, [copy.copy(r) for r in trace])) == len(trace)
    assert lvl_e.migrations >= 1, "trace never fired a rebalance"

    lvl_s = make_cluster_expert_level("gimbal", cfg, 2, gcfg, prior_seed=3)
    sim = _sim(SimEngine, cfg, gcfg, lvl_s)
    replay = iter(recorded)
    be = sim.core.backend
    be.decode = lambda act, now, _o=be.decode: (_o(act, now)[0], next(replay))
    assert len(drive(sim.core, [copy.copy(r) for r in trace])) == len(trace)
    assert eng.core.event_log() == sim.core.event_log()
    assert lvl_e.events == lvl_s.events
    assert (lvl_e.moe_mult, lvl_e.cross_frac) == (lvl_s.moe_mult, lvl_s.cross_frac)
    np.testing.assert_array_equal(lvl_e.slot_map, lvl_s.slot_map)


def test_block_accounting_event_stream_parity():
    """A shared-prefix trace under a 6-block pool: the paged live engine and
    the cost-model backend defer, preempt and pin blocks identically, and
    the core's distinct-block count tracks the device pool."""
    gcfg, cfg = GimbalConfig(enable_preemption=True, tau=10_000, theta_age=1.0), tiny_moe()
    eng = Engine(0, cfg, _params(), variant="gimbal", gimbal_cfg=gcfg,
                 max_slots=MAX_SLOTS, max_seq=MAX_SEQ, prefill_budget=BUDGET,
                 num_expert_devices=2, kv_layout="paged", kv_block_size=16, device="cpu")
    sim = _sim(SimEngine, cfg, gcfg, make_sim_expert_level("gimbal", cfg, 2, gcfg),
               kv_block_size=16, max_ctx_tokens=MAX_SEQ, block_size=16)
    sim.core.backend.charge_prefix_hits = False
    eng.backend.kv_capacity = sim.core.backend.kv_capacity = 6 * 16
    peak = {"blocks": 0}

    def check(core):
        dev = eng.backend.kv.blocks_used
        assert dev <= core.kv_blocks <= dev + core.num_running()
        peak["blocks"] = max(peak["blocks"], core.kv_blocks)

    trace = _session_trace(seed=31)
    done_e = drive(eng.core, [copy.copy(r) for r in trace], each_step=check)
    done_s = drive(sim.core, [copy.copy(r) for r in trace])
    assert len(done_e) == len(done_s) == len(trace)
    assert eng.core.event_log() == sim.core.event_log()
    assert 6 <= peak["blocks"] <= 10
    assert eng.core.preemptions == sim.core.preemptions
    assert eng.backend.kv.shared_hits > 0
    for core in (eng.core, sim.core):
        assert core.kv_blocks == 0 and not core._shared_refs
    assert eng.backend.kv.blocks_used == 0


# --- simulate(): every SimResult field equal to the reference's ------------------------

@pytest.mark.parametrize("mode", ["drill", "1p1d"])
@pytest.mark.parametrize("variant", ["vllm", "gimbal", "gimbal+rep"])
def test_simulate_matches_reference(variant, mode):
    """One BurstGPT trace at full qwen3-30b-a3b size on the a100 profile:
    with the "kill_restore" drill and heartbeat auto-detection, or as one
    prefill and one decode engine with layered prefill."""
    kw = dict(n_engines=2, hw="a100", kv_pool_tokens=60_000, seed=1)
    gkw = dict(tau=200, redundancy=16) if variant == "gimbal+rep" else dict(tau=200)
    if mode == "drill":
        health = dict(heartbeat_timeout=0.5, suspect_strikes=2)
        tkw = dict(kw, drill="kill_restore", health=HealthConfig(**health))
        jkw = dict(kw, drill="kill_restore", health=JaxHealthConfig(**health))
    else:
        tkw = jkw = dict(kw, roles=("prefill", "decode"), prefill_mode="layered",
                         prefill_budget=1024)
    trace = dict(n=80, rps=8.0, seed=3, burstiness=4.0, interactive_frac=0.3)
    got = simulate(burstgpt_trace(**trace), variant, get_config("qwen3-30b-a3b"),
                   gcfg=GimbalConfig(**gkw), **tkw)
    want = jax_simulate(jax_burstgpt(**trace), variant, jax_get_config("qwen3-30b-a3b"),
                        gcfg=JaxGimbalConfig(**gkw), **jkw)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert _plain(getattr(got, f.name)) == _plain(getattr(want, f.name)), f.name
    assert got.prefix_hit_rate == want.prefix_hit_rate
    assert got.report.n == 80
    if mode == "drill":
        assert [k for k, _ in got.lifecycle].count("restore") == 1 and got.rerouted > 0
    else:
        assert len(got.kv_transfers) == 80 and got.kv_transfer_s > 0
    if variant != "vllm":
        assert got.migrations >= 1
