"""The port's expert level against the JAX reference on the CPU: placement
solvers, affinity statistics, the Algorithm 3 rebalancer and the Gimbal
factories, fed the same numpy inputs.

Slot maps, assignments, counts and rebalance events must be exactly equal:
the solvers are numpy in both packages and the statistics are integers.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import affinity as jaff
from repro.core import eplb as jeplb
from repro.core import gimbal as jgimbal
from repro.core import placement as jpl
from repro_torch.configs import get_smoke_config
from repro_torch.core import affinity as taff
from repro_torch.core import eplb as teplb
from repro_torch.core import gimbal as tgimbal
from repro_torch.core import placement as tpl

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen3-30b-a3b"


def _stats(seed: int, layers: int, e: int, skew: float = 3.0):
    """Skewed activation counts A (L, E) and inter-layer traffic W (E, E)."""
    rng = np.random.default_rng(seed)
    hot = rng.random(e) ** skew
    a = rng.poisson(200 * hot[None, :] + 1, size=(layers, e)).astype(np.float64)
    w = rng.poisson(5 * np.outer(hot, hot) + 0.2, size=(e, e)).astype(np.float64)
    return a, w


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("e,g,r", [(8, 2, 2), (16, 4, 4), (128, 4, 4), (64, 8, 8)])
def test_placement_solvers_match_reference(seed, e, g, r):
    a, w = _stats(seed * 97 + e, 3, e)
    for name in ("eplb_placement",):
        np.testing.assert_array_equal(getattr(tpl, name)(a, g), getattr(jpl, name)(a, g))
    for anchor in (0, g - 1):
        np.testing.assert_array_equal(tpl.gimbal_placement(a, w, g, anchor=anchor),
                                      jpl.gimbal_placement(a, w, g, anchor=anchor))
    rep_t = tpl.eplb_placement_rep(a, g, r)
    np.testing.assert_array_equal(rep_t, jpl.eplb_placement_rep(a, g, r))
    grep_t = tpl.gimbal_placement_rep(a, w, g, r, anchor=1, top_e=8)
    np.testing.assert_array_equal(grep_t, jpl.gimbal_placement_rep(a, w, g, r, anchor=1, top_e=8))
    assert len(rep_t) == len(grep_t) == e + r
    assert set(rep_t.tolist()) == set(range(e))              # every expert keeps a slot
    static = tpl.perm_to_slot_map(tpl.static_placement(e, g))
    for inv in (static, rep_t, grep_t):
        assert tpl.rep_row_imbalance(a, inv, g) == jpl.rep_row_imbalance(a, inv, g)
        assert tpl.rep_comm_cut(w, inv, g) == jpl.rep_comm_cut(w, inv, g)
        assert tpl.placement_coupling(a, w, inv, g) == jpl.placement_coupling(a, w, inv, g)
        assert tpl.rep_migration_cost(static, inv, g, 7) == \
            jpl.rep_migration_cost(static, inv, g, 7)
    np.testing.assert_array_equal(tpl.replica_counts(a.sum(0), e + r),
                                  jpl.replica_counts(a.sum(0), e + r))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_milp_oracle_and_objective_match_reference(seed):
    a, w = _stats(seed, 2, 6)
    assign_t, val_t = tpl.milp_exact(a, w, 2)
    assign_j, val_j = jpl.milp_exact(a, w, 2)
    np.testing.assert_array_equal(assign_t, assign_j)
    assert val_t == val_j
    perm = tpl.gimbal_placement(a, w, 2)
    assign = tpl.perm_to_assignment(perm, 2)
    assert tpl.objective(a, w, assign, 2) == jpl.objective(a, w, assign, 2)
    assert tpl.objective(a, w, assign_t, 2) <= tpl.objective(a, w, assign, 2) + 1e-9
    assert tpl.migration_cost(tpl.static_placement(6, 2), perm, 2, 3) == \
        jpl.migration_cost(jpl.static_placement(6, 2), perm, 2, 3)


@pytest.mark.parametrize("shape,e", [((3, 4, 1, 2), 8), ((4, 2, 37, 8), 128),
                                     ((1, 3, 5, 2), 8), ((2, 1, 512, 8), 16)])
def test_accumulate_stats_matches_reference(shape, e):
    rng = np.random.default_rng(sum(shape) + e)
    ids = rng.integers(0, e, size=shape).astype(np.int32)
    a_t, w_t = taff.accumulate_stats(ids, e)
    a_j, w_j = jaff.accumulate_stats(jnp.asarray(ids), e)
    assert a_t.dtype == np.int32 and w_t.dtype == np.int32
    np.testing.assert_array_equal(a_t, np.asarray(a_j))
    np.testing.assert_array_equal(w_t, np.asarray(w_j))
    assert a_t.sum() == ids.size


def test_affinity_tracker_matches_reference():
    tt, tj = taff.AffinityTracker(3, 8, decay=0.8), jaff.AffinityTracker(3, 8, decay=0.8)
    rng = np.random.default_rng(4)
    for step in range(6):
        ids = rng.integers(0, 8, size=(3, 4, 1 + step % 3, 2)).astype(np.int32)
        tt.update(ids)
        tj.update(ids)
    np.testing.assert_array_equal(tt.A, tj.A)
    np.testing.assert_array_equal(tt.W, tj.W)
    assert tt.tokens_seen == tj.tokens_seen
    assert tt.affinity_pairs(top_e=5) == tj.affinity_pairs(top_e=5)
    np.testing.assert_array_equal(tt.hot_experts(), tj.hot_experts())
    assert tt.imbalance() == tj.imbalance()


def _id_stream(seed: int, cfg, steps: int):
    """Skewed per-step expert ids (L, B, 1, K), like decode stats."""
    rng = np.random.default_rng(seed)
    p = rng.random(cfg.num_experts) ** 3
    p /= p.sum()
    out = []
    for _ in range(steps):
        ids = np.stack([rng.choice(cfg.num_experts, cfg.moe_top_k, replace=False, p=p)
                        for _ in range(cfg.num_layers * 4)])
        out.append(ids.reshape(cfg.num_layers, 4, 1, cfg.moe_top_k).astype(np.int32))
    return out


@pytest.mark.parametrize("policy", ["static", "eplb", "gimbal"])
@pytest.mark.parametrize("redundancy", [0, 2])
def test_rebalancer_matches_reference(policy, redundancy):
    """Fed the same expert-id sequence, both rebalancers fire at the same
    steps with the same events (every field), slot maps and factor trails."""
    jc, tc = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    kw = dict(policy=policy, anchor=1, redundancy=redundancy)
    rt = teplb.ExpertRebalancer(tc, 2, cfg=tgimbal.GimbalConfig(tau=3), **kw)
    rj = jeplb.ExpertRebalancer(jc, 2, cfg=jgimbal.GimbalConfig(tau=3), **kw)
    for ids in _id_stream(5 + redundancy, tc, 20):
        rt.observe(ids)
        rj.observe(ids)
        nt, nj = rt.tick(), rj.tick()
        assert (nt is None) == (nj is None)
        if nt is not None:
            np.testing.assert_array_equal(nt, nj)
    assert [vars(e) for e in rt.events] == [vars(e) for e in rj.events]
    assert (len(rt.events) > 0) == (policy != "static")
    np.testing.assert_array_equal(rt.slot_map, rj.slot_map)
    assert rt.factor_trail == rj.factor_trail
    assert (rt.moe_mult, rt.cross_frac) == (rj.moe_mult, rj.cross_frac)
    assert (rt.migrations, rt.bytes_moved, rt.num_slots) == \
        (rj.migrations, rj.bytes_moved, rj.num_slots)
    np.testing.assert_array_equal(rt.placement_stack(3), rj.placement_stack(3))
    for a, b in zip(rt.placement(), rj.placement()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("variant", ["vllm", "eplb", "edr", "gimbal", "gimbal+rep", "combined"])
def test_factories_match_reference(variant):
    jc, tc = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    rt = tgimbal.make_rebalancer(variant, tc, 2, tgimbal.GimbalConfig(tau=4))
    rj = jgimbal.make_rebalancer(variant, jc, 2, jgimbal.GimbalConfig(tau=4))
    lt = tgimbal.make_cluster_expert_level(variant, tc, 2, tgimbal.GimbalConfig(tau=4))
    lj = jgimbal.make_cluster_expert_level(variant, jc, 2, jgimbal.GimbalConfig(tau=4))
    assert isinstance(lt, teplb.ClusterExpertLevel)
    for t, j in ((rt, rj), (lt, lj)):
        assert (t.policy, t.redundancy, t.g, t.anchor, t.cfg.tau) == \
            (j.policy, j.redundancy, j.g, j.anchor, j.cfg.tau)
        np.testing.assert_array_equal(t.slot_map, j.slot_map)
    dense = tc.replace(num_experts=0)
    assert tgimbal.make_rebalancer(variant, dense, 2) is None
    assert isinstance(tgimbal.make_cluster_expert_level(variant, dense, 2),
                      teplb.NullExpertLevel)


def _same_prior_level(t, j):
    np.testing.assert_array_equal(t.tracker.A, j.tracker.A)
    np.testing.assert_array_equal(t.tracker.W, j.tracker.W)
    np.testing.assert_array_equal(t.slot_map, j.slot_map)
    assert t.factor_trail == j.factor_trail


def test_synthetic_prior_waits_for_the_simulator_plane():
    """The synthetic prior is ported: ``SyntheticExpertLevel``,
    ``make_cluster_expert_level(prior_seed=..., hot_boost=...)`` and, with
    the simulator plane, its own factory ``make_sim_expert_level(seed=...)``
    seed the tracker as the reference's do; a dense config gets the
    NullExpertLevel from both packages."""
    jc, tc = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    _same_prior_level(teplb.SyntheticExpertLevel(tc, 2, seed=5),
                      jeplb.SyntheticExpertLevel(jc, 2, seed=5))
    for variant, boost in (("gimbal", 8.0), ("gimbal+rep", 3.0)):
        _same_prior_level(
            tgimbal.make_cluster_expert_level(variant, tc, 2, prior_seed=0,
                                              hot_boost=boost),
            jgimbal.make_cluster_expert_level(variant, jc, 2, prior_seed=0,
                                              hot_boost=boost))
    for variant, seed, boost in (("gimbal", 0, 8.0), ("gimbal+rep", 7, 3.0),
                                 ("eplb", 2, 8.0)):
        _same_prior_level(
            tgimbal.make_sim_expert_level(variant, tc, 2, seed=seed, hot_boost=boost),
            jgimbal.make_sim_expert_level(variant, jc, 2, seed=seed, hot_boost=boost))
    assert isinstance(tgimbal.make_sim_expert_level("gimbal", get_smoke_config("gemma2-2b"), 2),
                      teplb.NullExpertLevel)
    assert isinstance(jgimbal.make_sim_expert_level("gimbal", jax_smoke_config("gemma2-2b"), 2),
                      jeplb.NullExpertLevel)


def test_bytes_per_expert_bf16_without_jax():
    """numpy knows no bfloat16 unless JAX has registered ml_dtypes; the
    port sizes experts by the torch dtype, with JAX never imported."""
    code = """
import sys
from repro_torch.configs import get_config
from repro_torch.core.eplb import ExpertRebalancer
cfg = get_config("qwen3-30b-a3b").replace(num_layers=4)
assert cfg.dtype == "bfloat16"
rb = ExpertRebalancer(cfg, 4, redundancy=4)
assert not any(m.split(".")[0] in ("jax", "ml_dtypes") for m in sys.modules)
print(rb.bytes_per_expert())
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == 3 * 2048 * 768 * 2 * 4
    jc = jax_smoke_config(ARCH).replace(dtype="bfloat16")
    tc = get_smoke_config(ARCH).replace(dtype="bfloat16")
    assert teplb.ExpertRebalancer(tc, 2).bytes_per_expert() == \
        jeplb.ExpertRebalancer(jc, 2).bytes_per_expert()
