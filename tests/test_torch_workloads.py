"""The port's workload generators and synthetic expert prior against the JAX
reference on the CPU: the same arguments and seed must give the same trace,
every ``Request`` field equal (floats exactly, ``prompt_tokens``
array-equal), and the same (A, W, pairs) prior as the reference draws from
``jax.random.key(seed)``.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

from repro.core import affinity as jaff
from repro.core.types import Request as JaxRequest
from repro.workloads import arrivals as jarr
from repro.workloads import burstgpt_trace as j_burstgpt
from repro.workloads import mixed_trace as j_mixed
from repro.workloads import sharegpt_trace as j_sharegpt
from repro.workloads import suite_trace as j_suite
from repro.workloads.tenants import TenantSpec as JaxTenantSpec
from repro_torch.core import affinity as taff
from repro_torch.core.types import Request
from repro_torch.workloads import (ARRIVAL_PROCESSES, DISTRIBUTIONS, SUITES,
                                   TenantSpec, burstgpt_trace, make_arrivals,
                                   mixed_trace, sharegpt_trace, suite_trace)
from repro_torch.workloads import arrivals as tarr

FIELDS = [f.name for f in dataclasses.fields(JaxRequest)]


def _same_trace(got, want):
    assert len(got) == len(want) > 0
    assert [f.name for f in dataclasses.fields(Request)] == FIELDS
    for a, b in zip(got, want):
        assert isinstance(a, Request)
        for name in FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            if name == "prompt_tokens" and y is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert type(x) is type(y) and x == y, (a.req_id, name, x, y)


def test_registries_match():
    assert tuple(ARRIVAL_PROCESSES) == tuple(jarr.ARRIVAL_PROCESSES)
    from repro.workloads import DISTRIBUTIONS as JD, SUITES as JS
    assert DISTRIBUTIONS == JD
    assert tuple(SUITES) == tuple(JS)
    for name in SUITES:
        assert [dataclasses.asdict(s) for s in SUITES[name]] == \
            [dataclasses.asdict(s) for s in JS[name]]


@pytest.mark.parametrize("process", list(jarr.ARRIVAL_PROCESSES))
def test_make_arrivals_matches_reference(process):
    for seed, n, rps in ((0, 64, 4.0), (11, 200, 30.0)):
        got = make_arrivals(process, np.random.default_rng(seed), n, rps)
        want = jarr.make_arrivals(process, np.random.default_rng(seed), n, rps)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tarr.mmpp_gaps(np.random.default_rng(3), 50, 2.0, 4.0),
                                  jarr.mmpp_gaps(np.random.default_rng(3), 50, 2.0, 4.0))


@pytest.mark.parametrize(
    "distribution,arrival",
    list(itertools.product(("random", "central", "descending", "two-end", "average"),
                           ("mmpp", "poisson", "gamma", "diurnal", "flash"))))
@pytest.mark.parametrize("extras", [False, True])
def test_burstgpt_trace_matches_reference(distribution, arrival, extras):
    kw = dict(n=40, distribution=distribution, rps=3.0, seed=7, arrival=arrival)
    if extras:
        kw.update(with_users=True, vocab_size=5000, interactive_frac=0.4,
                  burstiness=4.0)
    _same_trace(burstgpt_trace(**kw), j_burstgpt(**kw))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(continue_p=0.6),
    dict(interactive_frac=0.5, slo_ttft=1.5, slo_tpot=0.2),
    dict(continue_p=0.3, interactive_frac=0.3, slo_ttft=0.8, max_context=96),
], ids=["default", "continue_p", "slos", "all"])
def test_sharegpt_trace_matches_reference(kw):
    args = dict(n_requests=60, n_users=7, rps=5.0, seed=3, vocab_size=2000,
                utterance_mean=20, answer_mean=16, max_context=256)
    args.update(kw)
    _same_trace(sharegpt_trace(**args), j_sharegpt(**args))


@pytest.mark.parametrize("sessions", [False, True])
def test_mixed_trace_matches_reference(sessions):
    specs = [dict(name="a", weight=2.0, priority_class="interactive",
                  prompt_dist="central", output_scale=0.5, slo_ttft=1.0,
                  slo_tpot=0.1, n_users=5),
             dict(name="b", weight=1.0, prompt_dist="two-end", n_users=3)]
    kw = dict(n=50, arrival="gamma", rps=6.0, seed=9, vocab_size=3000,
              sessions=sessions, max_context=200)
    got = mixed_trace(tuple(TenantSpec(**s) for s in specs), **kw)
    want = j_mixed(tuple(JaxTenantSpec(**s) for s in specs), **kw)
    _same_trace(got, want)


@pytest.mark.parametrize("suite", ["chat_vs_batch", "agents_vs_eval", "three_tier",
                                   "uniform"])
@pytest.mark.parametrize("arrival", ["mmpp", "flash"])
def test_suite_trace_matches_reference(suite, arrival):
    assert suite in SUITES
    for kw in (dict(), dict(sessions=True, vocab_size=4000, max_context=128)):
        args = dict(n=45, arrival=arrival, rps=8.0, seed=2, **kw)
        _same_trace(suite_trace(suite, **args), j_suite(suite, **args))


def test_unknown_names_raise_like_reference():
    with pytest.raises(ValueError, match="arrival process"):
        make_arrivals("bursty", np.random.default_rng(0), 4, 1.0)
    with pytest.raises(ValueError, match="suite"):
        suite_trace("nope", n=4)
    with pytest.raises(ValueError, match="vocab_size"):
        mixed_trace((TenantSpec("x"),), n=4, sessions=True)


@pytest.mark.parametrize("seed", [0, 1, 3, 7, 12345, 2**31 - 1, 2**31 + 5])
@pytest.mark.parametrize("hot_boost", [8.0, 2.5])
def test_synthetic_stats_matches_reference(seed, hot_boost):
    """The reference seeds numpy with the sum of ``key_data(key(seed))``;
    the port takes the integer seed and draws the same prior."""
    kw = dict(num_layers=3, num_experts=16, top_k=4, hot_boost=hot_boost)
    a, w, pairs = taff.synthetic_stats(seed, **kw)
    ja, jw, jpairs = jaff.synthetic_stats(jax.random.key(seed), **kw)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(w, jw)
    assert pairs == jpairs


@pytest.mark.parametrize("seed", [-1, 2**32])
def test_synthetic_stats_rejects_seeds_outside_a_key(seed):
    with pytest.raises(ValueError, match="seed"):
        taff.synthetic_stats(seed, 2, 8)
