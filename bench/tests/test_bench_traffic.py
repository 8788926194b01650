"""The traffic generator: the same seed gives the same requests, every
seed the same sizes and arrival times, and the frozen laws draw what the
program's generators draw."""
from collections import Counter

import numpy as np
import pytest

from bench import spec, traffic


def _mix(name):
    return spec.find_cell(name).traffic


def test_open_loop_deterministic_and_same_work_for_every_seed():
    mix = _mix("qwen3-burstgpt-mmpp")
    a = traffic.open_loop(mix, 2**31 + 7, 151936, 8191)
    b = traffic.open_loop(mix, 2**31 + 7, 151936, 8191)
    c = traffic.open_loop(mix, 5, 151936, 8191)
    assert [(j.due, j.out_len, len(j.prompt)) for j in a] == \
        [(j.due, j.out_len, len(j.prompt)) for j in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [j.due for j in a] == [j.due for j in c]
    # the cell's mix keeps the master order: the same sizes at the same times
    assert mix["order"] == "fixed"
    assert [(j.out_len, len(j.prompt)) for j in a] == [(j.out_len, len(j.prompt)) for j in c]
    assert not np.array_equal(a[0].prompt[:16], c[0].prompt[:16])
    # by phase, the seed orders the same sizes
    by_phase = dict(mix, order="phase")
    pa = traffic.open_loop(by_phase, 2**31 + 7, 151936, 8191)
    pc = traffic.open_loop(by_phase, 5, 151936, 8191)
    assert [j.due for j in pa] == [j.due for j in a]
    assert sorted((j.out_len, len(j.prompt)) for j in pa) == \
        sorted((j.out_len, len(j.prompt)) for j in pc) == \
        sorted((j.out_len, len(j.prompt)) for j in a)
    assert [j.out_len for j in pa] != [j.out_len for j in pc]
    with pytest.raises(ValueError):
        traffic.open_loop(dict(mix, order="shuffled"), 5, 151936, 8191)
    # the MMPP: over the run about 0.69 x rps, bursts at 2.5 x rps
    rps = mix["arrival"]["rps"]
    rate = len(a) / a[-1].due
    assert 0.55 * rps < rate < 0.85 * rps
    assert all(16 <= len(j.prompt) <= 6000 and 8 <= j.out_len <= 1024 for j in a)


def test_open_loop_keeps_each_phase_work():
    mix = _mix("qwen3-burstgpt-mmpp")
    master = np.random.default_rng(mix["master_seed"])
    _, phase = traffic.arrivals(master, mix["requests"], mix["arrival"])
    for order in ("fixed", "phase"):
        m = dict(mix, order=order)
        a = traffic.open_loop(m, 1, 1000, 8191)
        b = traffic.open_loop(m, 2, 1000, 8191)
        for p in np.unique(phase)[:20]:
            idx = np.flatnonzero(phase == p)
            assert sorted(a[i].out_len for i in idx) == sorted(b[i].out_len for i in idx)


def test_closed_loop_clients_and_equilibrium_start():
    mix = _mix("dsv2-reasoning-closed")
    a = traffic.closed_loop(mix, 3, 102400, 4095)
    b = traffic.closed_loop(mix, 4, 102400, 4095)
    assert len(a) == mix["clients"] and all(len(c) == mix["requests"] for c in a)
    assert sorted(c[0].out_len for c in a) == sorted(c[0].out_len for c in b)
    assert len({j.rid for c in a for j in c}) == mix["clients"] * mix["requests"]
    later = [j.out_len for c in a for j in c[1:]]
    assert min(later) >= 256 and max(later) <= 3500
    assert 900 < np.median(later) < 1500
    firsts = [c[0].out_len for c in a]
    assert min(firsts) < 600            # a uniform share of a length-biased draw
    assert all(64 <= len(j.prompt) <= 512 for c in a for j in c)
    # a client's list is the master list in another order, its first item
    # giving way to the equilibrium request: all but one size a client agree
    for ca, cb in zip(a, b):
        la, lb = sorted(j.out_len for j in ca[1:]), sorted(j.out_len for j in cb[1:])
        common = sum((Counter(la) & Counter(lb)).values())
        assert common >= len(la) - 1


def test_frozen_laws_match_the_program_generators():
    from repro_torch.workloads import arrivals as A
    from repro_torch.workloads import burstgpt as B
    for dist in B.DISTRIBUTIONS:
        want = B._sample_prompt_lens(np.random.default_rng(3), 500, dist)
        got = traffic.burstgpt_prompt_lens(np.random.default_rng(3), 500, dist)
        assert np.array_equal(want, got)
    want = A.mmpp_gaps(np.random.default_rng(4), 300, 2.0, 2.5)
    got, phase = traffic.mmpp_gaps(np.random.default_rng(4), 300, 2.0, 2.5)
    assert np.array_equal(want, got) and phase[-1] > 3
    law = {"law": "lognormal", "mu": 4.6, "sigma": 0.7, "min": 8, "max": 1024}
    assert np.array_equal(B._sample_output_lens(np.random.default_rng(5), 400),
                          traffic.output_lens(np.random.default_rng(5), 400, law))


def test_subseed_takes_large_and_negative_seeds():
    s = {traffic.subseed(x, "w") for x in (0, 1, 2**31 + 5, 2**40, -3)}
    assert len(s) == 5 and all(0 <= v < 2**63 for v in s)
