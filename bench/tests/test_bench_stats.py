"""The end-to-end arithmetic on synthetic timelines."""
import numpy as np
import pytest

from bench.stats import Req, end_to_end, itls, output_tokens, ttfts


def _req(rid, due, stamps, finished=None):
    return Req(rid, due, np.zeros(4, np.int64), len(stamps), stamps=list(stamps),
               finished=finished)


def test_censored_ttft_enters_the_tail():
    reqs = {i: _req(i, 1.0 + 0.1 * i, [1.05 + 0.1 * i, 1.1 + 0.1 * i], 1.1 + 0.1 * i)
            for i in range(19)}
    base = end_to_end(reqs, 1.0, 11.0)
    assert abs(base["ttft_p95_ms"] - 50.0) < 1e-6
    reqs[99] = _req(99, 2.0, [])                     # never served: waits until the close
    got = ttfts(reqs, 1.0, 11.0)
    assert max(got) == 9.0
    assert end_to_end(reqs, 1.0, 11.0)["ttft_p95_ms"] > 400
    reqs[98] = _req(98, 0.5, [])                     # due before the window: not counted
    assert len(ttfts(reqs, 1.0, 11.0)) == 20


def _timeline(gaps, n=8):
    stamps = 1.0 + np.cumsum(gaps)
    return {i: _req(i, 0.0, list(stamps), stamps[-1]) for i in range(n)}


def test_a_stall_moves_itl_p95():
    steady = _timeline([0.02] * 300)
    assert end_to_end(steady, 1.0, 10.0)["itl_p95_ms"] == pytest.approx(20.0)
    # every tenth step stalls 100 ms more: a tenth of the gaps, past the 95th percentile
    stalled = _timeline([0.12 if i % 10 == 9 else 0.02 for i in range(300)])
    assert end_to_end(stalled, 1.0, 20.0)["itl_p95_ms"] == pytest.approx(120.0)
    # one stall a request is 1 gap in 300: the tail does not see it, the median neither
    once = _timeline([0.6 if i == 150 else 0.02 for i in range(300)])
    assert end_to_end(once, 1.0, 20.0)["itl_p95_ms"] == pytest.approx(20.0)


def test_a_stall_moves_itl_mean():
    """The mean gap sees every stall, the one the tail misses too."""
    steady = _timeline([0.02] * 300)
    assert end_to_end(steady, 1.0, 10.0)["itl_mean_ms"] == pytest.approx(20.0)
    once = _timeline([0.6 if i == 150 else 0.02 for i in range(300)])
    got = end_to_end(once, 1.0, 20.0)["itl_mean_ms"]
    assert got == pytest.approx(1e3 * (0.6 + 0.02 * 298) / 299)


def test_open_gap_at_the_close_and_window_tokens():
    reqs = {0: _req(0, 0.0, [1.0, 1.1, 1.2]),          # unfinished, silent since 1.2
            1: _req(1, 0.0, [1.0, 1.5], finished=1.5)}
    assert sorted(itls(reqs, 1.0, 4.0)) == pytest.approx([0.1, 0.1, 0.5, 4.0 - 1.2])
    assert output_tokens(reqs, 1.1, 4.0) == 3
    assert end_to_end(reqs, 1.0, 4.0)["output_tok_per_s"] == 5 / 3.0
