"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at smoke
widths on the CPU, once for each fault a served cell can have, and once
unbroken.  The limits are the cell's own ``check``."""
import pytest

from bench import run as R
from bench.tests.tiny import tiny_cell

CELLS = ("qwen3-burstgpt-mmpp", "dsv2-reasoning-closed")


@pytest.fixture(autouse=True)
def _few_threads():
    """The window is wall-clock: keep this file's runs from competing with
    the other test workers for every core."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, seed=2**31 + 21):
    cell, port_cfg = tiny_cell(name, max_slots=4)
    res = R.run_cell(cell, seed, 4.0, False, device="cpu", port_cfg=port_cfg)
    assert res["window"]["finished"] > 0 and res["window"]["served_tokens_compared"] > 0
    return res


@pytest.mark.parametrize("name", CELLS)
def test_unbroken_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_token_altered_where_produced_is_not_correct(name, monkeypatch):
    """Each decode step serves one row, in turn, the token its logits rank
    last: a token in four altered at four rows."""
    from repro_torch.models import model as M
    calls = {"n": 0}
    for fn_name in ("decode_step", "decode_step_paged"):
        orig = getattr(M, fn_name)

        def broken(*a, _orig=orig, **kw):
            logits, cache, aux = _orig(*a, **kw)
            calls["n"] += 1
            row = calls["n"] % logits.shape[0]
            logits = logits.clone()
            logits[row] = -logits[row]
            return logits, cache, aux
        monkeypatch.setattr(M, fn_name, broken)
    res = _run(name)
    assert calls["n"] > 3
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_is_not_correct(name, monkeypatch):
    """The prefill's keys and values never reach the cache: decode steps run
    on a cache the prefill left as it was."""
    from repro_torch.serving import backend, kvcache
    monkeypatch.setattr(kvcache.PagedKVCache, "write_prefill", lambda self, slot, c: None)
    monkeypatch.setattr(backend, "write_slot", lambda cache, slot_cache, slot, axes: None)
    res = _run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_router_out_of_the_probes_sight_is_not_correct(name, monkeypatch):
    """The program reaches its router by a name the probe does not wrap (the
    module attribute put back as the probe is built): the decode steps'
    routes go unrecorded, and the run says so instead of reading 0
    capacity mismatches."""
    from bench import serve
    from repro_torch.models import moe
    unwrapped = moe.route_replicated
    init = serve.Probe.__init__

    def blind(self, *a, **kw):
        init(self, *a, **kw)
        moe.route_replicated = unwrapped
    monkeypatch.setattr(serve.Probe, "__init__", blind)
    res = _run(name)
    assert res["checks"]["decode_routes_unseen"]["value"] > 0
    assert not res["correct"], res["checks"]
