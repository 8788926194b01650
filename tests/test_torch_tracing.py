"""The port's in-memory spans and counters (``repro_torch.tracing``) on the
CPU: an ``Engine`` at the qwen3-30b-a3b smoke widths on the paged layout
with fused dispatch, stepped with no profiler and under
``torch.profiler.profile(activities=[CPU])``.

Tracing is on exactly while a profiler records: with none, every span site
hands back ``tracing.NULL`` and no session opens.  Under one the spans
nest, sit on the profiler's clock and the counters equal hand counts.  The
sync hook is driven by a planted warning of the text torch's CUDA sync
debug mode emits, so it runs without CUDA.
"""
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.core.types import GimbalConfig, Request
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.engine import Engine

ARCH = "qwen3-30b-a3b"
MAX_SLOTS, MAX_SEQ = 4, 64
PROMPTS = (10, 17, 24, 5, 33)


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config(ARCH)
    return cfg, M.init_params(cfg, 0, device="cpu")


@pytest.fixture(autouse=True)
def closed_sessions():
    """No session outlives a test, even a failed one."""
    yield
    tracing.last()
    assert not tracing._on


def _engine(model):
    cfg, params = model
    eng = Engine(0, cfg, params, variant="gimbal", gimbal_cfg=GimbalConfig(tau=3),
                 max_slots=MAX_SLOTS, max_seq=MAX_SEQ, prefill_budget=48,
                 kv_layout="paged", kv_block_size=16, dispatch_mode="fused",
                 use_kernels=True, device="cpu")
    rng = np.random.default_rng(7)
    for i, n in enumerate(PROMPTS):
        toks = rng.integers(0, cfg.vocab_size, n)
        eng.submit(Request(req_id=i, prompt_len=n, max_new_tokens=4 + i, arrival_time=0.0,
                           prompt_tokens=toks), 0.0)
    return eng


def _drain(eng, on_step=lambda eng: None):
    k = 0
    while not eng.core.idle:
        on_step(eng)
        eng.step(0.1 * k)
        k += 1
    return k


def _profiled_run(model, on_step=lambda eng: None):
    """A whole run under the CPU profiler; the session is read after it."""
    eng = _engine(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drain(eng, on_step)
    return eng, prof, tracing.last()


def test_no_profiler_no_session_and_null_spans(model, monkeypatch):
    handed = []
    span = tracing.span

    def watch(name):
        handed.append(span(name))
        return handed[-1]

    monkeypatch.setattr(tracing, "span", watch)
    before = tracing.last()
    eng = _engine(model)
    assert _drain(eng) > 1
    assert tracing.last() is before and not tracing._on
    assert len(handed) > 100 and all(s is tracing.NULL for s in handed)


def test_spans_nest_in_order(model):
    cfg = model[0]
    _, _, s = _profiled_run(model)
    assert s is not None and s.end is not None
    for sp in s.spans:
        assert sp.start <= sp.end
        if sp.parent >= 0:
            p = s.spans[sp.parent]
            assert p.start <= sp.start and sp.end <= p.end
    steps = s.find("step")
    assert steps and all(sp.parent == -1 for sp in steps)
    decode = next(i for i, sp in enumerate(s.spans) if sp.name == "decode")
    kids = lambda i: [j for j, sp in enumerate(s.spans) if sp.parent == i]   # noqa: E731
    names = lambda ix: [s.spans[j].name for j in ix]                         # noqa: E731
    assert s.path(decode) == "step/decode"
    assert names(kids(decode)) == ["decode.inputs", "decode.model", "decode.readback",
                                   "decode.stats"]
    model_span = kids(decode)[1]
    layers = kids(model_span)
    assert names(layers) == ["layer"] * cfg.num_layers
    assert names(kids(layers[0])) == ["layer.placement", "attention", "moe"]
    moe = kids(layers[0])[2]
    assert names(kids(moe)) == ["route", "dispatch", "experts", "combine"]
    prefill = next(i for i, sp in enumerate(s.spans) if sp.name == "prefill")
    assert s.path(prefill) == "step/prefill"
    assert names(kids(prefill)) == ["prefill.model", "prefill.kv_write", "prefill.readback"]
    tick = s.find("expert.tick")
    assert len(tick) == len(steps) and s.find("expert.observe") and s.find("schedule")


def test_spans_share_the_profilers_clock(model):
    _, prof, s = _profiled_run(model)
    readback = [(sp.start, sp.end) for sp in s.spans if sp.name.endswith(".readback")]
    argmax = [ev.start_ns() for ev in prof.profiler.kineto_results.events()
              if ev.name() == "aten::argmax"]
    assert len(argmax) == len(readback) > 0
    for t in argmax:
        assert any(a <= t <= b for a, b in readback), t


def test_counters_equal_hand_counts(model):
    live = []
    eng, _, s = _profiled_run(model, lambda eng: live.append(len(eng.core.running)))
    decodes = sum(n > 0 for n in live)
    assert eng.core.preemptions == 0
    assert s.counters["decode_rows_live"] == sum(live)
    assert s.counters["decode_rows"] == decodes * MAX_SLOTS
    assert len(s.find("decode")) == decodes and len(s.find("prefill")) == len(PROMPTS)
    assert len(s.find("step")) == len(live)


def test_session_closes_once_the_profiler_stops(model):
    """Whichever comes first after the profiler stops closes the session: a
    span site, a sync's warning, the next step or ``last()``.  The warning
    hook goes with it, and nothing after the stop is recorded."""
    show = warnings.showwarning
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.poll()
        with tracing.span("a"):
            pass
    assert tracing._on and warnings.showwarning is not show
    assert tracing.span("b") is tracing.NULL
    assert not tracing._on and warnings.showwarning is show
    s = tracing.last()
    assert [sp.name for sp in s.spans] == ["a"] and s.end is not None

    with profile(activities=[ProfilerActivity.CPU]):
        tracing.poll()
        warnings.warn(tracing.SYNC_MESSAGE)
    warnings.warn(tracing.SYNC_MESSAGE)                # after the stop: closes, not counted
    assert not tracing._on and warnings.showwarning is show
    assert tracing.last().syncs_by_path() == {"": 1}

    eng = _engine(model)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step(0.0)
        eng.step(0.1)
    assert tracing._on
    eng.step(0.2)
    assert not tracing._on and len(tracing.last().find("step")) == 2


def test_scheduler_core_alone_opens_no_session(model):
    """The host-only simulator steps ``SchedulerCore`` itself: only
    ``Engine.step`` polls the profiler, so that records nothing."""
    before = tracing.last()
    eng = _engine(model)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(3):
            eng.core.step(0.1 * k)
    assert tracing.last() is before and not tracing._on


def test_sync_hook_counts_by_innermost_span():
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")               # once a line, as a process starts
        with profile(activities=[ProfilerActivity.CPU]):
            tracing.poll()
            with tracing.span("step"):
                with tracing.span("decode"):
                    with tracing.span("decode.readback"):
                        for _ in range(2):             # one line: each call counts
                            warnings.warn(tracing.SYNC_MESSAGE + " (planted)")
                    warnings.warn(tracing.SYNC_MESSAGE)
            warnings.warn(tracing.SYNC_MESSAGE)
            warnings.warn("another warning")
        s = tracing.last()
        warnings.warn(tracing.SYNC_MESSAGE + " after the session")
    assert s.syncs_by_path() == {"step/decode/decode.readback": 2, "step/decode": 1, "": 1}
    assert s.syncs_within("decode") == 3
    # nothing of the session's syncs is shown; other warnings and those after it are
    assert [str(w.message) for w in shown] == ["another warning",
                                               tracing.SYNC_MESSAGE + " after the session"]


def test_label_is_the_innermost_path(model):
    _, _, s = _profiled_run(model)
    for i, sp in enumerate(s.spans):
        if sp.name in ("route", "decode.inputs", "schedule") and sp.end > sp.start:
            assert s.label((sp.start + sp.end) // 2) == s.path(i)
    steps = s.find("step")
    for a, b in zip(steps, steps[1:]):
        if b.start - a.end > 1:
            assert s.label((a.end + b.start) // 2) is None
    assert s.label(steps[0].start - 1) is None and s.label(steps[-1].end + 1) is None
    assert s.label(steps[0].start) == "step"


def test_router_still_reached_through_the_module_global(model, monkeypatch):
    """The benchmark sees the router by replacing ``models.moe.route_replicated``
    (``decode_routes_unseen``): every MoE layer of every call still reaches
    it, traced or not."""
    cfg = model[0]
    seen = []
    route = MoE.route_replicated

    def watch(*a):
        seen.append(a[0].shape[0])
        return route(*a)

    monkeypatch.setattr(MoE, "route_replicated", watch)
    calls = []
    _drain(_engine(model), lambda eng: calls.append(bool(eng.core.running)))
    untraced = len(seen)
    assert untraced == (sum(calls) + len(PROMPTS)) * cfg.num_layers
    seen.clear()
    calls.clear()
    _, _, s = _profiled_run(model, lambda eng: calls.append(bool(eng.core.running)))
    assert len(seen) == untraced == len(s.find("route"))
    assert seen.count(MAX_SLOTS) == sum(calls) * cfg.num_layers


def _deepseek_backend():
    """A deepseek-v2 smoke backend on the slot layout, two prompts prefilled."""
    cfg = get_smoke_config("deepseek-v2-236b")
    be = TorchBackend(cfg, M.init_params(cfg, 0, device="cpu"), max_slots=MAX_SLOTS,
                      max_seq=MAX_SEQ, dispatch_mode="fused", device="cpu")
    rng = np.random.default_rng(5)
    active = []
    for i, n in enumerate((7, 19)):
        r = Request(req_id=i, prompt_len=n, max_new_tokens=8, arrival_time=0.0,
                    prompt_tokens=rng.integers(0, cfg.vocab_size, n))
        active.append((be.start(r, 0.0)[0], r))
    return be, active


def test_mla_decode_counters(model, monkeypatch):
    """Under the profiler a deepseek decode step counts every layer's MLA
    decode, all in latent space; a qwen3 run counts none; with no profiler
    neither counter is touched."""
    be, active = _deepseek_backend()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.poll()
        be.decode(active, 0.0)
    c = tracing.last().counters
    assert c["mla_decode_layers"] == c["mla_decode_latent"] == be.cfg.num_layers
    _, _, s = _profiled_run(model)
    assert s.find("decode") and s.counters["decode_rows"] > 0
    assert "mla_decode_layers" not in s.counters and "mla_decode_latent" not in s.counters
    counted = []
    monkeypatch.setattr(tracing.Session, "count",
                        lambda self, name, n: counted.append(name))
    before = tracing.last()
    be.decode(active, 0.1)
    assert counted == [] and tracing.last() is before and not tracing._on
