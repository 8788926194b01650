"""The readers of the program's own spans and counters
(``repro_torch.tracing``) on a hand-built session: each one's arithmetic,
and None where the run kept no device trace or the program no session."""
import types

import pytest

from bench import spec

NAMES = ("host_syncs_per_decode_step", "decode_layer_ms", "decode_live_row_share")


def _session():
    """Two steps: the first a prefill and a decode of 3 live rows of 4, the
    second a decode of 4 of 4; each decode two layers, of 1.0 + 2.0 ms and
    3.0 + 4.0 ms."""
    from repro_torch import tracing
    s = tracing.Session()
    ms = 1_000_000

    def add(name, start, end, parent=-1):
        sp = tracing.Span(s, name)
        sp.start, sp.end, sp.parent, sp._session = start, end, parent, None
        s.spans.append(sp)
        return len(s.spans) - 1

    step = add("step", 0, 100 * ms)
    prefill = add("prefill", 1 * ms, 20 * ms, step)
    dec = add("decode", 30 * ms, 40 * ms, step)
    model = add("decode.model", 30 * ms, 38 * ms, dec)
    first = add("layer", 30 * ms, 31 * ms, model)
    add("layer", 31 * ms, 33 * ms, model)
    readback = add("decode.readback", 38 * ms, 40 * ms, dec)
    step2 = add("step", 200 * ms, 300 * ms)
    dec2 = add("decode", 210 * ms, 230 * ms, step2)
    model2 = add("decode.model", 210 * ms, 220 * ms, dec2)
    add("layer", 210 * ms, 213 * ms, model2)
    second = add("layer", 213 * ms, 217 * ms, model2)
    # syncs: 3 in a layer, 1 in the first readback, 1 in the second decode
    # itself, 2 in the prefill and 2 in the step outside both, 5 outside any span
    s.syncs = {first: 3, readback: 1, dec2: 1, prefill: 2, step: 2, -1: 5, second: 0}
    s.counters = {"decode_rows_live": 7, "decode_rows": 8}
    s._warnings = None
    return s


def _read(name, run):
    return spec.metric_reader(name)(run)


@pytest.fixture
def session(monkeypatch):
    from repro_torch import tracing
    s = _session()
    monkeypatch.setattr(tracing, "last", lambda: s)
    return s


def test_each_reader_on_a_hand_built_session(session):
    run = types.SimpleNamespace(trace=object())
    assert _read("host_syncs_per_decode_step", run) == (3 + 1 + 1) / 2
    assert _read("decode_layer_ms", run) == pytest.approx((1 + 2 + 3 + 4) / 4)
    assert _read("decode_live_row_share", run) == 100.0 * 7 / 8
    for name in NAMES:
        assert _read(name + ".closed", run) == _read(name, run)


def test_none_without_a_device_trace(session):
    for name in NAMES:
        assert _read(name, types.SimpleNamespace(trace=None)) is None


def test_none_without_a_session_or_its_spans(monkeypatch):
    from repro_torch import tracing
    run = types.SimpleNamespace(trace=object())
    monkeypatch.setattr(tracing, "last", lambda: None)
    for name in NAMES:
        assert _read(name, run) is None
    s = _session()
    s.spans, s.counters = [], {}
    monkeypatch.setattr(tracing, "last", lambda: s)
    for name in NAMES:
        assert _read(name, run) is None
    # a session of prefills alone: no decode span, no decode row
    s = _session()
    s.spans = s.spans[:2]
    s.counters = {}
    assert _read("decode_live_row_share", run) is None
    assert _read("host_syncs_per_decode_step", run) is None
    assert _read("decode_layer_ms", run) is None


def test_a_program_without_tracing_reads_none(monkeypatch):
    """The parent of this change has no ``repro_torch.tracing``: the readers
    return None there and raise nothing."""
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    run = types.SimpleNamespace(trace=object())
    for name in NAMES:
        assert _read(name, run) is None
