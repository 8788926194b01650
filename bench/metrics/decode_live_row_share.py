"""Backend (program counters, ``serving/backend.py``): the share of the
rows a decode step computes that hold a live request, 100 ×
``decode_rows_live`` ÷ ``decode_rows`` over the traced sub-window, in %
(every step computes all ``max_slots`` rows).  None without a device trace
or a tracing session."""


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.tracing import last
    except ImportError:
        return None
    s = last()
    rows = s.counters.get("decode_rows", 0) if s is not None else 0
    return 100.0 * s.counters.get("decode_rows_live", 0) / rows if rows else None
