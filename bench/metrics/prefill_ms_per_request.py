"""Backend ``start`` (serving/backend.py): ms of one request's prefill on
the host clock (the call ends in a copy to the host, so it holds the
device work), over the window's prefills."""


def read(run):
    steps = run.window_steps()
    n = sum(s.n_prefill for s in steps)
    return 1e3 * sum(s.prefill_s for s in steps) / n if n else None
