"""Backend ``decode`` (serving/backend.py): ms of one decode step of every
row on the host clock (it ends in ``.cpu()``), over the window's steps."""


def read(run):
    steps = run.window_steps()
    n = sum(s.n_decode for s in steps)
    return 1e3 * sum(s.decode_s for s in steps) / n if n else None
