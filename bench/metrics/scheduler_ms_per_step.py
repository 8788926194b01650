"""Request scheduler: host ms an ``Engine.step`` spends outside the backend's
``start`` / ``decode`` and the expert level, per step in the window."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    own = sum(s.t1 - s.t0 - s.prefill_s - s.decode_s - s.expert_s for s in steps)
    return 1e3 * own / len(steps)
