"""Expert level (core/gimbal.py, core/eplb.py, core/placement.py): host ms
of the level's ``observe`` and ``tick`` and of the weight relocations it
orders, per step in the window."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    return 1e3 * sum(s.expert_s for s in steps) / len(steps)
