"""Model (models/model.py, attention.py, moe.py, blocks.py): the needed
operations of the window's prefills and decode steps
(``roofline/model_flops.py``) over the wall time of those ``Engine.step``
calls at the card's published bf16 peak, in %."""
from bench.roofline.peaks import PEAK_FLOPS


def read(run):
    steps = run.window_steps()
    wall = sum(s.t1 - s.t0 for s in steps)
    if not wall:
        return None
    return 100.0 * sum(s.flops for s in steps) / (wall * PEAK_FLOPS["bfloat16"])
