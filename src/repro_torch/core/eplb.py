"""Port of ``repro.core.eplb``, first part: the ``NullExpertLevel``.

The Algorithm 3 loop (``ExpertRebalancer``, ``ClusterExpertLevel``) and
the placement solvers it calls are the next slice of the port (ROADMAP.md,
Queue 1).  Until then an engine of the port runs with no expert level or
with this stand-in, which manages no placement.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class NullExpertLevel:
    """Expert level that manages no placement: unit coupling factors, empty
    event stream — so callers never branch on arch."""

    moe_mult = 1.0
    cross_frac = 0.0
    slot_map = None
    perm = None
    factor_trail: List[Tuple[int, float]] = []

    def __init__(self):
        self.events: list = []

    def observe(self, expert_ids) -> None:
        pass

    def tick(self) -> Optional[np.ndarray]:
        return None

    @property
    def migrations(self) -> int:
        return 0

    @property
    def bytes_moved(self) -> int:
        return 0
