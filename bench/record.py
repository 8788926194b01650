"""What a run leaves for the per-layer metric readers (``bench/metrics``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from bench.serve import Step
from bench.stats import Req
from bench.trace import Summary


@dataclasses.dataclass
class Run:
    config: dict
    traffic: dict
    t_open: float
    t_close: float
    steps: List[Step]
    reqs: Dict[int, Req]
    trace: Optional[Summary] = None
    bounds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def window_steps(self) -> List[Step]:
        """The steps inside the window, less the profiled ones (the host
        timers are read with the profiler off)."""
        return [s for s in self.steps
                if s.t0 >= self.t_open and s.t1 <= self.t_close and not s.profiled]
