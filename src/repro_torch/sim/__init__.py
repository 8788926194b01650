"""Simulator plane of the port, ported from ``repro.sim``: the analytic
cost model (``costmodel``), the cost-model backend behind the same
``SchedulerCore`` the live engine runs (``backend``), and the discrete-event
cluster simulator (``simulator``).  Host-only numpy: nothing here touches a
device, and ``simulate()`` returns the reference's ``SimResult`` for the
same trace, variant and hardware profile."""
from repro_torch.sim.backend import CostModelBackend
from repro_torch.sim.costmodel import (A100, PROFILES, V5E, CostModel,
                                       HardwareProfile)
from repro_torch.sim.simulator import SimEngine, SimResult, simulate

__all__ = ["CostModelBackend", "A100", "PROFILES", "V5E", "CostModel",
           "HardwareProfile", "SimEngine", "SimResult", "simulate"]
