"""Fault tolerance of the port: health checks, elastic scaling and fault
drills over a ``Cluster``.  The reference's mesh context and sharding rules
(``distributed/context.py``, ``sharding.py``) are not ported yet."""
from repro_torch.distributed.drill import (DRILLS, Drill, DrillEvent,
                                           DrillRunner, run_drill)
from repro_torch.distributed.fault import (ElasticPolicy, HealthConfig,
                                           HealthMonitor)

__all__ = ["DRILLS", "Drill", "DrillEvent", "DrillRunner", "run_drill",
           "ElasticPolicy", "HealthConfig", "HealthMonitor"]
