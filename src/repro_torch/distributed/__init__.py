"""Distribution of the port: the shard context and the model axis
(``context.py``), the sharding rules and the store (``sharding.py``), and
fault tolerance: health checks, elastic scaling and fault drills over a
``Cluster`` (``drill.py``, ``fault.py``).

The fault-tolerance names are imported on first use: the model layers
import ``context`` and ``sharding``, and the drills import the serving
and scheduling planes, which import the model layers."""
import importlib

_LAZY = {"DRILLS": "drill", "Drill": "drill", "DrillEvent": "drill", "DrillRunner": "drill",
         "run_drill": "drill", "ElasticPolicy": "fault", "HealthConfig": "fault",
         "HealthMonitor": "fault"}

__all__ = list(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
