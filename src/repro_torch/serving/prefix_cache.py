"""Compatibility shim: PrefixCache lives in repro_torch.core.prefix_cache so
the backend-agnostic SchedulerCore (core/scheduler.py) can own prefix-cache
token accounting without importing the serving (torch) package."""
from repro_torch.core.prefix_cache import PrefixCache

__all__ = ["PrefixCache"]
