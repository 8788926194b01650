"""Serving of the port: the KV caches, ``TorchBackend``, ``Engine`` and the
``Cluster`` of engines with its metrics bus."""
from repro_torch.serving.engine import Engine
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.kvcache import (BlockLedger, PagedKVCache, SlotKVCache,
                                         write_slot)
from repro_torch.serving.metrics import LatencyReport, MetricsBus, summarize
from repro_torch.serving.prefix_cache import PrefixCache

__all__ = ["Engine", "Cluster", "BlockLedger", "PagedKVCache", "SlotKVCache",
           "write_slot", "LatencyReport", "MetricsBus", "summarize",
           "PrefixCache"]
