"""Cluster-wide prefix directory: which engine holds which cached blocks.

The engine-level dispatch layer (paper §IV-B) scores candidate engines by the
longest prefix of the incoming prompt they already hold in their local
``PrefixCache``.  A per-engine cache only answers "do *I* hold this block";
the ``PrefixDirectory`` is the fleet-level view the router consults — a
per-engine set of resident block hashes kept consistent with the real caches
by subscription, not by polling:

* ``attach(engine_id, cache)`` hooks the cache's ``on_insert``/``on_evict``
  callbacks, so every block that lands in or falls out of an engine's cache
  (LRU eviction, ``clear()`` on failure) updates the directory immediately.
* ``purge_engine`` drops an engine's whole entry — engine failure loses the
  node's memory, so its advertised prefixes must vanish before the next
  dispatch (orphans must not chase a dead engine's stale prefix).
* A hedged move needs no special case: re-submitting the request on the
  target engine inserts its blocks into the target's cache, which advertises
  them here before the next ``submit`` consults the directory.

Block identity is the chained hash of ``core/prefix_cache.py`` — equal hash
implies equal whole prefix — so ``longest_prefix`` can count the leading
matched run per engine exactly like a local cache probe would.

Lookups use an inverted index (block hash -> holder engine set) alongside the
per-engine sets: ``longest_prefix`` walks the prompt's blocks once and
intersects holder sets, so its cost scales with the number of engines still
matching — not with fleet size.  At 1000 engines a dispatch probe touches a
handful of sets instead of scanning every engine's whole holding.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Set, Tuple

from repro_torch.core.prefix_cache import PrefixCache, block_hashes


class PrefixDirectory:
    def __init__(self, block_size: int = 16):
        self.block_size = block_size
        self._held: Dict[int, Set[int]] = {}
        # inverted index: block hash -> engines advertising it.  Kept exactly
        # in lockstep with _held by _add/_discard (the ONLY mutation paths).
        self._index: Dict[int, Set[int]] = {}

    # --- the two mutation paths (keep _held and _index consistent) ----------

    def _add(self, engine_id: int, h: int) -> None:
        self._held.setdefault(engine_id, set()).add(h)
        self._index.setdefault(h, set()).add(engine_id)

    def _discard(self, engine_id: int, h: int) -> None:
        self._held.get(engine_id, set()).discard(h)
        holders = self._index.get(h)
        if holders is not None:
            holders.discard(engine_id)
            if not holders:
                del self._index[h]

    # --- feeding the directory ---------------------------------------------

    def attach(self, engine_id: int, cache: PrefixCache) -> None:
        """Subscribe to an engine's PrefixCache so inserts/evictions flow in.

        The cache must hash with the directory's block size — otherwise the
        two planes would disagree on block identity."""
        if cache.block_size != self.block_size:
            raise ValueError(
                f"engine {engine_id} cache block_size {cache.block_size} != "
                f"directory block_size {self.block_size}")
        self._held.setdefault(engine_id, set())
        cache.on_insert = lambda h, e=engine_id: self._add(e, h)
        cache.on_evict = lambda h, e=engine_id: self._discard(e, h)

    def record(self, engine_id: int, tokens: Sequence[int]) -> None:
        """Directly advertise a prompt's blocks for an engine (tests and
        cache-less planes; attached engines feed automatically)."""
        for h in block_hashes(tokens, self.block_size):
            self._add(engine_id, h)

    # --- invalidation -------------------------------------------------------

    def purge_engine(self, engine_id: int) -> None:
        """Engine failure: all its advertised prefixes are gone."""
        held = self._held.get(engine_id)
        if held is not None:
            for h in list(held):
                self._discard(engine_id, h)

    # --- queries ------------------------------------------------------------

    def blocks_held(self, engine_id: int) -> int:
        return len(self._held.get(engine_id, ()))

    def longest_prefix(self, tokens: Sequence[int]) -> Dict[int, int]:
        """Tokens of ``tokens``'s leading run each engine holds (prefix
        property: the count stops at an engine's first missing block).
        Engines holding nothing are omitted.

        One pass over the prompt's blocks against the inverted index: the
        surviving-intersection set is exactly the engines whose match run
        reaches the current block, so an engine's count freezes the moment it
        drops out — identical to probing every engine's cache directly."""
        out: Dict[int, int] = {}
        alive: Optional[Set[int]] = None
        for h in block_hashes(tokens, self.block_size):
            holders = self._index.get(h, ())
            alive = (set(holders) if alive is None
                     else {e for e in alive if e in holders})
            if not alive:
                break
            for e in alive:
                out[e] = out.get(e, 0) + self.block_size
        return out

    def best_engine(self, tokens: Sequence[int]) -> Optional[Tuple[int, int]]:
        """(engine_id, matched_tokens) for the longest held prefix, lowest
        engine id on ties; None when no engine holds any block."""
        held = self.longest_prefix(tokens)
        if not held:
            return None
        best = min(held, key=lambda e: (-held[e], e))
        return best, held[best]
