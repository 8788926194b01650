"""Port copy of ``repro.core.prefix_cache``: host-side Python with no framework in it,
kept line for line so both packages make byte-identical decisions.

Prefix cache with chained block hashing (vLLM/SGLang-style).

Token blocks are hashed as hash(parent_hash, block_tokens); a per-engine table
maps block hash -> last-use time.  `match` returns how many leading blocks of
a prompt are already resident (a hit), `insert` adds the prompt's blocks.

This powers the paper's Fig. 11 (total hit count) and Fig. 12 (global hit
rate = hit blocks / probed blocks) reproduction: user-affinity routing sends a
user's next request to the engine whose table already holds their prefix.
"""
from __future__ import annotations

import collections
from typing import Callable, List, Optional, Sequence


def block_hashes(tokens: Sequence[int], block_size: int = 16) -> List[int]:
    """Chained hashes of the full leading blocks of ``tokens``: block b's hash
    folds in block b-1's, so equal hashes imply equal whole prefixes.  Shared
    by the per-engine ``PrefixCache`` and the cluster-wide
    ``PrefixDirectory`` (core/prefix_directory.py) so both speak the same
    block identity."""
    hashes = []
    parent = 0
    n_full = len(tokens) // block_size
    for b in range(n_full):
        blk = tuple(tokens[b * block_size:(b + 1) * block_size])
        parent = hash((parent, blk))
        hashes.append(parent)
    return hashes


class PrefixCache:
    def __init__(self, block_size: int = 16, capacity_blocks: int = 65536):
        self.block_size = block_size
        self.capacity = capacity_blocks
        self._table: "collections.OrderedDict[int, float]" = collections.OrderedDict()
        # global counters (paper §V-A.5 metrics)
        self.hit_blocks = 0
        self.probed_blocks = 0
        # content listeners (the cluster-wide PrefixDirectory subscribes):
        # fired with the block hash when a NEW block lands / a block leaves
        self.on_insert: Optional[Callable[[int], None]] = None
        self.on_evict: Optional[Callable[[int], None]] = None

    def _block_hashes(self, tokens: Sequence[int]) -> List[int]:
        return block_hashes(tokens, self.block_size)

    def match(self, tokens: Sequence[int], now: float = 0.0) -> int:
        """Number of leading tokens already cached (block-granular).

        Counters follow the paper's §V-A.5 definitions: `probed_blocks` counts
        EVERY block of the prompt (the denominator of the global hit rate);
        `hit_blocks` counts only the leading matched run (prefix property —
        reuse stops at the first non-resident block, as in vLLM)."""
        hashes = self._block_hashes(tokens)
        self.probed_blocks += len(hashes)
        matched = 0
        for h in hashes:
            if h in self._table:
                self._table.move_to_end(h)
                self._table[h] = now
                self.hit_blocks += 1
                matched += 1
            else:
                break  # prefix property: stop at first miss
        return matched * self.block_size

    def insert(self, tokens: Sequence[int], now: float = 0.0) -> None:
        for h in self._block_hashes(tokens):
            if h in self._table:
                self._table.move_to_end(h)
                self._table[h] = now
                continue
            self._table[h] = now
            if self.on_insert is not None:
                self.on_insert(h)
            while len(self._table) > self.capacity:
                ev, _ = self._table.popitem(last=False)  # LRU eviction
                if self.on_evict is not None:
                    self.on_evict(ev)

    def clear(self) -> None:
        """Drop every resident block (engine failure: node memory is gone).
        Fires ``on_evict`` per block so any subscribed directory stays
        consistent by construction; counters are kept (they are cluster-wide
        telemetry, not node state)."""
        while self._table:
            ev, _ = self._table.popitem(last=False)
            if self.on_evict is not None:
                self.on_evict(ev)

    def __len__(self) -> int:
        return len(self._table)

    @property
    def hit_rate(self) -> float:
        return self.hit_blocks / max(self.probed_blocks, 1)

    def reset_counters(self) -> None:
        self.hit_blocks = 0
        self.probed_blocks = 0
