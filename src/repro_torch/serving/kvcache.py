"""KV-cache management of the port, ported from ``repro.serving.kvcache``.

Three layers:
  * ``SlotKVCache`` — fixed decode slots: batch row i of every leaf of
    ``models.model.init_cache`` (an attention stack's (L, B, S, Hkv, D)
    K/V, an SSM's per-layer state and conv window, a hybrid's both) with
    per-slot occupancy.  ``usage()`` is the KV-usage signal Alg. 1 reads;
    for an arch without attention layers it is state-slot occupancy.
  * ``PagedKVCache`` — vLLM-style paged device cache: a global pool of
    ``block_size``-token pages, per-slot block tables, refcounted
    copy-on-write prefix sharing keyed by ``core.prefix_cache.block_hashes``,
    and optional int8 page storage with per-(layer, page) scales.
  * ``BlockLedger`` — host-side block accounting.

The device tensors are updated IN PLACE (slice assignment and the decode
step's writes), where the reference rebuilt whole arrays; block tables,
refcounts, lengths and free lists stay in numpy on the host.
"""
from __future__ import annotations

import heapq
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as devlib
from repro_torch.core.prefix_cache import block_hashes
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training.compression import quantize_int8

_SKIP = -1  # write_slot axis sentinel: leaf has no batch axis, leave untouched


def _tree_map(fn, *trees):
    """Map ``fn`` over the leaves of same-structured trees.  Dicts and lists
    (a prologue's per-layer caches) are nodes; anything else, a shape tuple
    of ``models.model.cache_shapes`` included, is a leaf."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_tree_map(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def batch_axes(model_cfg: ModelConfig, max_slots: int, max_seq: int) -> Any:
    """Per-leaf batch-axis tree for a batched model cache, found structurally:
    the unique axis whose size differs between a batch=``max_slots`` and a
    batch=1 cache (from ``models.model.cache_shapes``: nothing is
    allocated).  Leaves whose shape does not depend on batch get the
    sentinel ``-1`` (skipped by ``write_slot``); ambiguous leaves raise."""
    if max_slots <= 1:
        raise ValueError("batch-axis discovery requires max_slots > 1")
    big = M.cache_shapes(model_cfg, max_slots, max_seq)
    one = M.cache_shapes(model_cfg, 1, max_seq)

    def find(b, s):
        diff = [i for i, (x, y) in enumerate(zip(b, s)) if x != y]
        if not diff:
            return _SKIP
        if len(diff) > 1:
            raise ValueError(f"ambiguous batch axis for cache leaf {b} vs {s}")
        return diff[0]

    return _tree_map(find, big, one)


def write_slot(cache, slot_cache, slot: int, axes) -> Any:
    """Insert a batch=1 sub-cache into batch slot ``slot`` of the batched
    cache, IN PLACE, at offset 0 along every other axis (the reference's
    ``dynamic_update_slice``).  ``axes`` names the batch axis: one int for
    every leaf, or a tree matching ``cache`` (``batch_axes``; ``-1`` skips a
    leaf).  Returns ``cache``."""
    ax_tree = _tree_map(lambda _: axes, cache) if isinstance(axes, int) else axes

    def upd(c, s, ax):
        if ax == _SKIP:
            return c
        idx = [slice(0, n) for n in s.shape]
        idx[ax] = slice(slot, slot + 1)
        c[tuple(idx)] = s.to(c.dtype)
        return c

    return _tree_map(upd, cache, slot_cache, ax_tree)


class SlotKVCache:
    """Fixed-slot device KV cache: slot i is batch row i of one contiguous
    cache; a free min-heap hands out the lowest free slot."""

    def __init__(self, model_cfg: ModelConfig, max_slots: int, max_seq: int,
                 dtype=None, device=None):
        if max_slots <= 1:
            raise ValueError("slot cache requires max_slots > 1")
        self.device = devlib.resolve(device)
        self.model_cfg = model_cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.cache = M.init_cache(model_cfg, max_slots, max_seq, dtype,
                                  device=self.device)
        self.write_axes = batch_axes(model_cfg, max_slots, max_seq)
        self.slot_len = np.zeros(max_slots, np.int64)     # tokens resident per slot
        self._free_heap: List[int] = list(range(max_slots))  # sorted => valid heap
        self._is_free = [True] * max_slots

    # --- allocation -------------------------------------------------------------
    def alloc(self) -> Optional[int]:
        """Lowest free slot index, via a min-heap free list."""
        if not self._free_heap:
            return None
        i = heapq.heappop(self._free_heap)
        self._is_free[i] = False
        self.slot_len[i] = 0
        return i

    def free(self, slot: int) -> None:
        if not self._is_free[slot]:
            self._is_free[slot] = True
            heapq.heappush(self._free_heap, slot)
        self.slot_len[slot] = 0

    @property
    def num_free(self) -> int:
        return len(self._free_heap)

    # --- metrics (Alg. 1 signal) --------------------------------------------------
    def usage(self) -> float:
        """Fraction of KV capacity in use: resident tokens / token capacity
        (occupied slots / slots for an arch without attention layers)."""
        if self.model_cfg.num_attention_layers() == 0:
            return 1.0 - self.num_free / self.max_slots
        return float(self.slot_len.sum()) / (self.max_slots * self.max_seq)

    def kv_bytes_used(self) -> int:
        return int(self.slot_len.sum()) * self.model_cfg.kv_bytes_per_token()

    def positions(self) -> torch.Tensor:
        return torch.as_tensor(np.minimum(self.slot_len, self.max_seq - 1),
                               dtype=torch.int32, device=self.device)


class PagedKVCache:
    """Paged device KV cache for homogeneous GQA attention stacks.

    Layout: per-layer K/V pages of shape (L, P, BS, Hkv, D) where P is the
    global pool size and BS the block size.  Physical page 0 is a reserved
    garbage page: free/inactive slots' block-table rows point at it, so the
    full-batch decode scatter lands harmlessly there.  Full prompt blocks are
    refcounted and shared across slots keyed by the same chained block hashes
    the prefix cache uses (causal attention => identical prefixes produce
    identical K/V pages); a prefix hit pins the resident pages instead of
    re-writing them.  Optional int8 storage keeps a per-(layer, page) scale,
    quantized with training/compression.py::quantize_int8.
    """

    def __init__(self, model_cfg: ModelConfig, max_slots: int, max_seq: int,
                 *, block_size: int = 16, total_blocks: Optional[int] = None,
                 dtype=None, quantize: bool = False, device=None):
        cfg = model_cfg
        M.check_paged(cfg)
        if max_slots <= 1 or block_size <= 0:
            raise ValueError("PagedKVCache needs max_slots > 1 and block_size > 0")
        self.device = devlib.resolve(device)
        self.model_cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.quantized = quantize
        self.max_blocks = -(-max_seq // block_size)
        self.usable_blocks = total_blocks or max_slots * self.max_blocks
        if self.usable_blocks < max_slots * self.max_blocks:
            raise ValueError("pool must cover max_slots full-length sequences "
                             "(admission is gated upstream by SchedulerCore "
                             "block accounting)")
        n_pages = self.usable_blocks + 1                      # + garbage page 0
        L = cfg.num_layers
        hkv, d = cfg.num_kv_heads, cfg.head_dim
        store = torch.int8 if quantize else (dtype or cfg.adtype)
        shape = (L, n_pages, block_size, hkv, d)
        self.pages: Dict[str, torch.Tensor] = {
            "k": torch.zeros(shape, dtype=store, device=self.device),
            "v": torch.zeros(shape, dtype=store, device=self.device),
        }
        if quantize:
            for name in ("k_scale", "v_scale"):
                self.pages[name] = torch.zeros((L, n_pages), dtype=torch.float32,
                                               device=self.device)

        self.block_tables = np.zeros((max_slots, self.max_blocks), np.int32)
        self.slot_len = np.zeros(max_slots, np.int64)
        self._free_slots: List[int] = list(range(max_slots))
        self._is_free = [True] * max_slots
        self._free_blocks: List[int] = list(range(1, n_pages))
        self._ref = np.zeros(n_pages, np.int32)
        self._block_hash: Dict[int, int] = {}   # page -> chained block hash
        self._hash_block: Dict[int, int] = {}   # chained block hash -> page
        self._slot_nblocks = np.zeros(max_slots, np.int32)
        self._slot_shared = np.zeros(max_slots, np.int32)
        # counters for tests / metrics
        self.shared_hits = 0

    # --- pool geometry ----------------------------------------------------------
    @property
    def capacity_tokens(self) -> int:
        return self.usable_blocks * self.block_size

    @property
    def blocks_used(self) -> int:
        return self.usable_blocks - len(self._free_blocks)

    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    # --- metrics (Alg. 1 signal) --------------------------------------------------
    def usage(self) -> float:
        """True block occupancy: distinct pages held / pool size.  Shared
        pages count once."""
        return self.blocks_used / max(self.usable_blocks, 1)

    def kv_bytes_used(self) -> int:
        """The bytes of the pages held, every layer's K and V (and an int8
        pool's per-page scales)."""
        per_block = sum(math.prod(p.shape[2:]) * p.element_size() * p.shape[0]
                        for n, p in self.pages.items() if not n.endswith("_scale"))
        scale_b = sum(4 * p.shape[0] for n, p in self.pages.items() if n.endswith("_scale"))
        return self.blocks_used * (per_block + scale_b)

    # --- allocation -------------------------------------------------------------
    def alloc(self, plen: int,
              tokens: Optional[Sequence[int]] = None) -> Optional[int]:
        """Allocate a slot plus pages for a `plen`-token prompt.  When `tokens`
        (Python ints: ``block_hashes`` hashes tuples, and a tensor hashes by
        identity) is given, leading full blocks already resident are pinned
        (refcount++) instead of allocated; ``write_prefill`` skips them."""
        if not self._free_slots:
            return None
        n_total = -(-plen // self.block_size)
        hashes = block_hashes(tokens[:plen], self.block_size) \
            if tokens is not None else []
        n_shared = 0
        for h in hashes:
            if h in self._hash_block:
                n_shared += 1
            else:
                break
        if n_total - n_shared > len(self._free_blocks):
            return None
        slot = heapq.heappop(self._free_slots)
        self._is_free[slot] = False
        self.block_tables[slot, :] = 0
        for i in range(n_total):
            if i < n_shared:
                blk = self._hash_block[hashes[i]]
                self._ref[blk] += 1
                self.shared_hits += 1
            else:
                blk = heapq.heappop(self._free_blocks)
                self._ref[blk] = 1
                if i < len(hashes) and hashes[i] not in self._hash_block:
                    self._hash_block[hashes[i]] = blk
                    self._block_hash[blk] = hashes[i]
            self.block_tables[slot, i] = blk
        self._slot_nblocks[slot] = n_total
        self._slot_shared[slot] = n_shared
        self.slot_len[slot] = 0
        return slot

    def _deref(self, blk: int) -> None:
        self._ref[blk] -= 1
        if self._ref[blk] == 0:
            h = self._block_hash.pop(blk, None)
            if h is not None and self._hash_block.get(h) == blk:
                del self._hash_block[h]
            heapq.heappush(self._free_blocks, blk)

    def free(self, slot: int) -> None:
        if self._is_free[slot]:
            return
        for i in range(int(self._slot_nblocks[slot])):
            self._deref(int(self.block_tables[slot, i]))
        self.block_tables[slot, :] = 0
        self._slot_nblocks[slot] = 0
        self._slot_shared[slot] = 0
        self.slot_len[slot] = 0
        self._is_free[slot] = True
        heapq.heappush(self._free_slots, slot)

    # --- device writes ----------------------------------------------------------
    def _quant(self, blocks: torch.Tensor):
        """Per-(layer, page) int8 quantization via vmapped quantize_int8."""
        L, m = blocks.shape[:2]
        q, scale = torch.vmap(quantize_int8)(blocks.reshape(L * m, -1))
        return q.reshape(blocks.shape), scale.reshape(L, m)

    def write_prefill(self, slot: int, slot_cache) -> None:
        """Copy a batch=1 prefill cache ({"layers": {"k": (L,1,S,Hkv,D)}})
        into this slot's non-shared pages.  Shared (prefix-hit) pages were
        pinned by `alloc` and are NOT re-written — that is the point."""
        bs = self.block_size
        start = int(self._slot_shared[slot])
        n = int(self._slot_nblocks[slot])
        if n == start:
            return
        phys = torch.as_tensor(self.block_tables[slot, start:n].astype(np.int64),
                               device=self.device)
        for name in ("k", "v"):
            src = slot_cache["layers"][name]                 # (L, 1, S, Hkv, D)
            need = n * bs
            if src.shape[2] < need:
                src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, need - src.shape[2]))
            L = src.shape[0]
            blocks = src[:, 0, start * bs:n * bs].reshape(
                L, n - start, bs, src.shape[3], src.shape[4])
            if self.quantized:
                q, scale = self._quant(blocks)
                self.pages[name][:, phys] = q
                self.pages[name + "_scale"][:, phys] = scale
            else:
                self.pages[name][:, phys] = blocks.to(self.pages[name].dtype)

    def prepare_append(self, slot: int) -> None:
        """Make the page holding position `slot_len` writable before a decode
        step: allocate a fresh private page at a block boundary, and
        copy-on-write if the target page is shared (refcount > 1)."""
        pos = min(int(self.slot_len[slot]), self.max_seq - 1)
        bidx = pos // self.block_size
        n = int(self._slot_nblocks[slot])
        if bidx >= n:
            if bidx != n:
                raise RuntimeError("append skipped a block")
            if not self._free_blocks:
                raise RuntimeError("paged pool exhausted (admission bug)")
            blk = heapq.heappop(self._free_blocks)
            self._ref[blk] = 1
            self.block_tables[slot, bidx] = blk
            self._slot_nblocks[slot] = n + 1
            return
        blk = int(self.block_tables[slot, bidx])
        if self._ref[blk] > 1:                               # copy-on-write
            if not self._free_blocks:
                raise RuntimeError("paged pool exhausted (admission bug)")
            nb = heapq.heappop(self._free_blocks)
            self._ref[nb] = 1
            for t in self.pages.values():
                t[:, nb] = t[:, blk]
            self._deref(blk)
            self.block_tables[slot, bidx] = nb
            if bidx < self._slot_shared[slot]:
                self._slot_shared[slot] = bidx

    # --- device-side views ------------------------------------------------------
    def device_tables(self) -> torch.Tensor:
        return torch.as_tensor(self.block_tables, dtype=torch.int32, device=self.device)

    def positions(self) -> torch.Tensor:
        return torch.as_tensor(np.minimum(self.slot_len, self.max_seq - 1),
                               dtype=torch.int32, device=self.device)


class BlockLedger:
    """vLLM-style block accounting: seq -> blocks of ``block_size`` tokens."""

    def __init__(self, total_blocks: int, block_size: int = 16):
        self.total_blocks = total_blocks
        self.block_size = block_size
        self.used_blocks = 0
        self.seq_blocks: Dict[int, int] = {}

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def can_alloc(self, tokens: int) -> bool:
        return self.used_blocks + self.blocks_for(tokens) <= self.total_blocks

    def alloc(self, seq_id: int, tokens: int) -> bool:
        need = self.blocks_for(tokens)
        if self.used_blocks + need > self.total_blocks:
            return False
        self.seq_blocks[seq_id] = need
        self.used_blocks += need
        return True

    def extend(self, seq_id: int, new_total_tokens: int) -> bool:
        """Grow a sequence to ``new_total_tokens``; returns False on OOM."""
        have = self.seq_blocks.get(seq_id, 0)
        need = self.blocks_for(new_total_tokens)
        if need <= have:
            return True
        if self.used_blocks + (need - have) > self.total_blocks:
            return False
        self.used_blocks += need - have
        self.seq_blocks[seq_id] = need
        return True

    def release(self, seq_id: int) -> None:
        self.used_blocks -= self.seq_blocks.pop(seq_id, 0)

    @property
    def usage(self) -> float:
        return self.used_blocks / max(self.total_blocks, 1)
