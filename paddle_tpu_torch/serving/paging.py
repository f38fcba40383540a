"""Host-side bookkeeping for the block-paged KV cache: a refcounted
block allocator over a fixed physical pool, and a radix-style prefix
cache that lets requests sharing a token prefix share physical blocks.
(Own copy of paddle_tpu/serving/paging.py.)

- The device pool is `[num_blocks, nh, block_size, hd]` per layer;
  every logical sequence position `t` of a slot maps through its block
  table to physical row `(table[t // bs], t % bs)`. Block 0 is the
  reserved *null block*: it is never allocated, free slots point every
  table entry at it, and all padding/garbage scatter writes land there.
- `BlockAllocator` hands out blocks with a refcount. A block shared by
  N slots plus the prefix cache has refcount N+1 and returns to the free
  list only when the last reference drops.
- `PrefixCache` indexes *fully written* blocks by the cumulative hash of
  all tokens from position 0 (position-dependent KV means a chunk is
  only reusable under its exact left context). Lookup walks the hash
  chain block by block; a partial match inside the next block yields a
  copy-on-write candidate. Entries are evicted leaf-first in LRU order
  when the allocator runs dry (`reclaim`). An entry whose block the
  eviction frees is first handed to the optional `spill_hook` (the SSD
  spill tier, kvstore.py) while its rows still exist.

Fault site: ``serving.alloc_block`` fires on every physical block
allocation (a `raise` action is deterministic pool exhaustion mid-
admission).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..framework import faults

__all__ = ["NULL_BLOCK", "PoolExhausted", "BlockAllocator", "PrefixCache",
           "positions_to_rows"]

#: physical block 0 — reserved scratch target for padding writes
NULL_BLOCK = 0

_ROOT = b"\x00root"


def positions_to_rows(table, positions, block_size):
    """Map logical sequence positions to physical pool rows through a
    slot's block table: ``(table[t // bs], t % bs)`` — the routing the
    step's KV scatter uses."""
    positions = np.asarray(positions)
    table = np.asarray(table)
    return table[positions // block_size], positions % block_size


class PoolExhausted(RuntimeError):
    """No free physical blocks (after reclaim); admission must wait."""


class BlockAllocator:
    """Refcounted free-list allocator over `num_blocks` physical blocks.

    Block 0 (`NULL_BLOCK`) is reserved and never handed out; `usable`
    is therefore `num_blocks - 1`.
    """

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 physical blocks (1 reserved), got {num_blocks}")
        self.num_blocks = num_blocks
        self._ref = np.zeros((num_blocks,), np.int64)
        self._ref[NULL_BLOCK] = 1      # pinned forever
        # pop() yields ascending ids — deterministic tests
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def usable(self):
        return self.num_blocks - 1

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def blocks_in_use(self):
        return self.usable - len(self._free)

    def alloc(self):
        """One fresh block (refcount 1). Fault site serving.alloc_block."""
        faults.fault_point("serving.alloc_block")
        if not self._free:
            raise PoolExhausted(
                f"all {self.usable} usable KV blocks are referenced")
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def incref(self, bid):
        if bid == NULL_BLOCK or self._ref[bid] <= 0:
            raise ValueError(f"incref on unallocated block {bid}")
        self._ref[bid] += 1

    def decref(self, bid):
        """Drop one reference; returns True when the block was freed."""
        if bid == NULL_BLOCK or self._ref[bid] <= 0:
            raise ValueError(f"decref on unallocated block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
            return True
        return False

    def refcount(self, bid):
        return int(self._ref[bid])


class PrefixCache:
    """Radix prefix index over fully written KV blocks.

    Each entry maps `digest(tokens[0 : k*block_size])` -> the physical
    block holding positions `[(k-1)*bs, k*bs)`. The cache holds one
    allocator reference per entry, so indexed blocks survive slot
    eviction and are physically shared by later requests with the same
    prefix (`match` -> the caller increfs per consuming slot).
    """

    def __init__(self, allocator: BlockAllocator, block_size):
        self._alloc = allocator
        self.block_size = block_size
        self._blocks: dict = {}     # key -> block id
        self._chunks: dict = {}     # key -> np.int32 chunk tokens
        self._parent: dict = {}     # key -> parent key
        self._children: dict = {}   # key -> set of child keys
        self._lru: dict = {}        # key -> last-touch tick
        self._clock = 0
        #: optional spill donation: ``hook(key, prefix_tokens, bid,
        #: n_rows)`` called on eviction of an entry whose block is about
        #: to be freed, BEFORE the freeing decref (append-before-evict:
        #: the hook must copy the rows out before it returns, since the
        #: block is reused right after). The hook must not raise: a
        #: failed spill loses durability for that block, never the
        #: eviction itself.
        self.spill_hook = None

    def __len__(self):
        return len(self._blocks)

    @staticmethod
    def _digest(ids):
        return hashlib.sha1(
            np.ascontiguousarray(ids, np.int32).tobytes()).digest()

    def _touch(self, key):
        self._clock += 1
        self._lru[key] = self._clock

    def match(self, ids, limit):
        """Longest indexed prefix of ``ids[:limit]``.

        Returns ``(blocks, n_tokens, cow)``: the shared full blocks (in
        table order, NOT yet increfed — the caller increfs one ref per
        slot), the token count they cover, and an optional
        ``(src_block, n_rows)`` copy-on-write candidate when a cached
        block matches only the first `n_rows` of the next chunk."""
        bs = self.block_size
        blocks, n, parent = [], 0, _ROOT
        while n + bs <= limit:
            key = self._digest(ids[:n + bs])
            bid = self._blocks.get(key)
            if bid is None:
                break
            blocks.append(bid)
            parent = key
            n += bs
            self._touch(key)
        cow = None
        want = np.asarray(ids[n:limit], np.int32)
        if want.size:
            best_key, best_c = None, 0
            for child in self._children.get(parent, ()):
                chunk = self._chunks[child]
                m = min(chunk.size, want.size)
                neq = np.nonzero(chunk[:m] != want[:m])[0]
                c = int(neq[0]) if neq.size else m
                if c > best_c:
                    best_key, best_c = child, c
            if best_key is not None and best_c < bs:
                cow = (self._blocks[best_key], best_c)
                self._touch(best_key)
        return blocks, n, cow

    def insert(self, tokens, blocks, written):
        """Index every fully written block of a finished sequence.

        `tokens` is the full id sequence, `blocks` its physical block
        list (table order), `written` how many positions hold real KV.
        Newly indexed blocks gain one allocator reference (the cache's
        own); already-indexed prefixes are just LRU-refreshed. Returns
        #new entries."""
        bs = self.block_size
        tokens = np.asarray(tokens, np.int32)
        parent, added = _ROOT, 0
        for k in range(1, written // bs + 1):
            key = self._digest(tokens[:k * bs])
            if key not in self._blocks:
                bid = blocks[k - 1]
                self._alloc.incref(bid)
                self._blocks[key] = bid
                self._chunks[key] = tokens[(k - 1) * bs:k * bs].copy()
                self._parent[key] = parent
                self._children.setdefault(parent, set()).add(key)
                added += 1
            self._touch(key)
            parent = key
        return added

    def prefix_tokens(self, key):
        """The full cumulative token prefix an entry covers (root chunk
        through this entry's own chunk, concatenated in order)."""
        chunks = []
        while key != _ROOT:
            chunks.append(self._chunks[key])
            key = self._parent[key]
        return np.concatenate(chunks[::-1]) if chunks else \
            np.zeros((0,), np.int32)

    def _evict(self, key):
        bid = self._blocks[key]
        if self.spill_hook is not None \
                and self._alloc.refcount(bid) == 1:
            # append-before-evict: persist the rows while the block
            # still exists — the decref below frees it for reuse
            self.spill_hook(key, self.prefix_tokens(key), bid,
                            len(self._chunks[key]))
        self._children.get(self._parent[key], set()).discard(key)
        self._children.pop(key, None)
        bid = self._blocks.pop(key)
        self._chunks.pop(key)
        self._parent.pop(key)
        self._lru.pop(key)
        return self._alloc.decref(bid)

    def reclaim(self, n_blocks):
        """Evict LRU leaf entries until `n_blocks` physical blocks were
        actually freed. Returns #freed."""
        freed = 0
        while freed < n_blocks:
            leaves = [k for k in self._blocks
                      if not self._children.get(k)]
            if not leaves:
                break
            freeing = [k for k in leaves
                       if self._alloc.refcount(self._blocks[k]) == 1]
            if not freeing:
                break
            victim = min(freeing, key=lambda k: self._lru[k])
            if self._evict(victim):
                freed += 1
        return freed

    def clear(self):
        """Drop every entry (and its allocator reference). Leaves go
        before parents so the spill hook can still resolve each
        entry's full token prefix through a live parent chain."""
        while self._blocks:
            for key in [k for k in self._blocks
                        if not self._children.get(k)]:
                self._evict(key)
