"""Host-side block-table allocator for the paged KV cache.

The engine's device state holds one global pool of KV blocks per layer
(`models/api.py: init_paged_cache`); this class owns the *mapping* —
which pool block backs which logical position of which slot — as plain
numpy, mirrored to the device as the ``[slots, blocks_per_slot]`` int32
table the decode step and the paged attention kernel index through.

Block-id space (``num_blocks`` total):

- **private**: ids ``[s * nblk, (s+1) * nblk)`` are permanently owned by
  slot ``s`` — a slot can always be admitted without allocation, and a
  retired slot's table resets to its private row so stale table entries
  can never read (or pin) shared state.
- **shared**: ids ``[slots * nblk, slots * nblk + extra)`` form a free
  list used to seed full prefix blocks once per template; admissions
  alias them by table reference.  Refcounted: the prefix cache holds one
  reference while its entry lives, each aliasing slot holds one more; a
  block returns to the free list at zero.
- **trash**: the last id.  Admission scatter writes *every* chunk of a
  row's prefill KV somewhere; chunks covered by aliased prefix blocks
  are pointed at the trash block, which no table ever references.

Partial tail blocks of a prefix are never shared — only ``plen // bs``
full blocks — so the boundary block is written privately from the row's
own (complete) prefill state and per-row suffix tokens never touch
shared storage.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class BlockTableAllocator:
    def __init__(self, slots: int, blocks_per_slot: int, *,
                 extra_blocks: Optional[int] = None):
        nblk = int(blocks_per_slot)
        self.slots = int(slots)
        self.nblk = nblk
        self.extra = int(2 * nblk if extra_blocks is None else extra_blocks)
        self.num_blocks = self.slots * nblk + self.extra + 1
        self.trash = self.num_blocks - 1
        self.tables = np.stack([self.private(s) for s in range(self.slots)])
        self._free: List[int] = list(
            range(self.slots * nblk, self.slots * nblk + self.extra))
        self._ref: Dict[int, int] = {}
        self._entries: Dict[object, np.ndarray] = {}
        self._occupied: set = set()

    def private(self, s: int) -> np.ndarray:
        return np.arange(s * self.nblk, (s + 1) * self.nblk, dtype=np.int32)

    # -- shared prefix blocks -------------------------------------------------

    def lookup(self, key) -> Optional[np.ndarray]:
        """Shared block ids seeded for ``key`` (None if never seeded /
        dropped)."""
        return self._entries.get(key)

    def seed_blocks(self, key, n_full: int) -> Optional[np.ndarray]:
        """Allocate ``n_full`` shared blocks for a prefix.  Returns None
        when the free list can't cover it (admissions then fall back to
        fully-private writes — correctness never depends on aliasing)."""
        if key in self._entries:
            return self._entries[key]
        if n_full > len(self._free):
            return None
        ids = np.asarray([self._free.pop(0) for _ in range(n_full)], np.int32)
        for b in ids:
            self._ref[int(b)] = 1            # the prefix-cache's reference
        self._entries[key] = ids
        return ids

    def drop_prefix(self, key) -> None:
        """Release the prefix cache's reference (entry evicted).  Blocks
        still aliased by live slots stay allocated until those retire."""
        ids = self._entries.pop(key, None)
        if ids is None:
            return
        for b in ids:
            self._decref(int(b))

    def _decref(self, b: int) -> None:
        self._ref[b] -= 1
        if self._ref[b] == 0:
            del self._ref[b]
            self._free.append(b)

    # -- slot lifecycle -------------------------------------------------------

    def occupy(self, s: int) -> None:
        """Admit into slot ``s`` with no shared prefix: fully private row."""
        self.tables[s] = self.private(s)
        self._occupied.add(s)

    def alias(self, s: int, key) -> int:
        """Admit into slot ``s`` aliasing the prefix seeded under ``key``;
        returns the number of aliased blocks."""
        ids = self._entries[key]
        n = len(ids)
        row = self.private(s)
        row[:n] = ids
        self.tables[s] = row
        for b in ids:
            self._ref[int(b)] += 1
        self._occupied.add(s)
        return n

    def release(self, s: int) -> None:
        """Retire slot ``s``: drop its shared references and reset the
        table row to the private blocks."""
        if s not in self._occupied:
            return
        lo = self.slots * self.nblk
        for b in self.tables[s]:
            if lo <= int(b) < self.trash:
                self._decref(int(b))
        self.tables[s] = self.private(s)
        self._occupied.discard(s)

    # -- accounting -----------------------------------------------------------

    def stats(self):
        """(kv_blocks_in_use, kv_blocks_shared): distinct blocks reachable
        from occupied slots or live prefix entries, and blocks aliased by
        more than one occupied slot."""
        rows = [self.tables[s] for s in self._occupied]
        slot_ids = (np.concatenate(rows) if rows
                    else np.empty(0, np.int32))
        uniq, counts = np.unique(slot_ids, return_counts=True)
        entry_ids = {int(b) for ids in self._entries.values() for b in ids}
        in_use = len(set(uniq.tolist()) | entry_ids)
        shared = int((counts > 1).sum())
        return in_use, shared
