"""Serving caches (paper §3.3): result memoization + prefix KV sharing.

``ResultCache``: OLAP columns are full of duplicates (categories,
enums, repeated entities); identical (prompt, params-version) pairs
short-circuit the model entirely.  LRU with hit accounting — the
cache-hit rate is one of the Table-1-adjacent numbers benchmarks
report.

``PrefixCache``: template-heavy operators render every row through a
fixed prompt template, so the template's token prefix is prefilled
once per (template, model version) and its KV/recurrent state is
reused to seed every row's per-slot state — per-row prefill then
processes only the row suffix (Liu et al., "Optimizing LLM Queries in
Relational Workloads").  ``version`` in the key invalidates entries
when a query swaps in a recompressed instance-optimized model.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple


class ResultCache:
    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def key(self, prompt: str, max_new: int, version: str = "") -> Tuple:
        return (prompt, max_new, version)

    def get(self, key) -> Optional[str]:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def peek(self, key) -> Optional[str]:
        """Lookup without touching hit/miss accounting or LRU order.

        The engine separates *lookup* from *accounting*: a prompt whose
        twin is still decoding counts as a hit (it never reaches the
        model) even though the value isn't stored yet, so the engine
        peeks first and then records exactly one hit or miss per
        request via record_hit / record_miss.
        """
        return self._d.get(key)

    def record_hit(self, key=None) -> None:
        self.hits += 1
        if key is not None and key in self._d:
            self._d.move_to_end(key)

    def record_miss(self) -> None:
        self.misses += 1

    def put(self, key, value: str) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def clear(self) -> None:
        self._d.clear()
        self.hits = self.misses = 0


# ---------------------------------------------------------------------------
# prefix KV sharing
# ---------------------------------------------------------------------------

@dataclass
class PrefixEntry:
    """One prefilled template prefix: the family cache pytree (batch=1,
    full ``max_len`` slots for attention families; the hybrid's adds the
    recurrent states at the end of the prefix, which ``prefill_from``
    resumes; rwkv's is those states alone, the size of one decode slot's
    whatever the prefix's length) plus the prefix token count."""
    state: Any
    prefix_len: int
    hits: int = 0            # rows seeded from this entry


class PrefixCache:
    """LRU of prefilled template prefixes.

    Keyed on ``(prefix token tuple, model version)``: the token prefix
    identifies the rendered template, the version ties the stored
    KV/state to the exact parameter set that produced it — an
    instance-optimized (recompressed) model gets fresh entries instead
    of decoding against stale activations.  Capacity is small: entries
    hold device arrays sized like one decode slot.
    """

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._d: "OrderedDict[Tuple, PrefixEntry]" = OrderedDict()
        self.hits = 0            # entry-level lookup hits
        self.misses = 0
        # fn(key, entry) called on LRU eviction — paged engines subscribe
        # so their block allocators can release the entry's shared blocks
        # (a pool-shared cache holds entries from many engines; each
        # subscriber ignores keys it never seeded).  Bound methods are
        # held weakly: an engine the model pool evicted must not stay
        # alive, with its KV pool on the device, through this list.
        self._evict_listeners: list = []

    def add_evict_listener(self, fn) -> None:
        if any(ref() == fn for ref in self._evict_listeners):
            return
        self._evict_listeners.append(
            weakref.WeakMethod(fn) if hasattr(fn, "__self__")
            else (lambda fn=fn: fn))

    def key(self, prefix_ids: Sequence[int], version: str = "") -> Tuple:
        return (tuple(prefix_ids), version)

    def get(self, key) -> Optional[PrefixEntry]:
        e = self._d.get(key)
        if e is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return e

    def put(self, key, state, prefix_len: int) -> PrefixEntry:
        e = PrefixEntry(state=state, prefix_len=prefix_len)
        self._d[key] = e
        self._d.move_to_end(key)
        if len(self._d) > self.capacity:
            old_key, old_entry = self._d.popitem(last=False)
            fns = [ref() for ref in self._evict_listeners]
            self._evict_listeners = [ref for ref, fn in zip(self._evict_listeners, fns)
                                     if fn is not None]
            for fn in fns:
                if fn is not None:
                    fn(old_key, old_entry)
        return e

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def clear(self) -> None:
        self._d.clear()
        self.hits = self.misses = 0
