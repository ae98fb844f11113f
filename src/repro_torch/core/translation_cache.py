"""Software translation cache for the serving scheduler (the PWC analogue).

NDPage keeps page-walk caches for the two upper levels (hit rates ~100% /
98.6%) while the flattened bottom level goes straight to memory.  In the
serving runtime the analogous hot metadata is the *directory row* of a
sequence (radix mode) or the flat-table row (flat mode): the scheduler
resolves logical->physical pages on the host when building kernel operands,
and this LRU cache avoids re-deriving rows for sequences whose mapping did
not change between steps (prefix-shared and continuing sequences).

The cache OWNS the per-sequence version counter: callers ask
:meth:`version` for the current one, :meth:`bump` it when a mapping
grows, and :meth:`invalidate` both evicts the rows and bumps — so a
recycled ``seq_id`` (request ids are caller-chosen) can never hit a
stale row even if the caller's own bookkeeping restarts from zero.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, Optional, Tuple

import numpy as np


class TranslationCache:
    """LRU cache over (seq_id, version) -> np.ndarray physical-page rows."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._store: "OrderedDict[Tuple[Hashable, int], np.ndarray]" = (
            OrderedDict())
        #: versions of LIVE sequences only (bounded by the live set —
        #: invalidate() pops the entry); untracked ids default to the
        #: monotone floor below, which invalidate() raises past every
        #: version the retiring sequence ever used
        self._versions: Dict[Hashable, int] = {}
        self._floor = 0
        self.hits = 0
        self.misses = 0

    # -- versions -------------------------------------------------------------
    def version(self, seq_id: Hashable) -> int:
        """Current mapping version of ``seq_id`` (the monotone floor
        for ids not currently tracked)."""
        return self._versions.get(seq_id, self._floor)

    def bump(self, seq_id: Hashable) -> int:
        """Advance ``seq_id``'s version (the mapping changed); rows
        cached under older versions become unreachable and age out of
        the LRU."""
        self._versions[seq_id] = self.version(seq_id) + 1
        return self._versions[seq_id]

    # -- rows -----------------------------------------------------------------
    def lookup(self, seq_id: Hashable,
               version: Optional[int] = None) -> Optional[np.ndarray]:
        key = (seq_id, self.version(seq_id) if version is None else version)
        row = self._store.get(key)
        if row is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return row

    def insert(self, seq_id: Hashable, version: Optional[int],
               row: np.ndarray) -> None:
        if version is None:
            # pin the id's version so a LATER floor raise (another
            # sequence retiring) cannot orphan this live row
            version = self._versions.setdefault(seq_id,
                                                self.version(seq_id))
        key = (seq_id, version)
        self._store[key] = row
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    def invalidate(self, seq_id: Hashable) -> None:
        """Evict every cached row of ``seq_id`` AND advance past its
        versions: eviction alone is not enough, because a later
        sequence reusing the id at version 0 would otherwise race a
        concurrent insert for the same (seq_id, 0) key.  The id's
        tracking entry is dropped (the dict stays bounded by the live
        set) and the shared floor raised past every version it used —
        a recycled id restarts above them.

        Invalidating an id that was never admitted (no cached rows, no
        version entry) is a pure no-op: raising the floor for it would
        desynchronize EVERY untracked id's version for no benefit —
        retry/eviction paths may double-invalidate freely."""
        had_rows = False
        for key in [k for k in self._store if k[0] == seq_id]:
            del self._store[key]
            had_rows = True
        if had_rows or seq_id in self._versions:
            self._floor = max(self._floor, self.version(seq_id) + 1)
            self._versions.pop(seq_id, None)

    @property
    def hit_rate(self) -> float:
        """Hits / lookups; 0.0 on a fresh cache (never divides by zero)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
