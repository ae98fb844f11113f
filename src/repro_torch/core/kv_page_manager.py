"""Paged KV-cache manager: host-side allocator + device-side page primitives.

The host allocator (PagePool / KVPageManager) plays the OS role: it owns
the free list, maps logical pages of live sequences to physical pages,
and decides the table organization (radix 2-level vs NDPage flat) from
measured occupancy.  Allocation never happens inside a decode step;
steps consume a ready table, exactly as a page walk consumes OS-built
page tables.

Device-side primitives (`append_kv`, `gather_kv`) are the data-path half
used by models/attention and by the kernels' plain version.  Unlike the
JAX package, which returns new pools, ``append_kv`` updates the pools in
place with ``index_put_``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import block_table as BT


# ---------------------------------------------------------------------------
# host-side allocator (the "OS")
# ---------------------------------------------------------------------------
class PagePool:
    """Refcounted free-list allocator over a fixed pool of physical KV
    pages (a copy of the JAX package's).

    Pages come out of :meth:`allocate` with refcount 1; prefix-sharing
    sequences take additional references via :meth:`share` and every
    holder calls :meth:`release` — the page returns to the free list
    only when the LAST reference drops, so evicting one sharer can
    never free a page another live sequence still maps.  Freed pages
    return to the free list in ascending order, so both packages hand
    out the same page ids.

    The ``*_array`` variants are the fleet path: one numpy round-trip
    for a whole batch of pages instead of a per-page Python loop.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros(num_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: want {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        self._ref[out] = 1
        return out

    def share(self, pages: List[int]) -> None:
        """Take one additional reference on each (already-allocated)
        page — the prefix-sharing admission path."""
        self._ref[list(pages)] += 1

    def release(self, pages: List[int]) -> None:
        """Drop one reference per page; pages reaching refcount 0 go
        back to the free list."""
        self.release_array(np.asarray(list(pages), np.int64))

    # -- batched (fleet) variants -------------------------------------------
    def allocate_array(self, n: int) -> np.ndarray:
        """Allocate ``n`` pages as one int32 array (refcount 1 each)."""
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: want {n}, have {len(self._free)}")
        if n == 0:
            return np.empty(0, np.int32)
        out = np.asarray(self._free[-n:], np.int32)[::-1].copy()
        del self._free[-n:]
        self._ref[out] = 1
        return out

    def share_array(self, pages: np.ndarray) -> None:
        np.add.at(self._ref, np.asarray(pages, np.int64), 1)

    def release_array(self, pages: np.ndarray) -> None:
        """Vectorized :meth:`release`: handles one batch containing the
        same shared page several times (several retiring sharers).  A
        page dropped below refcount 0 is a double free."""
        pages = np.asarray(pages, np.int64)
        if pages.size == 0:
            return
        np.add.at(self._ref, pages, -1)
        uniq = np.unique(pages)
        if (self._ref[uniq] < 0).any():
            bad = uniq[self._ref[uniq] < 0]
            raise ValueError(f"double free of pages {bad.tolist()}")
        freed = uniq[self._ref[uniq] == 0]
        self._free.extend(int(p) for p in freed)


class KVPageManager:
    """Logical->physical page mapping for a batch of sequences.

    Mirrors NDPage's design point: the mapping is kept as a 2-level radix
    structure and *flattened* when the measured occupancy crosses
    ``FLATTEN_THRESHOLD`` — after which decode kernels get the
    single-indirection flat table.  Tables are built on ``device``.
    """

    FLATTEN_THRESHOLD = 0.5

    def __init__(self, num_pages: int, page_size: int, max_seqs: int,
                 max_len: int, device: torch.device | str = "cuda"):
        self.pool = PagePool(num_pages)
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.max_pages = -(-max_len // page_size)
        self.leaf_size = BT.leaf_size_for(self.max_pages)
        self.device = torch.device(device)
        self.pages: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}
        self.stats = {"allocated_pages": 0, "freed_pages": 0,
                      "flattens": 0, "table_rebuilds": 0}

    # -- sequence lifecycle -------------------------------------------------
    def add_sequence(self, seq_id: int, prompt_len: int,
                     shared_pages: Optional[List[int]] = None) -> None:
        """Map ``prompt_len`` tokens for ``seq_id``.  ``shared_pages``
        (prefix sharing) seeds the first logical pages from an
        already-live prefix: the pool takes an extra reference on each
        instead of allocating, so sharers hold the same physical pages
        and :meth:`free_sequence` of one sharer never frees them out
        from under another."""
        n = -(-max(prompt_len, 1) // self.page_size)
        shared = list(shared_pages or [])[:n]
        if shared:
            self.pool.share(shared)
        try:
            fresh = self.pool.allocate(n - len(shared))
        except MemoryError:
            if shared:                    # unwind the references we took
                self.pool.release(shared)
            raise
        self.pages[seq_id] = shared + fresh
        self.lengths[seq_id] = prompt_len
        self.stats["allocated_pages"] += n - len(shared)

    def append_token(self, seq_id: int) -> None:
        """Grow mapping by one token; allocate a page on boundary cross."""
        self.lengths[seq_id] += 1
        need = -(-self.lengths[seq_id] // self.page_size)
        have = len(self.pages[seq_id])
        if need > have:
            self.pages[seq_id].extend(self.pool.allocate(need - have))
            self.stats["allocated_pages"] += need - have

    def free_sequence(self, seq_id: int) -> None:
        pages = self.pages.pop(seq_id)
        self.pool.release(pages)
        self.stats["freed_pages"] += len(pages)
        del self.lengths[seq_id]

    # -- occupancy & table organization (the NDPage decision) ---------------
    def occupancy(self) -> float:
        """Used slots / mapped slots across live sequences."""
        used = sum(self.lengths.values())
        mapped = sum(len(p) for p in self.pages.values()) * self.page_size
        return used / mapped if mapped else 0.0

    def preferred_mode(self) -> str:
        return (BT.FLAT if self.occupancy() >= self.FLATTEN_THRESHOLD
                else BT.RADIX)

    # -- device-table construction -------------------------------------------
    def flat_table(self, seq_ids: List[int]) -> torch.Tensor:
        """(B, max_pages) int32 on the manager's device; -1 where
        unmapped."""
        self.stats["table_rebuilds"] += 1
        tab = np.full((len(seq_ids), self.max_pages), -1, np.int32)
        for i, sid in enumerate(seq_ids):
            p = self.pages[sid]
            tab[i, : len(p)] = p
        return torch.from_numpy(tab).to(self.device)

    def radix_table(self, seq_ids: List[int]) -> BT.RadixTable:
        flat = self.flat_table(seq_ids)
        return BT.radix_from_flat(flat, self.leaf_size)

    def build_table(self, seq_ids: List[int], mode: Optional[str] = None):
        mode = mode or self.preferred_mode()
        if mode == BT.FLAT:
            self.stats["flattens"] += 1
            return self.flat_table(seq_ids), BT.FLAT
        return self.radix_table(seq_ids), BT.RADIX

    def lengths_array(self, seq_ids: List[int]) -> torch.Tensor:
        return torch.tensor([self.lengths[s] for s in seq_ids],
                            dtype=torch.int32, device=self.device)


# ---------------------------------------------------------------------------
# device-side page primitives (data path)
# ---------------------------------------------------------------------------
def append_kv(kp: torch.Tensor, vp: torch.Tensor, k_new: torch.Tensor,
              v_new: torch.Tensor, phys_page: torch.Tensor,
              slot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter one new token's K/V into the pools, IN PLACE.

    kp/vp: (N, page, K, H); k_new/v_new: (B, K, H); phys_page, slot: (B,).
    The JAX counterpart returns updated copies; here the pools are
    mutated with ``index_put_`` and returned for symmetry.
    """
    idx = (phys_page.long(), slot.long())   # no copy when already int64
    kp.index_put_(idx, k_new.to(kp.dtype))
    vp.index_put_(idx, v_new.to(vp.dtype))
    return kp, vp


def gather_kv(kp: torch.Tensor, vp: torch.Tensor, phys: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize per-sequence KV from pools (the plain reference path).

    phys: (B, max_pages) -> (B, max_pages*page, K, H); unmapped (-1)
    entries read page 0, as in the JAX package.
    """
    safe = phys.clamp_min(0).long()
    b, mp = phys.shape
    n, pg, kh, hd = kp.shape
    ks = kp[safe].reshape(b, mp * pg, kh, hd)
    vs = vp[safe].reshape(b, mp * pg, kh, hd)
    return ks, vs
