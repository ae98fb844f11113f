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
    """Free-list allocator over a fixed pool of physical KV pages.

    The JAX package's pool is refcounted for the fleet path's prefix
    sharing; the port has no sharing yet, so a page is either free or
    held by one sequence.  Freed pages return to the free list in
    ascending order, as there, so both hand out the same page ids.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._live = np.zeros(num_pages, bool)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: want {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        self._live[out] = True
        return out

    def release(self, pages: List[int]) -> None:
        """Return held pages to the free list; a page that is not held,
        or is named twice, is a double free."""
        uniq, count = np.unique(np.asarray(list(pages), np.int64),
                                return_counts=True)
        bad = uniq[(count > 1) | ~self._live[uniq]]
        if bad.size:
            raise ValueError(f"double free of pages {bad.tolist()}")
        self._live[uniq] = False
        self._free.extend(int(p) for p in uniq)


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
    def add_sequence(self, seq_id: int, prompt_len: int) -> None:
        """Map ``prompt_len`` tokens for ``seq_id``."""
        n = -(-max(prompt_len, 1) // self.page_size)
        self.pages[seq_id] = self.pool.allocate(n)
        self.lengths[seq_id] = prompt_len
        self.stats["allocated_pages"] += n

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
