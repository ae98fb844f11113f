"""Serving-side translation tables: logical KV page -> physical KV page.

Two organizations, mirroring the paper (and ``repro.core.block_table``):

  * radix (2-level): per-sequence directory -> shared leaf tables ->
    physical page.  Lookup = TWO dependent gathers (the deep-tree
    baseline).
  * flat (NDPage): one per-sequence table -> physical page.  Lookup = ONE
    gather.  Decode sequences fill their logical pages densely, so the
    directory level buys no space worth its extra indirection.

All tables are int32 tensors on the caller's device; host-side allocation
lives in ``kv_page_manager.PagePool``.  The PTE line counters used by the
translation cost model belong to the cost-model slice and are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

FLAT = "paged_flat"
RADIX = "paged_radix"
#: pages per radix leaf table; it must divide a table's max_pages
LEAF_SIZE = 16


def leaf_size_for(max_pages: int) -> int:
    """The radix leaf size of a table of ``max_pages`` pages (a table
    narrower than one leaf is a single leaf)."""
    return min(LEAF_SIZE, max_pages)


@dataclass
class RadixTable:
    """directory: (B, n_dir) int32 leaf-table ids (-1 = unallocated)
    leaves: (n_leaf_tables, leaf_size) int32 physical page ids (-1 = hole)."""
    directory: torch.Tensor
    leaves: torch.Tensor

    @property
    def leaf_size(self) -> int:
        return self.leaves.shape[1]


def translate_all(table, mode: str) -> torch.Tensor:
    """Full logical->physical map for every sequence: (B, max_pages) int32.

    flat:  zero extra indirections (the table IS the map).
    radix: one extra dependent gather through the directory.
    """
    if mode == FLAT:
        return table
    if mode == RADIX:
        dir_ = table.directory.clamp_min(0)
        gathered = table.leaves[dir_]                    # (B, n_dir, ls)
        valid = (table.directory >= 0)[..., None]
        gathered = torch.where(valid, gathered, gathered.new_tensor(-1))
        b, n_dir, ls = gathered.shape
        return gathered.reshape(b, n_dir * ls)
    raise ValueError(mode)


def translate_one(table, seq_idx: torch.Tensor, logical_page: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """Physical page for (seq, logical_page); both (B,) tensors."""
    if mode == FLAT:
        return table[seq_idx, logical_page]
    if mode == RADIX:
        ls = table.leaf_size
        leaf_id = table.directory[seq_idx, logical_page // ls]
        return table.leaves[leaf_id.clamp_min(0), logical_page % ls]
    raise ValueError(mode)


def flatten_radix(table: RadixTable) -> torch.Tensor:
    """The NDPage merge: collapse directory+leaves into one flat table."""
    return translate_all(table, RADIX)


def radix_from_flat(flat: torch.Tensor, leaf_size: int) -> RadixTable:
    """Build the 2-level organization of an existing mapping (baseline)."""
    b, maxp = flat.shape
    if maxp % leaf_size != 0:
        raise ValueError(f"leaf_size {leaf_size} must divide max_pages "
                         f"{maxp}")
    n_dir = maxp // leaf_size
    leaves = flat.reshape(b * n_dir, leaf_size)
    directory = torch.arange(b * n_dir, dtype=torch.int32,
                             device=flat.device).reshape(b, n_dir)
    # unallocated directories (all-hole leaves) marked -1
    empty = (leaves < 0).all(dim=1).reshape(b, n_dir)
    directory = torch.where(empty, directory.new_tensor(-1), directory)
    return RadixTable(directory=directory, leaves=leaves)


def table_bytes(table, mode: str) -> int:
    if mode == FLAT:
        return table.numel() * 4
    return table.directory.numel() * 4 + table.leaves.numel() * 4


def occupancy(flat: torch.Tensor, lengths: torch.Tensor, page_size: int
              ) -> torch.Tensor:
    """Fraction of mapped slots actually in use (Observation B metric)."""
    used_pages = -(-lengths // page_size)            # ceil
    mapped = (flat >= 0).sum(dim=1)
    return used_pages / mapped.clamp_min(1)
