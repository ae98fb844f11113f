"""Serving-side translation tables: logical KV page -> physical KV page.

Two organizations, mirroring the paper (and ``repro.core.block_table``):

  * radix (2-level): per-sequence directory -> shared leaf tables ->
    physical page.  Lookup = TWO dependent gathers (the deep-tree
    baseline).
  * flat (NDPage): one per-sequence table -> physical page.  Lookup = ONE
    gather.  Decode sequences fill their logical pages densely, so the
    directory level buys no space worth its extra indirection.

All tables are int32 tensors on the caller's device; host-side allocation
lives in ``kv_page_manager.PagePool``.  :func:`count_pte_lines` and the
costed translations count the 64B PTE lines a rebuild or a lookup
touches, as tensors (the JAX package's counters); the translation cost
meter counts the same with its numpy twins
(``repro_torch.sim.cost_model``), at the granularity set here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch.nn import functional as F

FLAT = "paged_flat"
RADIX = "paged_radix"
#: organizations that exist only for cost accounting: range descriptors
#: and inverted-hash buckets need no lookup structure of their own (the
#: flat table is the mapping); they differ in the lines a rebuild touches
SEGMENT = "paged_segment"
INVERTED = "paged_inverted"
#: int32 table entries per 64B cache line: the granularity the cost
#: meter counts touched PTE lines at
PTE_PER_LINE = 16
#: 16B (base, limit, target) range descriptors per 64B line: the
#: segment organization's packing
RANGES_PER_LINE = 4
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


def _lines_of(mapped: torch.Tensor) -> torch.Tensor:
    """Touched 64B lines of a line-aligned entry span: ``mapped`` is
    (..., n) bool over consecutive int32 entries starting at a line
    boundary; returns (...,) int32 counts of :data:`PTE_PER_LINE`-entry
    groups with any mapped entry."""
    m = F.pad(mapped, (0, (-mapped.shape[-1]) % PTE_PER_LINE))
    groups = m.reshape(m.shape[:-1] + (-1, PTE_PER_LINE))
    return groups.any(-1).sum(-1).to(torch.int32)


def count_pte_lines(table, mode: str) -> torch.Tensor:
    """The distinct PTE lines a full row rebuild touches per sequence,
    (B,) int32.  flat: the row is one contiguous span, so logical pages
    that would sit in different radix leaves share lines.  radix: the
    directory row is contiguous, but every leaf table is its own
    line-aligned allocation, and a leaf referenced by several directory
    entries of one sequence is walked (and counted) once.  segment and
    inverted: :func:`count_segment_lines`, :func:`count_inverted_lines`
    of the flat row."""
    if mode == FLAT:
        return _lines_of(table >= 0)
    if mode == RADIX:
        dir_ = table.directory                        # (B, n_dir)
        n_dir = dir_.shape[-1]
        valid = dir_ >= 0
        gathered = table.leaves[dir_.clamp_min(0)]   # (B, n_dir, ls)
        mapped = (gathered >= 0) & valid[..., None]
        # entry d repeats an earlier valid entry e < d naming the same leaf
        same = ((dir_[:, :, None] == dir_[:, None, :])
                & valid[:, :, None] & valid[:, None, :])
        j = torch.arange(n_dir, device=dir_.device)
        dup = (same & (j[:, None] > j[None, :])).any(-1)
        mapped = mapped & ~dup[..., None]
        return (_lines_of(valid)
                + _lines_of(mapped).sum(-1)).to(torch.int32)
    if mode == SEGMENT:
        return count_segment_lines(table)
    if mode == INVERTED:
        return count_inverted_lines(table)
    raise ValueError(mode)


def count_pte_lines_shared(flat: torch.Tensor, leaf_size: int
                           ) -> torch.Tensor:
    """Radix line counts of flat rows with batch-global shared-leaf
    dedup, (B,) int32: a leaf whose physical pages are identical across
    sequences (a prefix-shared prompt) is one allocation, so its lines
    are charged once, to the first row (row-major) that references it.
    Directory rows stay per sequence.  A pairwise-comparison oracle,
    O((B n_dir)^2 leaf); the cost meter's numpy twin
    (``cost_model._np_row_lines_shared``) is the fast one."""
    b, maxp = flat.shape
    if maxp % leaf_size:
        raise ValueError(f"leaf_size {leaf_size} must divide max_pages "
                         f"{maxp}")
    n_dir = maxp // leaf_size
    leaves = flat.reshape(b * n_dir, leaf_size)
    mapped = leaves >= 0
    valid = mapped.any(-1)
    same = ((leaves[:, None, :] == leaves[None, :, :]).all(-1)
            & valid[:, None] & valid[None, :])
    j = torch.arange(b * n_dir, device=flat.device)
    dup = (same & (j[:, None] > j[None, :])).any(-1)
    leaf_lines = torch.where(valid & ~dup, _lines_of(mapped), 0)
    return (_lines_of(valid.reshape(b, n_dir))
            + leaf_lines.reshape(b, n_dir).sum(-1)).to(torch.int32)


def count_segment_lines(flat: torch.Tensor) -> torch.Tensor:
    """Segment-organization line count of flat rows, (...,) int32: one
    range descriptor per maximal run of physically contiguous mapped
    pages (phys[i+1] == phys[i] + 1), :data:`RANGES_PER_LINE` a line."""
    mapped = flat >= 0
    prev_m = F.pad(mapped[..., :-1], (1, 0), value=False)
    prev_p = F.pad(flat[..., :-1], (1, 0), value=-2)
    runs = (mapped & (~prev_m | (flat != prev_p + 1))).sum(-1)
    return ((runs + RANGES_PER_LINE - 1) // RANGES_PER_LINE
            ).to(torch.int32)


def count_inverted_lines(flat: torch.Tensor) -> torch.Tensor:
    """Inverted-organization line count of flat rows, (...,) int32:
    every mapped page's entry lives in its own hashed bucket line."""
    return (flat >= 0).sum(-1).to(torch.int32)


def translate_all_costed(table, mode: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`translate_all` plus :func:`count_pte_lines`: the costed
    rebuild of the translation-metered serving path."""
    return translate_all(table, mode), count_pte_lines(table, mode)


def translate_one_costed(table, seq_idx: torch.Tensor,
                         logical_page: torch.Tensor, mode: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`translate_one` plus the PTE lines each lookup reads, (B,)
    int32: a flat lookup one line; a radix lookup the directory's line
    and, where the directory entry is mapped, the leaf's."""
    phys = translate_one(table, seq_idx, logical_page, mode)
    if mode == FLAT:
        return phys, torch.ones_like(seq_idx, dtype=torch.int32)
    if mode == RADIX:
        leaf_id = table.directory[seq_idx, logical_page // table.leaf_size]
        return phys, torch.where(leaf_id >= 0, 2, 1).to(torch.int32)
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
