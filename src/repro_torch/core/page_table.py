"""Functional page-table models: the PTE access streams of each mechanism.

The port's copy of ``repro.core.page_table``.  The simulator replays
virtual-page-number (VPN) traces; each mechanism maps a VPN to the
sequence of PTE cache-line addresses a hardware page walk would touch.
Addresses are synthetic-physical 64B-line ids (int32, inside a page-table
region above ``PT_REGION_LINE``) that keep the locality structure:

  radix-4     4 sequential accesses; PTEs of adjacent VPNs share lines;
              node placement is a hash of the VPN prefix.
  ndpage      3 sequential accesses; levels L2/L1 merged into one 2MB node
              indexed by the low 18 VPN bits (the paper's flattened table).
  hugepage    3 sequential accesses (2MB pages, no PL1).
  ech         2 parallel cuckoo-hash probes.
  ideal       no PTE accesses at all.

The walk functions are torch ops on int64 (torch has no CPU ``>>`` on
uint32): the 32-bit hash is masked to 32 bits after every step, and
``x * 0x846CA68B`` may wrap past 2^63, which leaves its low 32 bits
right.  They take a tensor of VPNs and return int32 line ids with one
more trailing axis.  The numpy helpers below are host-side analysis.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PTE_BYTES = 8
LINE_BYTES = 64
PTES_PER_LINE = LINE_BYTES // PTE_BYTES          # 8
ENTRIES = 512                                    # per 4KB radix node
NODE_LINES = ENTRIES // PTES_PER_LINE            # 64 lines per 4KB node
FLAT_LINES = (1 << 18) // PTES_PER_LINE          # 32768 lines per 2MB node
PT_REGION_LINE = 1 << 28                         # PT region starts here

# VPN bit slices (48-bit VA, 4KB pages -> 36-bit VPN; traces use <= 2^23)
#   L1 idx: bits 0..8 | L2: 9..17 | L3: 18..26 | L4: 27..35
_SHIFTS = (27, 18, 9, 0)                         # L4, L3, L2, L1

_M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor, salt: int) -> torch.Tensor:
    """Cheap deterministic integer hash (Wang-style) of the low 32 bits
    of ``x``, as an int64 tensor in [0, 2^32)."""
    x = (x.long() & _M32) ^ salt
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _node_base_line(node_key: torch.Tensor, salt: int) -> torch.Tensor:
    """Pseudo-random 4KB-aligned node placement: line id of node start."""
    return (_mix(node_key, salt) & 0xFFFFF) * NODE_LINES


def _level_line(vpn: torch.Tensor, shift: int, salt: int) -> torch.Tensor:
    v = vpn.long()
    idx = (v >> shift) & (ENTRIES - 1)
    base = _node_base_line(v >> (shift + 9), salt)
    return PT_REGION_LINE + base + idx // PTES_PER_LINE


def _lines(cols) -> torch.Tensor:
    return torch.stack(cols, dim=-1).to(torch.int32)


def radix4_walk_lines(vpn: torch.Tensor) -> torch.Tensor:
    """PTE line ids for a 4-level walk. vpn: (T,) -> (T, 4)."""
    return _lines([_level_line(vpn, sh, 0xA0 + i)
                   for i, sh in enumerate(_SHIFTS)])


def ndpage_walk_lines(vpn: torch.Tensor) -> torch.Tensor:
    """NDPage: L4, L3, then ONE flattened L2/L1 access. (T,) -> (T, 3)."""
    out = [_level_line(vpn, sh, 0xA0 + i) for i, sh in enumerate(_SHIFTS[:2])]
    v = vpn.long()
    base = (_mix(v >> 18, 0xF1) & 0x3F) * FLAT_LINES
    out.append(PT_REGION_LINE + base + (v & ((1 << 18) - 1)) // PTES_PER_LINE)
    return _lines(out)


def ndpage_pl3_walk_lines(vpn: torch.Tensor) -> torch.Tensor:
    """Flattened-PL3 NDPage variant: L4, then ONE node merging L3/L2/L1.
    (T,) -> (T, 2)."""
    out = [_level_line(vpn, _SHIFTS[0], 0xA0)]
    v = vpn.long()
    # 8 possible giant nodes of 2^24 lines each (region stays in int32)
    base = (_mix(v >> 27, 0xF7) & 0x7) * ((1 << 27) // PTES_PER_LINE)
    out.append(PT_REGION_LINE + base + (v & ((1 << 27) - 1)) // PTES_PER_LINE)
    return _lines(out)


def hugepage_walk_lines(vpn: torch.Tensor) -> torch.Tensor:
    """2MB pages: PL4, PL3, PL2 only. (T,) -> (T, 3)."""
    return _lines([_level_line(vpn, sh, 0xB0 + i)
                   for i, sh in enumerate(_SHIFTS[:3])])


def ech_probe_lines(vpn: torch.Tensor, num_ways: int = 2) -> torch.Tensor:
    """Elastic cuckoo hashing: d independent hashed probes. (T,) -> (T, d)."""
    return _lines([PT_REGION_LINE + (1 << 24) * (w + 1)
                   + (_mix(vpn, 0xC0 + w) & 0x00FFFFFF)
                   for w in range(num_ways)])


def inverted_hash_lines(vpn: torch.Tensor) -> torch.Tensor:
    """Near-memory inverted page table: ONE hashed bucket line per
    lookup, no radix levels. (T,) -> (T, 1)."""
    return _lines([PT_REGION_LINE + (5 << 24)
                   + (_mix(vpn, 0xD5) & 0x003FFFFF)])


#: binary-search probes per range lookup (covers 2^12 extent ranks)
RANGE_PROBES = 4
#: 16B range descriptors (base, limit, target) -> 4 per 64B line
RANGES_PER_LINE = 4
#: pages per contiguous extent rank (2MB extents of 4KB pages)
RANGE_EXTENT_SHIFT = 9


def range_walk_lines(vpn: torch.Tensor) -> torch.Tensor:
    """Range/segment-table translation: a binary search over sorted range
    descriptors; probe d reads the midpoint with its low ``keep`` rank
    bits cleared. (T,) -> (T, 4)."""
    rank = vpn.long() >> RANGE_EXTENT_SHIFT
    outs = []
    for d in range(RANGE_PROBES):
        keep = 3 * (RANGE_PROBES - 1 - d)
        idx = (rank >> keep) << keep
        outs.append(PT_REGION_LINE + (6 << 24) + idx // RANGES_PER_LINE)
    return _lines(outs)


# ---------------------------------------------------------------------------
# host-side models for the zoo walks (analysis; numpy)
# ---------------------------------------------------------------------------
def _hash_np(x: np.ndarray, salt: int = 0xD5) -> np.ndarray:
    """Numpy twin of ``_mix`` (same constants, same results)."""
    x = np.asarray(x).astype(np.uint32) ^ np.uint32(salt)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def inverted_table_insert(vpns: np.ndarray, log2_slots: int = 22
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Insert distinct vpns into an open-addressed inverted table.
    Returns ``(slots, probes)``: the slot each vpn landed in (linear
    probing from its hashed home) and the extra probes it paid."""
    vpns = np.asarray(vpns, dtype=np.int64)
    if len(np.unique(vpns)) != len(vpns):
        raise ValueError("inverted_table_insert requires distinct vpns")
    n_slots = 1 << log2_slots
    if len(vpns) > n_slots:
        raise ValueError("more vpns than slots")
    occupied: set = set()
    slots = np.empty(len(vpns), np.int64)
    probes = np.empty(len(vpns), np.int64)
    homes = _hash_np(vpns) & np.uint32(n_slots - 1)
    for i, home in enumerate(homes):
        s, p = int(home), 0
        while s in occupied:
            s = (s + 1) & (n_slots - 1)
            p += 1
        occupied.add(s)
        slots[i], probes[i] = s, p
    return slots, probes


def range_table_lookup(starts: np.ndarray, lengths: np.ndarray,
                       targets: np.ndarray, addrs: np.ndarray
                       ) -> np.ndarray:
    """Binary-search lookup over sorted non-overlapping ranges: range i
    covers [starts[i], starts[i] + lengths[i]); returns ``targets[i] +
    (addr - starts[i])`` per addr, or -1 when no range covers it."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    targets = np.asarray(targets, np.int64)
    addrs = np.asarray(addrs, np.int64)
    idx = np.searchsorted(starts, addrs, side="right") - 1
    safe = np.maximum(idx, 0)
    inside = ((idx >= 0)
              & (addrs < starts[safe] + lengths[safe]))
    return np.where(inside, targets[safe] + (addrs - starts[safe]),
                    np.int64(-1))


def range_table_lookup_linear(starts: np.ndarray, lengths: np.ndarray,
                              targets: np.ndarray, addrs: np.ndarray
                              ) -> np.ndarray:
    """Linear-scan oracle for ``range_table_lookup``."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    targets = np.asarray(targets, np.int64)
    out = np.full(len(np.atleast_1d(addrs)), -1, np.int64)
    for j, a in enumerate(np.atleast_1d(np.asarray(addrs, np.int64))):
        for i in range(len(starts)):
            if starts[i] <= a < starts[i] + lengths[i]:
                out[j] = targets[i] + (a - starts[i])
                break
    return out


def occupancy_by_level(vpns: np.ndarray) -> Tuple[float, float, float, float]:
    """(PL4, PL3, PL2, PL1) occupancy of a workload's touched VPN set:
    touched entries / (ENTRIES * touched nodes) per level."""
    vpns = np.unique(np.asarray(vpns, dtype=np.int64))
    occs = []
    for sh in _SHIFTS:
        entries = np.unique(vpns >> sh)            # distinct entries touched
        tables = np.unique(vpns >> (sh + 9))       # distinct nodes touched
        occs.append(len(entries) / (ENTRIES * max(len(tables), 1)))
    return tuple(occs)  # type: ignore[return-value]


def flattened_occupancy(vpns: np.ndarray) -> float:
    """Occupancy of the merged L2/L1 node (2^18 entries)."""
    vpns = np.unique(np.asarray(vpns, dtype=np.int64))
    tables = np.unique(vpns >> 18)
    return len(vpns) / ((1 << 18) * max(len(tables), 1))


WALKS = {
    "radix": radix4_walk_lines,
    "ndpage": ndpage_walk_lines,
    "ndpage_pl3": ndpage_pl3_walk_lines,
    "hugepage": hugepage_walk_lines,
    "ech": ech_probe_lines,
    "inverted": inverted_hash_lines,
    "range": range_walk_lines,
}
