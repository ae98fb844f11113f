"""Wrapper of the hand-written CUDA LRU-scan kernel of the simulator.

The kernel (``csrc/lru_scan.cu``) replaces the per-step body of the JAX
simulator's serial scan — ``_build_model``'s ``access`` / ``per_mc`` /
``make_step`` in ``src/repro/sim/simulator.py`` (:429-556), run by
``jax.lax.scan`` in ``_chunk_runner`` (:793, :835).  It is not a Pallas
kernel, but it is the simulator's whole serial hot loop, and PyTorch has
no compiled scan: an eager step loop issues about 250 small operations a
trace entry.

What it computes, per trace step, lane and mechanism, in program order:
the L1-DTLB and L2-TLB lookups, the optional cache-as-TLB probe, four
per-level PWC lookups and, per hierarchy level, the lookups of the four
PTE lines and the data line, each a set-associative LRU hit plus fill;
one packed int32 of hit bits per (step, lane, mechanism) comes out, and
the tables and stamps are updated in place (``ref.lru_scan_ref`` is the
plain version and the specification).  On a banked memory the scan also
carries each bank's open row and appends five row-buffer-hit bits, one
per line site that reached memory.

Bound.  A chunk moves its inputs, walk lines and packed bits once and
reads and writes each table once: about 26 MB for a 1,024-step chunk of
the ``ndp_machine(8)`` bucket, 8 us at 3.35 TB/s.  The kernel is bound by
latency instead: each (lane, mechanism) chain is serial, 11 lookups a
step on an NDP machine (2 TLB + 4 PWC + 5 l1) and 21 on a CPU machine
(2 + 4 + 15), plus the cache-as-TLB probe where there is one.

Design.  One warp per (lane, mechanism) chain, a chain a block, loops
over the chunk's steps; lane ``w`` of the warp owns ways ``w`` and
``w + 32`` (tables of up to 64 ways), so a way is only ever read and
written by the same thread and the warp needs no barrier between
lookups.  The tables stay in global memory.  A hit is a ``__ballot_sync`` on tag
equality; a miss takes the first way of least stamp by
``__reduce_min_sync``, a ballot and ``__ffs``.  The inputs are loaded 32
steps ahead (a step a lane, handed out by shuffles); a step's TLB and
PWC rows are read before their lookups resolve, and those lookups
resolve without a branch, side by side; the hierarchy lookups stay
serial, each skipped where disabled.  One launch per chunk, as the JAX
runner dispatches one scan per chunk; the walk lines are computed by
torch ops once for a group of chunks and passed in.  The scan reads
neither the queue delay nor the clock, so a later version may launch
once over many chunks.

Banked memory (``BANKED`` instantiations; the bounded ones are compiled
without it): lane ``k`` of the warp keeps bank ``k``'s open row (and
``k + 32``'s, up to 64 banks) in a register for the chunk.  The rows
change only at the end of a step, so each site's bank, row and open row
(one shuffle) are read at the start of the step, beside the lookups; at
the end a site that reached memory sees the row an earlier site of the
step opened in its bank, else the one read, and the bank's lane takes
the last row opened in it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import (FLAG_BYPASS, FLAG_CACHE_TLB,
                                     FLAG_COLOCATE, FLAG_HUGE, FLAG_IDEAL,
                                     FLAG_N_PTE_SHIFT, FLAG_PARALLEL,
                                     FLAG_PWC_SHIFT, FLAG_SEGMENT,
                                     SCAN_TABLES)

#: number of kernel launches since the counter was last reset
launches = 0

#: the most ways a table may have (two a lane of the warp), and the most
#: banks of a banked memory (the same)
MAX_WAYS = 64
MAX_BANKS = 64

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("lru_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lru_scan_launch.argtypes = (
            [i32] + [ptr] * 8 + [i32] * 3
            + [ctypes.POINTER(ptr)] * 2 + [ctypes.POINTER(i32)] * 2
            + [ptr, i32, i32, ptr])
        lib.lru_scan_launch.restype = i32
        lib.lru_scan_error_string.argtypes = [i32]
        lib.lru_scan_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def mech_flags(mt: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The scan's and the epilogue's (L, M) int32 flag words from
    per-lane mechanism tables (``ideal``/``huge``/``bypass``/``segment``/
    ``cache_tlb``/``colocate``/``parallel``: (L, M) bool, ``pwc_on``:
    (L, M, 4) bool, ``n_pte``: (L, M) int)."""
    f = torch.zeros(mt["n_pte"].shape, dtype=torch.int32,
                    device=mt["n_pte"].device)
    for key, bit in (("ideal", FLAG_IDEAL), ("huge", FLAG_HUGE),
                     ("bypass", FLAG_BYPASS), ("segment", FLAG_SEGMENT),
                     ("cache_tlb", FLAG_CACHE_TLB),
                     ("colocate", FLAG_COLOCATE),
                     ("parallel", FLAG_PARALLEL)):
        f |= mt[key].to(torch.int32) * bit
    for lvl in range(mt["pwc_on"].shape[-1]):
        f |= mt["pwc_on"][..., lvl].to(torch.int32) << (FLAG_PWC_SHIFT + lvl)
    return f | (mt["n_pte"].to(torch.int32) << FLAG_N_PTE_SHIFT)


def lru_scan(vpn: torch.Tensor, off: torch.Tensor, is4k: torch.Tensor,
             valid: torch.Tensor, pte: torch.Tensor, flags: torch.Tensor,
             stamp: torch.Tensor,
             tables: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
             bank_row: Optional[torch.Tensor] = None,
             lines_per_row: int = 0) -> torch.Tensor:
    """One chunk of the LRU scan (arguments as ``ref.lru_scan_ref``):
    packed hit bits (T, L, M) int32 out, ``tables``, ``stamp`` and
    (banked memory) ``bank_row`` updated in place.  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if vpn.device.type == "cpu":
        _check(vpn, off, is4k, valid, pte, flags, stamp, tables, bank_row,
               lines_per_row)
        return ref.lru_scan_ref(vpn, off, is4k, valid, pte, flags, stamp,
                                tables, bank_row, lines_per_row)
    if vpn.device.type != "cuda":
        raise ValueError(f"no lru_scan for device {vpn.device}")
    global launches
    packed = _launch(vpn, off, is4k, valid, pte, flags, stamp, tables,
                     bank_row, lines_per_row)
    launches += 1
    return packed


def _check(vpn, off, is4k, valid, pte, flags, stamp, tables, bank_row=None,
           lines_per_row=0) -> None:
    t_len, n_lanes = vpn.shape
    m = stamp.shape[-1]
    want = {"vpn": (vpn, torch.int32, (t_len, n_lanes)),
            "off": (off, torch.int32, (t_len, n_lanes)),
            "is4k": (is4k, torch.bool, (t_len, n_lanes)),
            "valid": (valid, torch.bool, (t_len, n_lanes)),
            "pte": (pte, torch.int32, (t_len, n_lanes, m, 4)),
            "flags": (flags, torch.int32, (n_lanes, m)),
            "stamp": (stamp, torch.int32, (n_lanes, m))}
    for name, (tags, lru) in tables.items():
        if name not in SCAN_TABLES:
            raise ValueError(f"unknown scan table {name!r}")
        shape = (n_lanes, m) + tuple(tags.shape[2:])
        if tags.dim() != 4 or tags.shape[-1] > MAX_WAYS:
            raise ValueError(f"table {name!r} must be (L, M, sets, ways) "
                             f"with at most {MAX_WAYS} ways, got "
                             f"{tuple(tags.shape)}")
        want[name + ".tags"] = (tags, torch.int32, shape)
        want[name + ".lru"] = (lru, torch.int32, shape)
    for name in ("l1tlb", "l2tlb", "pwc", "l1"):
        if name not in tables:
            raise ValueError(f"the scan needs table {name!r}")
    if ("l2" in tables) != ("l3" in tables):
        raise ValueError("tables l2 and l3 come together")
    if bank_row is not None:
        nb = bank_row.shape[-1]
        if bank_row.dim() != 3 or not 1 <= nb <= MAX_BANKS:
            raise ValueError(f"bank_row must be (L, M, banks) with 1 to "
                             f"{MAX_BANKS} banks, got "
                             f"{tuple(bank_row.shape)}")
        if lines_per_row < 1:
            raise ValueError(f"lines_per_row must be >= 1, got "
                             f"{lines_per_row}")
        want["bank_row"] = (bank_row, torch.int32, (n_lanes, m, nb))
    for name, (t, dtype, shape) in want.items():
        if t.device != vpn.device:
            raise ValueError(f"{name} is on {t.device}, vpn on {vpn.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pte.data_ptr() % 16:
        raise ValueError("pte must be 16-byte aligned")


def _launch(vpn, off, is4k, valid, pte, flags, stamp, tables,
            bank_row=None, lines_per_row=0):
    """Launch the kernel on checked operands; counts nothing
    (``chip_smoke.py`` times the kernel through it)."""
    _check(vpn, off, is4k, valid, pte, flags, stamp, tables, bank_row,
           lines_per_row)
    t_len, n_lanes = vpn.shape
    m = stamp.shape[-1]
    packed = torch.empty((t_len, n_lanes, m), dtype=torch.int32,
                         device=vpn.device)
    n = len(SCAN_TABLES)
    tags_p, lru_p = (ctypes.c_void_p * n)(), (ctypes.c_void_p * n)()
    sets, ways = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    for k, name in enumerate(SCAN_TABLES):
        if name in tables:
            tags, lru = tables[name]
            tags_p[k], lru_p[k] = tags.data_ptr(), lru.data_ptr()
            sets[k], ways[k] = tags.shape[2], tags.shape[3]
    lib = _lib()
    err = lib.lru_scan_launch(
        vpn.device.index, vpn.data_ptr(), off.data_ptr(), is4k.data_ptr(),
        valid.data_ptr(), pte.data_ptr(), flags.data_ptr(), stamp.data_ptr(),
        packed.data_ptr(), t_len, n_lanes, m, tags_p, lru_p, sets, ways,
        None if bank_row is None else bank_row.data_ptr(),
        0 if bank_row is None else bank_row.shape[-1], lines_per_row,
        torch.cuda.current_stream(vpn.device).cuda_stream)
    if err != 0:
        msg = lib.lru_scan_error_string(err).decode()
        raise RuntimeError(f"lru_scan kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    return packed
