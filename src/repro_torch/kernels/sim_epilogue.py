"""Wrapper of the hand-written CUDA timing-epilogue kernel of the simulator.

The kernel (``csrc/sim_epilogue.cu``) replaces the JAX simulator's
``epilogue`` (``src/repro/sim/simulator.py:558``, inside
``_build_model``), which the JAX runner fuses into one jitted program a
chunk.  Eager torch ops would issue about 300 launches a chunk for it.

What it computes: from a chunk's packed hit bits (the LRU scan's (T, L,
M) output), the gates the scan used and every step's latencies, summed
over the chunk into nine counters, the cycles and the memory accesses of
each (lane, mechanism), and added into the engine's state in place
(``ref.sim_epilogue_ref`` is the plain version and the specification).
On a banked memory each access that reaches memory pays its own bank's
queue delay, less the row-buffer discount where the scan's bit says the
row was open, and the memory accesses are summed per bank.

Bound.  A streaming reduction: the packed bits, work, is4k and valid read
once, about 2.4 MB for a 1,024-step chunk of the ``ndp_machine(8)``
bucket, 0.7 us at 3.35 TB/s; the kernel is bound by issue and latency.
Design: the chunk spread over the card as column tiles x step tiles (a
column is one (lane, mechanism), 32 a block, one a lane, whole
(simulation, mechanism) groups of C lanes side by side; 16 warps a block,
each loading 2 consecutive steps of the block's step tile at once, so
the loads of a step coalesce and the grid fits the card in one wave);
float64 partial sums folded in a fixed order (warps, then step tiles,
then a group's lanes for the memory accesses) by the last block of each
column tile to finish, which an integer ticket names, and rounded once
into the state: no float atomics, and two launches from the same state
give bit-identical states.  The tiling is the source's
(:func:`geometry`); the wrapper keeps the scratch of the tile partials
and the zeroed ticket words a stream (:func:`_workspace`), grown when a
larger launch needs them and never with a host sync.
Banked (a ``BANKED`` instantiation): the five sites' lines come from the
walk lines the scan read (``pte``) and ``vpn * 64 + off``, the queue
delays of the block's columns per bank sit in shared memory, and the
per-bank access counts are integers, counted with shared-memory atomics
(exact in any order) and folded like the rest.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import (COUNTERS, EPILOGUE_PARAMS, FLAG_BYPASS,
                                     FLAG_CACHE_TLB, FLAG_COLOCATE,
                                     FLAG_HUGE, FLAG_IDEAL, FLAG_N_PTE_SHIFT,
                                     FLAG_PARALLEL, FLAG_SEGMENT)

#: number of kernel launches since the counter was last reset
launches = 0

#: the most lanes a simulation may have and the most banks of a banked
#: memory (the kernel's limits; chip_smoke.py phase 9a runs it at both)
MAX_CORES = 256
MAX_BANKS = 64

_lib_handle = None
#: (device index, stream) -> (scratch bytes, ticket words): see _workspace
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("sim_epilogue")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        i64 = ctypes.c_longlong
        lib.sim_epilogue_launch.argtypes = (
            [i32] + [ptr] * 10 + [ctypes.POINTER(ptr), ptr, i64, ptr]
            + [i32] * 9 + [ptr])
        lib.sim_epilogue_launch.restype = i32
        lib.sim_epilogue_geometry.argtypes = (
            [i32] * 6 + [ctypes.POINTER(i64)])
        lib.sim_epilogue_geometry.restype = i32
        lib.sim_epilogue_occupancy.argtypes = [i32, ctypes.POINTER(i32)]
        lib.sim_epilogue_occupancy.restype = i32
        lib.sim_epilogue_error_string.argtypes = [i32]
        lib.sim_epilogue_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _raise(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().sim_epilogue_error_string(err).decode()
        raise RuntimeError(f"sim_epilogue {what} failed: CUDA error {err} "
                           f"({msg})")


@functools.lru_cache(maxsize=None)
def geometry(device: int, t_len: int, b: int, c: int, m: int, banks: int
             ) -> Dict[str, int]:
    """The kernel's grid and scratch on card ``device`` for a chunk of
    ``t_len`` steps, ``b`` simulations of ``c`` cores, ``m`` mechanisms
    and ``banks`` banks (0: a bounded memory): column tiles, step tiles,
    steps a thread, scratch bytes and ticket words.  The tiling is the
    source's; this asks it."""
    out = (ctypes.c_longlong * 5)()
    _raise(_lib().sim_epilogue_geometry(device, t_len, b, c, m, banks, out),
           "geometry query")
    return dict(zip(("col_tiles", "step_tiles", "steps", "scratch_bytes",
                     "tickets"), out))


def occupancy() -> Dict[str, dict]:
    """What the current card makes of the two instantiations (bounded,
    banked): threads a block, resident blocks an SM, registers a thread
    and local (spill) bytes a thread."""
    out = (ctypes.c_int * 8)()
    _raise(_lib().sim_epilogue_occupancy(torch.cuda.current_device(), out),
           "occupancy query")
    keys = ("threads", "blocks_per_sm", "registers", "local_bytes")
    return {"bounded": dict(zip(keys, out[:4])),
            "banked": dict(zip(keys, out[4:]))}


def _workspace(device: torch.device, stream: int, scratch_bytes: int,
               tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scratch of the tile partials and the ticket words of launches
    on ``stream``, grown to the sizes given.  The scratch is rewritten by
    every launch; the tickets are allocated zero and every launch leaves
    them zero, so one set serves every launch on the stream (launches on
    one stream never overlap)."""
    key = (device.index, stream)
    scratch, words = _workspaces.get(key, (None, None))
    if scratch is None or scratch.numel() < scratch_bytes:
        scratch = torch.empty(max(scratch_bytes, 8), dtype=torch.uint8,
                              device=device)
    if words is None or words.numel() < tickets:
        words = torch.zeros(tickets, dtype=torch.int32, device=device)
    _workspaces[key] = (scratch, words)
    return scratch, words


def lane_params(dp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's (L, K) float32 parameter array from per-lane data
    params (``(L,)`` leaves), columns in ``ref.EPILOGUE_PARAMS`` order."""
    return torch.stack([dp[k] for k in EPILOGUE_PARAMS], dim=1).contiguous()


def flag_tables(flags: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The (L, M) mechanism tables the plain epilogue reads, from the
    flag words (``lru_scan.mech_flags``)."""
    mt = {key: (flags & bit) != 0 for key, bit in (
        ("ideal", FLAG_IDEAL), ("huge", FLAG_HUGE), ("bypass", FLAG_BYPASS),
        ("segment", FLAG_SEGMENT), ("cache_tlb", FLAG_CACHE_TLB),
        ("colocate", FLAG_COLOCATE), ("parallel", FLAG_PARALLEL))}
    mt["n_pte"] = (flags >> FLAG_N_PTE_SHIFT) & 7
    return mt


def sim_epilogue(packed: torch.Tensor, work: torch.Tensor,
                 is4k: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
                 flags: torch.Tensor, params: torch.Tensor,
                 clock: torch.Tensor, mem_accs: torch.Tensor,
                 counters: Dict[str, torch.Tensor], *, n_hier: int,
                 has_ctlb: bool, pte: Optional[torch.Tensor] = None,
                 vpn: Optional[torch.Tensor] = None,
                 off: Optional[torch.Tensor] = None,
                 lines_per_row: int = 0) -> None:
    """One chunk's timing, added into the state in place.

    packed: (T, L, M) int32 hit bits; work: (T, L) float32; is4k, valid:
    (T, L) bool; q: (B, M) float32 queue delay; flags: (L, M) int32;
    params: (L, K) float32 (``lane_params``); clock and each of
    ``counters`` (``ref.COUNTERS``): (B, M, C) float32; mem_accs: (B, M)
    float32; L = B * C.  Banked memory: q and mem_accs are (B, M, banks),
    and the five sites' lines are ``pte`` (T, L, M, 4) int32 (the scan's
    walk lines) and the data line ``vpn * 64 + off`` ((T, L) int32),
    banks of ``lines_per_row`` lines.  CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    args = (packed, work, is4k, valid, q, flags, params, clock, mem_accs,
            counters, n_hier, has_ctlb, pte, vpn, off, lines_per_row)
    if packed.device.type == "cpu":
        _check(*args)
        _plain(*args)
        return
    if packed.device.type != "cuda":
        raise ValueError(f"no sim_epilogue for device {packed.device}")
    global launches
    _launch(*args)
    launches += 1


def _check(packed, work, is4k, valid, q, flags, params, clock, mem_accs,
           counters, n_hier, has_ctlb=False, pte=None, vpn=None, off=None,
           lines_per_row=0) -> None:
    if packed.dim() != 3 or clock.dim() != 3:
        raise ValueError(f"packed must be (T, L, M) and clock (B, M, C), got "
                         f"{tuple(packed.shape)} and {tuple(clock.shape)}")
    t_len, n_lanes, m = packed.shape
    b, _, c = clock.shape
    if b * c != n_lanes:
        raise ValueError(f"clock {tuple(clock.shape)} does not match "
                         f"{n_lanes} lanes")
    if c > MAX_CORES:
        raise ValueError(f"{c} cores a simulation; the kernel takes at most "
                         f"{MAX_CORES}")
    if n_hier not in (1, 3):
        raise ValueError(f"n_hier must be 1 or 3, got {n_hier}")
    if sorted(counters) != sorted(COUNTERS):
        raise ValueError(f"counters must be {COUNTERS}, got "
                         f"{tuple(counters)}")
    banks = () if q.dim() == 2 else tuple(q.shape[2:])
    want = {"packed": (packed, torch.int32, (t_len, n_lanes, m)),
            "work": (work, torch.float32, (t_len, n_lanes)),
            "is4k": (is4k, torch.bool, (t_len, n_lanes)),
            "valid": (valid, torch.bool, (t_len, n_lanes)),
            "q": (q, torch.float32, (b, m) + banks),
            "flags": (flags, torch.int32, (n_lanes, m)),
            "params": (params, torch.float32,
                       (n_lanes, len(EPILOGUE_PARAMS))),
            "clock": (clock, torch.float32, (b, m, c)),
            "mem_accs": (mem_accs, torch.float32, (b, m) + banks)}
    if banks:
        if len(banks) != 1 or not 1 <= banks[0] <= MAX_BANKS:
            raise ValueError(f"q must be (B, M) or (B, M, banks) with 1 to "
                             f"{MAX_BANKS} banks, got {tuple(q.shape)}")
        if pte is None or vpn is None or off is None or lines_per_row < 1:
            raise ValueError("banked memory needs pte, vpn, off and "
                             "lines_per_row >= 1")
        want.update(pte=(pte, torch.int32, (t_len, n_lanes, m, 4)),
                    vpn=(vpn, torch.int32, (t_len, n_lanes)),
                    off=(off, torch.int32, (t_len, n_lanes)))
    elif pte is not None:
        raise ValueError("pte is given, but q has no bank axis")
    for k, v in counters.items():
        want["counters." + k] = (v, torch.float32, (b, m, c))
    for name, (t, dtype, shape) in want.items():
        if t.device != packed.device:
            raise ValueError(f"{name} is on {t.device}, packed on "
                             f"{packed.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _plain(packed, work, is4k, valid, q, flags, params, clock, mem_accs,
           counters, n_hier, has_ctlb, pte=None, vpn=None, off=None,
           lines_per_row=0) -> None:
    b, _, c = clock.shape
    dp = {k: params[:, i] for i, k in enumerate(EPILOGUE_PARAMS)}
    # per lane: (M, B*C), banked (M, B*C, banks)
    q_lane = torch.repeat_interleave(q.transpose(0, 1), c, dim=1)
    lines = None
    if q.dim() == 3:          # the five sites' lines, (T, M, L, 5)
        pm = pte.transpose(1, 2)
        data = (vpn * 64 + off)[:, None, :, None].expand(pm.shape[:-1]
                                                         + (1,))
        lines = torch.cat([pm, data], -1)
    # the plain version works in (T, M, L)
    cnt, cyc, mem_n = ref.sim_epilogue_ref(
        packed.transpose(1, 2), work, is4k, valid, q_lane, flag_tables(flags),
        dp, n_hier, has_ctlb, lines, lines_per_row)

    def unfuse(a):                    # (M, B*C, ...) -> (B, M, C, ...)
        return a.reshape((a.shape[0], b, c) + a.shape[2:]).transpose(0, 1)

    clock += unfuse(cyc)
    mem_accs += unfuse(mem_n).sum(dim=2)
    for k, v in cnt.items():
        counters[k] += unfuse(v)


def _launch(packed, work, is4k, valid, q, flags, params, clock, mem_accs,
            counters, n_hier, has_ctlb, pte=None, vpn=None, off=None,
            lines_per_row=0) -> None:
    """Launch the kernel on checked operands; counts nothing
    (``chip_smoke.py`` times the kernel through it)."""
    _check(packed, work, is4k, valid, q, flags, params, clock, mem_accs,
           counters, n_hier, has_ctlb, pte, vpn, off, lines_per_row)
    t_len, n_lanes, m = packed.shape
    b, _, c = clock.shape
    lib = _lib()
    if pte is not None and pte.data_ptr() % 16:
        raise ValueError("pte must be 16-byte aligned")
    outs = [counters[k] for k in COUNTERS] + [clock, mem_accs]
    out_p = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    banked = q.dim() == 3
    banks = q.shape[2] if banked else 0
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    geo = geometry(packed.device.index, t_len, b, c, m, banks)
    scratch, tickets = _workspace(packed.device, stream,
                                  geo["scratch_bytes"], geo["tickets"])

    def ptr(t):
        return t.data_ptr() if banked else None

    _raise(lib.sim_epilogue_launch(
        packed.device.index, packed.data_ptr(), work.data_ptr(),
        is4k.data_ptr(), valid.data_ptr(), q.data_ptr(), flags.data_ptr(),
        params.data_ptr(), ptr(pte), ptr(vpn), ptr(off), out_p,
        scratch.data_ptr(), scratch.numel(), tickets.data_ptr(),
        tickets.numel(), t_len, b, c, m, n_hier, int(has_ctlb), banks,
        lines_per_row if banked else 0, stream), "kernel launch")
