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
once, about 1.8 MB for a 1,024-step chunk of the ``ndp_machine(8)``
bucket, 0.6 us at 3.35 TB/s.  Design: a block per (simulation,
mechanism) whose 256 threads split the steps among the simulation's
lanes; partial sums in float64, folded in a fixed order, rounded once and
added by one thread per state element, so no atomics on the floats.
Banked (a ``BANKED`` instantiation): the five sites' lines come from the
walk lines the scan read (``pte``) and ``vpn * 64 + off``, the block's
queue delays per bank sit in shared memory, and the per-bank access
counts are integers, added with shared-memory atomics (exact in any
order).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import (COUNTERS, EPILOGUE_PARAMS, FLAG_BYPASS,
                                     FLAG_CACHE_TLB, FLAG_COLOCATE,
                                     FLAG_HUGE, FLAG_IDEAL, FLAG_N_PTE_SHIFT,
                                     FLAG_PARALLEL, FLAG_SEGMENT)

#: number of kernel launches since the counter was last reset
launches = 0

#: the most lanes a simulation may have (one block's threads), and the
#: most banks of a banked memory
MAX_CORES = 256
MAX_BANKS = 64

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("sim_epilogue")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sim_epilogue_launch.argtypes = (
            [i32] + [ptr] * 10 + [ctypes.POINTER(ptr)] + [i32] * 8
            + [ptr])
        lib.sim_epilogue_launch.restype = i32
        lib.sim_epilogue_error_string.argtypes = [i32]
        lib.sim_epilogue_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


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

    def ptr(t):
        return t.data_ptr() if banked else None

    err = lib.sim_epilogue_launch(
        packed.device.index, packed.data_ptr(), work.data_ptr(),
        is4k.data_ptr(), valid.data_ptr(), q.data_ptr(), flags.data_ptr(),
        params.data_ptr(), ptr(pte), ptr(vpn), ptr(off), out_p, t_len, b, c,
        m, n_hier, int(has_ctlb), q.shape[2] if banked else 0,
        lines_per_row if banked else 0,
        torch.cuda.current_stream(packed.device).cuda_stream)
    if err != 0:
        msg = lib.sim_epilogue_error_string(err).decode()
        raise RuntimeError(f"sim_epilogue kernel launch failed: CUDA error "
                           f"{err} ({msg})")
