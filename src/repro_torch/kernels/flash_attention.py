"""Wrapper of the hand-written CUDA flash-attention kernels, forward and
backward.

The kernels replace the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``; the backward
replaces XLA's autodiff of ``repro.models.attention.blockwise_attention``.
Four routes, picked by :func:`_route` from the dtype and head_dim, all
on the tensor cores: ``"sm90"`` (``csrc/flash_attention_sm90.cu``: bf16,
head_dim 64 or 128, TMA loads and ``wgmma`` products), ``"d256"`` and
``"d192"`` (``csrc/flash_attention_d256.cu``, one template on head_dim
instantiated at 256 and 192: bf16, TMA loads and ``wgmma`` products,
sharing ``csrc/sm90_common.cuh`` with the sm90 route) and ``"simt"``
(``csrc/flash_attention.cu``: float32, every head_dim up to 256, padded
to 32, 64, 128, 192 or 256 inside the kernel, every product of the
forward and backward an ``mma.sync`` in 3xTF32, which keeps float32
accuracy; the name is kept from the CUDA-core kernels it replaced).
Nothing else has a kernel: bf16 at other head dims and any dtype above
head_dim 256 raise, with no fallback.  This module checks the operands,
allocates the outputs and scratch, launches on PyTorch's current stream
and counts launches in
:data:`launches_fwd` (one per forward) and :data:`launches_bwd` (one per
backward, which runs a delta pre-pass, the dK/dV kernel, the reduction
of its partials where :func:`d256_bwd_plan` (d256 / d192) or
:func:`simt_bwd_plan` (float32 above head_dim 128) splits it, and the
dQ kernel), the totals of all routes, and per route in :data:`launches_sm90_fwd` /
:data:`launches_sm90_bwd`, :data:`launches_d256_fwd` /
:data:`launches_d256_bwd` and :data:`launches_d192_fwd` /
:data:`launches_d192_bwd`.  :class:`FlashAttention` ties the two
together for autograd and saves q, k, v, the output and its log-sum-exp:
the score blocks are never stored, the memory discipline that
``jax.checkpoint`` gives the JAX side.  It takes CUDA tensors only;
``kernels.ops.flash_attention`` sends CPU tensors to the plain version
in ``kernels.ref``.  Fake tensors (``util.device.is_fake``: a shape and
a dtype, no storage, on any device) take a shape-only route: the
operands are checked and the route picked as for a launch, nothing
launches, the outputs are fake tensors of the kernel's shapes and dtypes
and no launch is counted.  A launch and a fake call alike add the call's
``roofline.counts.flash_flops`` (4 D an attended pair and head forward,
10 D backward) to the open ``roofline.counts`` recordings, as
``flash_attention_<route>_<fwd|bwd>``.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import counts
from repro_torch.util.device import is_fake

#: kernel launches since the counters were last reset: all routes, then
#: the sm90, d256 and d192 routes alone
launches_fwd = 0
launches_bwd = 0
launches_sm90_fwd = 0
launches_sm90_bwd = 0
launches_d256_fwd = 0
launches_d256_bwd = 0
launches_d192_fwd = 0
launches_d192_bwd = 0

#: the float32 kernels keep a warp's 16 rows of the accumulator in
#: registers, all of head_dim's columns up to 192 (96 a thread) and half
#: of them, a pair of warps sharing the rows, above (64 a thread at 256)
MAX_HEAD_DIM = 256

#: head sizes of the sm90 kernels (templates); the d256 and d192 routes
#: are the two instantiations of one template
SM90_HEAD_DIMS = (64, 128)
D256_HEAD_DIM = 256
D192_HEAD_DIM = 192
#: the library of each bf16 route; its C functions are named
#: ``flash_attention_<library suffix>_*``
_BF16_LIBRARY = {"sm90": "sm90", "d256": "d256", "d192": "d256"}
#: the bf16 backwards' delta / LSE scratch has S rounded up to this
SM90_STATS_ROWS = 128
#: rows of the d256 / d192 backward's key and query tiles
D256_TILE = 64
#: streaming multiprocessors of the H100, one d256 / d192 dK/dV block each
H100_SMS = 132
#: the most ways a key tile's dK/dV work is split
D256_MAX_SPLITS = 4
#: above this head_dim a float32 dK/dV block takes a whole SM, and the
#: backward's plan may split its work in units of (query head, 64-query
#: tile) over its 64-key tiles
SIMT_SPLIT_MIN_HEAD_DIM = 128
SIMT_BWD_TILE = 64
#: above this head_dim a float32 forward block is pairs of warps, each
#: warp half of head_dim, on 128 or 64 query rows (:func:`simt_fwd_plan`);
#: the library states its own (:func:`simt_fwd_tiling`) and refuses rows
#: its instantiation lacks
SIMT_PAIR_MIN_HEAD_DIM = 192
#: the device time of one 16-key step of a 128-row pair block over a
#: 64-row one's, each alone on an SM: 1.65-1.77 at gemma3-1b's calls on
#: the H100 (PERF.md §6)
SIMT_FWD_STEP_COST_128 = 1.75

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}
_lib_handle = None
_bf16_handles: Dict[str, ctypes.CDLL] = {}


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """``"sm90"`` for bf16 with head_dim 64 or 128, ``"d256"`` and
    ``"d192"`` for bf16 with head_dim 256 and 192 (all three wgmma),
    ``"simt"`` (3xTF32) for float32 at every head_dim from 1 to
    :data:`MAX_HEAD_DIM` (256: gemma3-1b's heads, deepseek-v2's MLA head
    of 192); anything else raises."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    if dtype == torch.bfloat16 and head_dim == D256_HEAD_DIM:
        return "d256"
    if dtype == torch.bfloat16 and head_dim == D192_HEAD_DIM:
        return "d192"
    if dtype == torch.float32 and 0 < head_dim <= MAX_HEAD_DIM:
        return "simt"
    raise ValueError(f"no flash_attention kernel for {dtype} with head_dim "
                     f"{head_dim}: bf16 takes "
                     f"{SM90_HEAD_DIMS + (D192_HEAD_DIM, D256_HEAD_DIM)}, "
                     f"float32 up to {MAX_HEAD_DIM}")


def _lib_bf16(route: str) -> ctypes.CDLL:
    """The library of a bf16 route, ``"sm90"``, ``"d256"`` or
    ``"d192"`` (the d256 library): each exports the same C interface,
    named ``flash_attention_<library>_*``, but for the d256 backward's
    partials pointer and split count."""
    name = _BF16_LIBRARY[route]
    if name not in _bf16_handles:
        lib = _build.load(f"flash_attention_{name}")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 7 + [ctypes.c_float]
        bwd = [ptr] * 10 + tail
        if name == "d256":      # the split dK/dV partials and their count
            bwd = [ptr] * 11 + tail + [i32]
        for what, args in (("fwd_launch", [ptr] * 5 + tail),
                           ("bwd_launch", bwd)):
            fn = getattr(lib, f"flash_attention_{name}_{what}")
            fn.argtypes = [i32] + args + [ptr]
            fn.restype = i32
        err = getattr(lib, f"flash_attention_{name}_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _bf16_handles[name] = lib
    return _bf16_handles[name]


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 7 + [ctypes.c_float, i32, ptr]
        lib.flash_attention_fwd_launch.argtypes = (
            [i32] + [ptr] * 5 + tail[:-1] + [i32, ptr])     # + rows
        lib.flash_attention_fwd_launch.restype = i32
        lib.flash_attention_bwd_launch.argtypes = (
            [i32] + [ptr] * 11 + tail[:-1] + [i32, ptr])   # + splits
        lib.flash_attention_bwd_launch.restype = i32
        for design in (lib.flash_attention_fwd_design,
                       lib.flash_attention_bwd_design):
            design.argtypes = []
            design.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_occupancy.argtypes = [i32, i32, ptr]
        lib.flash_attention_occupancy.restype = i32
        lib.flash_attention_fwd_tiling.argtypes = [ptr]
        lib.flash_attention_fwd_tiling.restype = i32
        _lib_handle = lib
    return _lib_handle


def simt_design() -> dict:
    """How the built float32 forward and backward run their products
    (from the library itself)."""
    lib = _lib()
    return {"fwd": lib.flash_attention_fwd_design().decode(),
            "bwd": lib.flash_attention_bwd_design().decode()}


def simt_fwd_tiling() -> dict:
    """The built float32 forward's tiling, from the library itself:
    ``key_step``, the keys of each step (the plain version
    ``ref.flash_attention_tf32x3_ref`` must fold at it), and
    ``pair_min_head_dim``, above which its blocks are pairs of warps
    (:data:`SIMT_PAIR_MIN_HEAD_DIM` here)."""
    out = (ctypes.c_int * 2)()
    _lib().flash_attention_fwd_tiling(out)
    return {"key_step": out[0], "pair_min_head_dim": out[1]}


def simt_occupancy(head_dim: int) -> dict:
    """What the current card makes of the float32 kernels that take
    ``head_dim``: for the forward, dK/dV and dQ kernels, and above
    :data:`SIMT_PAIR_MIN_HEAD_DIM` the forward on 64-row blocks
    (``fwd_rows64``; ``fwd`` is then the 128-row one), threads a block,
    resident blocks an SM, registers a thread, local (spill) bytes a
    thread and dynamic shared memory a block."""
    out = (ctypes.c_int * 20)()
    _raise_on(_lib().flash_attention_occupancy(torch.cuda.current_device(),
                                               head_dim, out),
              "occupancy query", "simt")
    keys = ("threads", "blocks_per_sm", "registers", "local_bytes",
            "smem_bytes")
    names = ("fwd", "dkdv", "dq", "fwd_rows64")
    return {k: dict(zip(keys, out[5 * i:5 * i + 5]))
            for i, k in enumerate(names) if out[5 * i]}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **more: torch.Tensor) -> None:
    """q (and o, do): (B, S, H, D); k, v: (B, S, KH, D); one dtype, one
    CUDA device (any device for fake tensors), contiguous."""
    for name, t in dict(q=q, k=k, v=v, **more).items():
        if t.device.type != "cuda" and not is_fake(t):
            raise ValueError(f"{name} is on {t.device}; the CUDA kernel "
                             "takes CUDA tensors")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_TAG:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_TAG)}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, D) and k, v (B, S, KH, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[:2] != (b, s) or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    _route(q.dtype, d)
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}")


def _entry(route: str, what: str):
    """The C function ``what`` (``fwd_launch``, ``bwd_launch``,
    ``error_string``) of ``route``'s library."""
    lib = _lib() if route == "simt" else _lib_bf16(route)
    prefix = "" if route == "simt" else f"_{_BF16_LIBRARY[route]}"
    return getattr(lib, f"flash_attention{prefix}_{what}")


def _raise_on(err: int, what: str, route: str) -> None:
    if err != 0:
        msg = _entry(route, "error_string")(err).decode()
        raise RuntimeError(f"flash_attention {route} {what} kernel launch "
                           f"failed: CUDA error {err} ({msg})")


def _dims(q, k, causal: bool, window: int, *more: int):
    """The launch's integer tail: shape, masks, scale, then ``more``
    (simt: the dtype tag, then the forward's rows a block or the
    backward's split count; the d256 backward: its split count) and the
    stream."""
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, int(bool(causal)), int(window),
            1.0 / math.sqrt(d), *more,
            torch.cuda.current_stream(q.device).cuda_stream)


def bwd_split_plan(b: int, s: int, h: int, kh: int, *, causal: bool,
                   window: int, tile: int) -> int:
    """How many ways a dK/dV kernel that runs a block per (``tile``-key
    tile, kv head, b) splits each block's work, for q (b, s, h, .) and k,
    v (b, s, kh, .) under the mask.

    Each block walks the (query head, ``tile``-row query tile) steps that
    reach its keys: G = h / kh heads times the tiles from its own (causal)
    or the first to the window's end.  Blocks take an SM each, longest
    first, so the kernel lasts about as long as the longest block or an
    SM's share of all steps, whichever is more.  Where the longest block
    walks more than twice that share (a causal mask over few blocks:
    gemma3-1b's global layer), each block's steps are cut into that many
    contiguous chunks, one block each (at most :data:`D256_MAX_SPLITS`; G
    need not divide them), writing float32 partial dK and dV that a
    reduction pass sums in split order."""
    steps = []
    for k0 in range(0, s, tile):
        lo = k0 if causal else 0
        hi = min(s, k0 + tile - 1 + window) if window > 0 else s
        steps.append(h // kh * -(-(hi - lo) // tile))
    share = b * kh * sum(steps) / H100_SMS
    return min(D256_MAX_SPLITS, max(1, math.ceil(max(steps) / (2 * share))))


def d256_bwd_plan(b: int, s: int, h: int, kh: int, d: int, *,
                  causal: bool = True, window: int = 0) -> dict:
    """The d256 / d192 backward's launch and scratch plan for q (b, s, h,
    d) and k, v (b, s, kh, d) under the mask: ``splits`` of the dK/dV
    kernel's 64-key tiles (:func:`bwd_split_plan` at :data:`D256_TILE`),
    the shape of the ``stats`` scratch (delta and LSE x log2(e), S rounded
    up to :data:`SM90_STATS_ROWS`) and of the ``partials`` scratch (dK's,
    then dV's), None when ``splits`` is 1.
    """
    splits = bwd_split_plan(b, s, h, kh, causal=causal, window=window,
                            tile=D256_TILE)
    rows = -(-s // SM90_STATS_ROWS) * SM90_STATS_ROWS
    return {"splits": splits, "stats": (2, b, h, rows),
            "partials": (2, splits, b, s, kh, d) if splits > 1 else None}


def simt_bwd_plan(b: int, s: int, h: int, kh: int, d: int, *,
                  causal: bool = True, window: int = 0) -> dict:
    """The float32 (simt) backward's launch and scratch plan: the
    ``stats`` scratch (delta = rowsum(dO * O), (B, H, S)) at every
    head_dim, and above head_dim 128 the dK/dV kernel's split
    (:func:`bwd_split_plan` over its :data:`SIMT_BWD_TILE`-key tiles and
    64-query units) with the shape of its ``partials`` scratch (2, splits,
    B, S, KH, D), None when ``splits`` is 1 (always at head_dim 128 and
    below, where two dK/dV blocks share an SM)."""
    splits = 1
    if d > SIMT_SPLIT_MIN_HEAD_DIM:
        splits = bwd_split_plan(b, s, h, kh, causal=causal, window=window,
                                tile=SIMT_BWD_TILE)
    return {"splits": splits, "stats": (b, h, s),
            "partials": (2, splits, b, s, kh, d) if splits > 1 else None}


def simt_fwd_plan(b: int, s: int, h: int, d: int, *, causal: bool = True,
                  window: int = 0) -> int:
    """Query rows a float32 (simt) forward block owns for q (b, s, h, d)
    under the mask: 64 up to head_dim :data:`SIMT_PAIR_MIN_HEAD_DIM` (4
    warps); above it 128 (8 pairs of warps) or 64 (4 pairs), whichever
    the card should finish first.  Each block is alone on an SM, so the
    estimate schedules the blocks' 16-key steps (from the mask) longest
    first onto :data:`H100_SMS` SMs, each SM taking the next block when
    its last ends, and prices a 128-row step at
    :data:`SIMT_FWD_STEP_COST_128` 64-row ones.  The 128-row step does
    more work a step for its time, but a causal mask over few blocks
    (gemma3-1b's global layer at one sequence: 128 blocks of 128 rows for
    132 SMs) leaves its longest block the whole time: 64 rows there."""
    if d <= SIMT_PAIR_MIN_HEAD_DIM:
        return 64
    return _simt_fwd_rows(b * h, s, bool(causal), int(window))


@functools.lru_cache(maxsize=64)
def _simt_fwd_rows(heads: int, s: int, causal: bool, window: int) -> int:
    cost = {}
    for rows, step_cost in ((128, SIMT_FWD_STEP_COST_128), (64, 1.0)):
        steps = []
        for q0 in range(0, s, rows):   # the kernel's loop bounds
            lo = max(0, q0 - window + 1) // 16 * 16 if window > 0 else 0
            hi = min(s, q0 + rows) if causal else s
            steps.append(max(0, -(-(hi - lo) // 16)))
        loads = [0] * H100_SMS
        for n in sorted(steps * heads, reverse=True):
            heapq.heapreplace(loads, loads[0] + n)
        cost[rows] = max(loads) * step_cost
    return 128 if cost[128] <= cost[64] else 64


def _record(route: str, direction: str, q: torch.Tensor, causal: bool,
            window: int) -> None:
    b, s, h, d = q.shape
    counts.record(f"flash_attention_{route}_{direction}", counts.flash_flops(
        b, s, h, d, causal, window, direction == "bwd"))


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, S, H, D) in q's dtype, lse (B, H, S) float32)."""
    global launches_fwd, launches_sm90_fwd, launches_d256_fwd, \
        launches_d192_fwd
    _check(q, k, v)
    b, s, h, d = q.shape
    route = _route(q.dtype, d)
    if is_fake(q):
        _record(route, "fwd", q, causal, window)
        return q.new_empty(q.shape), q.new_empty((b, h, s),
                                                 dtype=torch.float32)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    more: tuple = ()
    if route == "simt":     # the dtype tag and the rows of a block
        more = (_DTYPE_TAG[q.dtype],
                simt_fwd_plan(b, s, h, d, causal=causal, window=window))
    err = _entry(route, "fwd_launch")(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *_dims(q, k, causal, window, *more))
    _raise_on(err, "forward", route)
    launches_fwd += 1
    if route == "sm90":
        launches_sm90_fwd += 1
    elif route == "d256":
        launches_d256_fwd += 1
    elif route == "d192":
        launches_d192_fwd += 1
    _record(route, "fwd", q, causal, window)
    return out, lse


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0
                             ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) for the cotangent ``do`` of the output ``o``."""
    global launches_bwd, launches_sm90_bwd, launches_d256_bwd, \
        launches_d192_bwd
    _check(q, k, v, o=o, do=do)
    b, s, h, d = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (b, h, s)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 ({b}, {h}, {s}) "
                         f"on {q.device}")
    route = _route(q.dtype, d)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if is_fake(q):
        _record(route, "bwd", q, causal, window)
        return dq, dk, dv
    f32 = dict(dtype=torch.float32, device=q.device)
    more: tuple = ()
    if route == "sm90":     # delta and LSE x log2(e), S rounded up
        rows = -(-s // SM90_STATS_ROWS) * SM90_STATS_ROWS
        scratch = [torch.empty((2, b, h, rows), **f32)]
    else:   # simt: delta = rowsum(dO * O); d256 / d192: delta and LSE;
            # each with the split dK/dV partials where its plan splits
        plan = (simt_bwd_plan if route == "simt" else d256_bwd_plan)(
            b, s, h, k.shape[2], d, causal=causal, window=window)
        scratch = [torch.empty(plan["stats"], **f32), None]
        if plan["partials"] is not None:
            scratch[1] = torch.empty(plan["partials"], **f32)
        more = ((_DTYPE_TAG[q.dtype], plan["splits"]) if route == "simt"
                else (plan["splits"],))
    ptrs = [None if t is None else t.data_ptr()
            for t in (q, k, v, o, lse, do, dq, dk, dv, *scratch)]
    err = _entry(route, "bwd_launch")(
        q.device.index, *ptrs, *_dims(q, k, causal, window, *more))
    _raise_on(err, "backward", route)
    launches_bwd += 1
    if route == "sm90":
        launches_sm90_bwd += 1
    elif route == "d256":
        launches_d256_bwd += 1
    elif route == "d192":
        launches_d192_bwd += 1
    _record(route, "bwd", q, causal, window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention whose forward and backward are the CUDA kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd_cuda(q, k, v, causal=causal,
                                            window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None
