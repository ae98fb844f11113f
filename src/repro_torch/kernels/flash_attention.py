"""Wrapper of the hand-written CUDA flash-attention kernels, forward and
backward.

The kernels replace the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``; the backward
replaces XLA's autodiff of ``repro.models.attention.blockwise_attention``.
Two routes, picked by :func:`_route` from the dtype and head_dim, both
on the tensor cores: ``"sm90"`` (``csrc/flash_attention_sm90.cu``: bf16,
head_dim 64 or 128, TMA loads and ``wgmma`` products) and ``"simt"``
(``csrc/flash_attention.cu``: float32, head_dim up to 128, every product
of the forward and backward an ``mma.sync`` in 3xTF32, which keeps
float32 accuracy; the name is kept from the CUDA-core kernels it
replaced).  This module checks the operands, allocates the outputs and
scratch, launches on PyTorch's current stream and counts launches in
:data:`launches_fwd` (one per forward) and :data:`launches_bwd` (one per
backward, which runs a delta pre-pass, the dK/dV and the dQ kernel), the
totals of both routes, and per route in :data:`launches_sm90_fwd` /
:data:`launches_sm90_bwd`.  :class:`FlashAttention` ties the two
together for autograd and saves q, k, v, the output and its log-sum-exp:
the score blocks are never stored, the memory discipline that
``jax.checkpoint`` gives the JAX side.  It takes CUDA tensors only;
``kernels.ops.flash_attention`` sends CPU tensors to the plain version
in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches since the counters were last reset: both routes, then
#: the sm90 route alone
launches_fwd = 0
launches_bwd = 0
launches_sm90_fwd = 0
launches_sm90_bwd = 0

#: the kernels keep a head's row of the accumulator in registers
MAX_HEAD_DIM = 128

#: head sizes of the sm90 kernels (templates)
SM90_HEAD_DIMS = (64, 128)
#: the sm90 backward's delta / LSE scratch has S rounded up to this
SM90_STATS_ROWS = 128

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}
_lib_handle = None
_lib_sm90_handle = None


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """``"sm90"`` (wgmma) for bf16 with head_dim 64 or 128, ``"simt"``
    (3xTF32 mma.sync) for float32 with head_dim up to 128; anything else
    raises."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    if dtype == torch.float32 and 0 < head_dim <= MAX_HEAD_DIM:
        return "simt"
    raise ValueError(f"no flash_attention kernel for {dtype} with head_dim "
                     f"{head_dim}: bf16 takes {SM90_HEAD_DIMS}, float32 up "
                     f"to {MAX_HEAD_DIM}")


def _lib_sm90() -> ctypes.CDLL:
    global _lib_sm90_handle
    if _lib_sm90_handle is None:
        lib = _build.load("flash_attention_sm90")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 7 + [ctypes.c_float, ptr]
        lib.flash_attention_sm90_fwd_launch.argtypes = ([i32] + [ptr] * 5
                                                        + tail)
        lib.flash_attention_sm90_fwd_launch.restype = i32
        lib.flash_attention_sm90_bwd_launch.argtypes = ([i32] + [ptr] * 10
                                                        + tail)
        lib.flash_attention_sm90_bwd_launch.restype = i32
        lib.flash_attention_sm90_error_string.argtypes = [i32]
        lib.flash_attention_sm90_error_string.restype = ctypes.c_char_p
        _lib_sm90_handle = lib
    return _lib_sm90_handle


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 7 + [ctypes.c_float, i32, ptr]
        lib.flash_attention_fwd_launch.argtypes = [i32] + [ptr] * 5 + tail
        lib.flash_attention_fwd_launch.restype = i32
        lib.flash_attention_bwd_launch.argtypes = [i32] + [ptr] * 10 + tail
        lib.flash_attention_bwd_launch.restype = i32
        for design in (lib.flash_attention_fwd_design,
                       lib.flash_attention_bwd_design):
            design.argtypes = []
            design.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def simt_design() -> dict:
    """How the built float32 forward and backward run their products
    (from the library itself)."""
    lib = _lib()
    return {"fwd": lib.flash_attention_fwd_design().decode(),
            "bwd": lib.flash_attention_bwd_design().decode()}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **more: torch.Tensor) -> None:
    """q (and o, do): (B, S, H, D); k, v: (B, S, KH, D); one dtype, one
    CUDA device, contiguous."""
    for name, t in dict(q=q, k=k, v=v, **more).items():
        if t.device.type != "cuda":
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
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}")


def _raise_on(err: int, what: str, route: str) -> None:
    if err != 0:
        msg = (_lib_sm90().flash_attention_sm90_error_string(err)
               if route == "sm90" else
               _lib().flash_attention_error_string(err)).decode()
        raise RuntimeError(f"flash_attention {route} {what} kernel launch "
                           f"failed: CUDA error {err} ({msg})")


def _dims(q, k, causal: bool, window: int, route: str):
    b, s, h, d = q.shape
    dtype = () if route == "sm90" else (_DTYPE_TAG[q.dtype],)
    return (b, s, h, k.shape[2], d, int(bool(causal)), int(window),
            1.0 / math.sqrt(d), *dtype,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, S, H, D) in q's dtype, lse (B, H, S) float32)."""
    global launches_fwd, launches_sm90_fwd
    _check(q, k, v)
    b, s, h, d = q.shape
    route = _route(q.dtype, d)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    launch = (_lib_sm90().flash_attention_sm90_fwd_launch if route == "sm90"
              else _lib().flash_attention_fwd_launch)
    err = launch(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), lse.data_ptr(),
                 *_dims(q, k, causal, window, route))
    _raise_on(err, "forward", route)
    launches_fwd += 1
    if route == "sm90":
        launches_sm90_fwd += 1
    return out, lse


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0
                             ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) for the cotangent ``do`` of the output ``o``."""
    global launches_bwd, launches_sm90_bwd
    _check(q, k, v, o=o, do=do)
    b, s, h, d = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (b, h, s)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 ({b}, {h}, {s}) "
                         f"on {q.device}")
    route = _route(q.dtype, d)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ptrs = [t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv)]
    if route == "sm90":
        rows = -(-s // SM90_STATS_ROWS) * SM90_STATS_ROWS
        stats = torch.empty((2, b, h, rows), dtype=torch.float32,
                            device=q.device)
        err = _lib_sm90().flash_attention_sm90_bwd_launch(
            q.device.index, *ptrs, stats.data_ptr(),
            *_dims(q, k, causal, window, route))
    else:
        # delta = rowsum(dO * O), written by the pre-pass
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        err = _lib().flash_attention_bwd_launch(
            q.device.index, *ptrs, delta.data_ptr(),
            *_dims(q, k, causal, window, route))
    _raise_on(err, "backward", route)
    launches_bwd += 1
    if route == "sm90":
        launches_sm90_bwd += 1
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
