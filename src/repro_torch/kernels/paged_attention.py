"""Wrapper of the hand-written CUDA paged-attention decode kernel.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_attention_pallas``.  This module
checks the operands, allocates the output, launches the kernel on
PyTorch's current stream and counts launches in :data:`launches`.  It
takes CUDA tensors only; ``kernels.ops.paged_attention`` sends CPU
tensors to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: number of kernel launches since the counter was last reset
launches = 0

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("paged_attention")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.paged_attention_launch.argtypes = (
            [i32] + [ptr] * 6 + [i64] * 11 + [i32] * 8
            + [ctypes.c_float, i32, ptr])
        lib.paged_attention_launch.restype = i32
        lib.paged_attention_error_string.argtypes = [i32]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(q, k_pages, v_pages, block_table, lengths) -> None:
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   block_table=block_table, lengths=lengths)
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the CUDA kernel "
                             "takes CUDA tensors")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if q.dtype not in _DTYPE_TAG:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_TAG)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages must both be (N, page, KH, D)")
    n, page, kh, dk = k_pages.shape
    if dk != d or h % kh != 0:
        raise ValueError(f"head dims disagree: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be (B, MAXP) with B={b}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},)")
    # K/V rows are copied in 16-byte pieces
    item = k_pages.element_size()
    strides = k_pages.stride()[:3] + v_pages.stride()[:3]
    if (any(s * item % 16 for s in strides) or d * item % 16
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16):
        raise ValueError("K/V pools must be 16-byte aligned, with head_dim "
                         "and strides a multiple of 16 bytes")


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, *, window: int = 0
                         ) -> torch.Tensor:
    """q: (B, 1, H, D); k/v_pages: (N, page, KH, D); block_table:
    (B, MAXP) int32 (-1 = unmapped); lengths: (B,) int32 attendable
    tokens.  Returns (B, 1, H, D) in q's dtype.  Raises on any operand
    the kernel does not take and on a refused launch."""
    global launches
    _check(q, k_pages, v_pages, block_table, lengths)
    b, _, h, d = q.shape
    n, page, kh, _ = k_pages.shape
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.paged_attention_launch(
        q.device.index, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(2),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        block_table.stride(0), out.stride(0), out.stride(2),
        b, h, kh, d, page, block_table.shape[1], n, int(window),
        1.0 / math.sqrt(d), _DTYPE_TAG[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"CUDA error {err} ({msg})")
    launches += 1
    return out
