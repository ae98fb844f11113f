"""Wrapper of the hand-written CUDA paged-attention decode kernel.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_attention_pallas``.  This module
checks the operands, picks the split size (:func:`split_plan`),
allocates the output and the float32 partials, launches the kernel's
split pass and, with more than one split, its combine pass on PyTorch's
current stream, and counts calls in :data:`launches` (one per call,
whatever the number of CUDA launches inside).  It takes CUDA tensors
only; ``kernels.ops.paged_attention`` sends CPU tensors to the plain
version in ``kernels.ref``, and ``ref.paged_attention_split_ref`` is the
plain form of the split-K algorithm.  Fake tensors
(``util.device.is_fake``, on any device) take a shape-only route: the
operands are checked as for a launch (but for the alignment of storage
they lack), nothing launches and no launch is counted, and the output
is a fake tensor of q's shape and dtype.

A call, launched or fake, adds ``roofline.counts.paged_flops`` to the
open ``roofline.counts`` recordings as ``paged_attention``, counted at
the state's capacity (``counts.paged_capacity``: every page of every
row of the block table, or the window where it is shorter), not at the
attended tokens: those follow from ``lengths``, which a fake tensor
lacks and which the host would have to read back from the card.  So a
real call and a fake one on the same shapes record the same count.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import counts
from repro_torch.util.device import is_fake

#: number of kernel launches since the counter was last reset
launches = 0

#: pages a split owns at most (the kernel's MAX_PPS), and the split size
#: tried first
MAX_PAGES_PER_SPLIT = 8
PAGES_PER_SPLIT = 4
#: split blocks the host aims for: two waves of the H100's 132 SMs
TARGET_BLOCKS = 2 * 132
#: dynamic shared memory a block may opt in to on the H100 (227 KB)
MAX_SMEM_BYTES = 232_448

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("paged_attention")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.paged_attention_launch.argtypes = (
            [i32] + [ptr] * 7 + [i64] * 11 + [i32] * 9
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
        if t.device.type != "cuda" and not is_fake(t):
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
    if is_fake(q):
        return
    # K/V rows are copied in 16-byte pieces
    item = k_pages.element_size()
    strides = k_pages.stride()[:3] + v_pages.stride()[:3]
    if (any(s * item % 16 for s in strides) or d * item % 16
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16):
        raise ValueError("K/V pools must be 16-byte aligned, with head_dim "
                         "and strides a multiple of 16 bytes")


def split_smem_bytes(group: int, head_dim: int, page: int, itemsize: int,
                     pages_per_split: int) -> int:
    """Dynamic shared memory of one split block (``paged_attention.cu``
    ``launch``): float32 q (G, D), p (G, tokens), m and l (G), rounded
    up to 16 bytes, then the K and V pages of the split."""
    tokens = pages_per_split * page
    float_words = (group * head_dim + group * tokens + 2 * group + 3) & ~3
    return 4 * float_words + 2 * itemsize * tokens * head_dim


def max_pages_per_split(group: int, head_dim: int, page: int,
                        itemsize: int) -> int:
    """The most pages a split may own whose block fits the card's shared
    memory (0 if not even one page does), at most
    :data:`MAX_PAGES_PER_SPLIT`."""
    pps = MAX_PAGES_PER_SPLIT
    while pps and split_smem_bytes(group, head_dim, page, itemsize,
                                   pps) > MAX_SMEM_BYTES:
        pps -= 1
    return pps


def split_plan(batch: int, kv_heads: int, max_pages: int,
               max_pps: int = MAX_PAGES_PER_SPLIT) -> tuple:
    """(pages_per_split, n_splits, blocks of the split pass) for a call.

    Only shapes decide it, never ``lengths`` (the host cannot read them
    without a sync): start from :data:`PAGES_PER_SPLIT` pages, or
    ``max_pps`` (:func:`max_pages_per_split`: what the block's shared
    memory allows) if fewer, and halve while the split pass would launch
    fewer than :data:`TARGET_BLOCKS` blocks.  With more than one split
    the combine pass adds B * H blocks."""
    if max_pps < 1:
        raise ValueError("not even one page a split fits the card's "
                         f"{MAX_SMEM_BYTES} bytes of shared memory")
    pps = min(PAGES_PER_SPLIT, max_pps)
    while pps > 1 and batch * kv_heads * -(-max_pages // pps) < TARGET_BLOCKS:
        pps //= 2
    n_splits = -(-max_pages // pps)
    return pps, n_splits, batch * kv_heads * n_splits


def call_plan(q: torch.Tensor, k_pages: torch.Tensor,
              block_table: torch.Tensor) -> tuple:
    """:func:`split_plan` for the operands of a call."""
    b, _, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    return split_plan(b, kh, block_table.shape[1], max_pages_per_split(
        h // kh, d, page, k_pages.element_size()))


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
    pps, _, _ = call_plan(q, k_pages, block_table)
    if is_fake(q):
        out = torch.empty_like(q)
    else:
        out = _launch(q, k_pages, v_pages, block_table, lengths, window,
                      pps)
        launches += 1
    b, _, h, d = q.shape
    counts.record("paged_attention", counts.paged_flops(
        counts.paged_capacity(b, block_table.shape[1], k_pages.shape[1],
                              window), h, d))
    return out


def _launch(q, k_pages, v_pages, block_table, lengths, window: int,
            pages_per_split: int) -> torch.Tensor:
    """Both passes at a given split size, on checked operands; counts
    nothing (``chip_smoke.py`` times other split sizes through it)."""
    if not 1 <= pages_per_split <= MAX_PAGES_PER_SPLIT:
        raise ValueError(f"pages_per_split {pages_per_split} not in "
                         f"[1, {MAX_PAGES_PER_SPLIT}]")
    b, _, h, d = q.shape
    n, page, kh, _ = k_pages.shape
    maxp = block_table.shape[1]
    n_splits = -(-maxp // pages_per_split)
    out = torch.empty_like(q)
    # m, l (G) and acc (G, D) of every (sequence, kv head, split)
    part = (torch.empty((b, kh, n_splits, (h // kh) * (d + 2)),
                        dtype=torch.float32, device=q.device)
            if n_splits > 1 else None)
    lib = _lib()
    err = lib.paged_attention_launch(
        q.device.index, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        q.stride(0), q.stride(2),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        block_table.stride(0), out.stride(0), out.stride(2),
        b, h, kh, d, page, maxp, n, int(window), pages_per_split,
        1.0 / math.sqrt(d), _DTYPE_TAG[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"CUDA error {err} ({msg})")
    return out
