"""Public kernel entry points, dispatched by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version.  There is no switch that
sends a CUDA tensor to the plain version, so models/ and serving/ call
one API and the card always runs the kernel.  A fake tensor
(``util.device.is_fake``: a shape and a dtype, no storage), on either
device, goes to the kernel's wrapper, whose shape-only route launches
nothing and records the kernel's operation count, so a step on fake
tensors counts the work the card's kernels do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.selective_scan import SelectiveScan
from repro_torch.kernels.selective_scan import check as _scan_check
from repro_torch.kernels.wkv import WKV
from repro_torch.kernels.wkv import check as _wkv_check
from repro_torch.util.device import is_fake


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    valid_lens: torch.Tensor, *, window: int = 0
                    ) -> torch.Tensor:
    """Decode attention over paged KV (see kernels/paged_attention.py)."""
    if q.device.type == "cuda" or is_fake(q):
        return paged_attention_cuda(q, k_pages, v_pages, block_table,
                                    valid_lens, window=window)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                       valid_lens, window=window)
    raise ValueError(f"no paged_attention for device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Differentiable self-attention q (B, S, H, D), k/v (B, S, KH, D)
    (see kernels/flash_attention.py).  On the card the forward and the
    backward are CUDA kernels; on the CPU autograd differentiates the
    plain version."""
    if q.device.type == "cuda" or is_fake(q):
        return FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash_attention for device {q.device}")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Differentiable selective scan: y (B, S, D) float32 from x (B, S,
    D), dt (B, S, D), b, c (B, S, N) and a (D, N) (see
    kernels/selective_scan.py).  On the card the forward and the
    backward are CUDA kernels; on the CPU autograd differentiates the
    plain version."""
    if x.device.type == "cuda" or is_fake(x):
        return SelectiveScan.apply(x, dt, b, c, a)
    if x.device.type == "cpu":
        _scan_check(x, dt, b, c, a)
        return ref.selective_scan_ref(x, dt, b, c, a)
    raise ValueError(f"no selective_scan for device {x.device}")


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor) -> torch.Tensor:
    """Differentiable WKV recurrence (RWKV6): o (B, S, H hs) float32 from
    r, k, v, w (B, S, H hs) and u (H, hs), all float32 (see
    kernels/wkv.py).  On the card the forward and the backward are CUDA
    kernels; on the CPU autograd differentiates the plain version."""
    if r.device.type == "cuda" or is_fake(r):
        return WKV.apply(r, k, v, w, u)
    if r.device.type == "cpu":
        _wkv_check(r, k, v, w, u)
        return ref.wkv_ref(r, k, v, w, u)
    raise ValueError(f"no wkv for device {r.device}")
