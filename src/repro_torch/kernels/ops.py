"""Public kernel entry points, dispatched by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version.  There is no switch that
sends a CUDA tensor to the plain version, so models/ and serving/ call
one API and the card always runs the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.paged_attention import paged_attention_cuda


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    valid_lens: torch.Tensor, *, window: int = 0
                    ) -> torch.Tensor:
    """Decode attention over paged KV (see kernels/paged_attention.py)."""
    if q.device.type == "cuda":
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
    if q.device.type == "cuda":
        return FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash_attention for device {q.device}")
