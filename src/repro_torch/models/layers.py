"""Primitive layers: norms, rope, FFNs, and their initializers.

The functions mirror ``repro.models.layers``; parameters live in small
``nn.Module``s whose weights keep the JAX package's ``(d_in, d_out)``
layout, so a layer computes ``x @ w`` on both sides.  Initializers draw
from an explicit ``torch.Generator`` on the target device; with no
generator the weights are left uninitialised, to be filled by
``model_zoo.params_from_numpy``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


def frozen(t: torch.Tensor) -> nn.Parameter:
    """An inference-only parameter."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if generator is None:
        return torch.empty((d_in, d_out), dtype=dtype, device=device)
    return (torch.randn((d_in, d_out), generator=generator,
                        dtype=torch.float32, device=device)
            / math.sqrt(d_in)).to(dtype)


def embed_init(generator: Optional[torch.Generator], vocab: int, d: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if generator is None:
        return torch.empty((vocab, d), dtype=dtype, device=device)
    return (torch.randn((vocab, d), generator=generator,
                        dtype=torch.float32, device=device)
            * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    # a bf16 scale is promoted to float32 inside the multiply
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.scale = frozen(torch.ones((d,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device: torch.device
                     ) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each (..., S, 1, D/2) float32, for positions (..., S).
    A decode step computes them once and every layer reuses them."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    angles = angles[..., None, :]                            # (..., S, 1, D/2)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D) rotated by the tables of :func:`rope_tables`.
    The JAX counterpart takes the positions and builds the tables on
    every call; here a decode step builds them once for all layers."""
    x1, x2 = torch.chunk(x, 2, dim=-1)   # promoted to float32 by cos/sin
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------
class FFN(nn.Module):
    """Gated (SwiGLU-style) dense FFN."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_up = frozen(dense_init(generator, d_model, d_ff, dtype,
                                      device))
        self.w_down = frozen(dense_init(generator, d_ff, d_model, dtype,
                                        device))
        self.w_gate = frozen(dense_init(generator, d_model, d_ff, dtype,
                                        device))


def ffn_apply(ffn: FFN, x: torch.Tensor) -> torch.Tensor:
    up = x @ ffn.w_up
    gate = F.silu((x @ ffn.w_gate).float())
    h = (gate * up).to(x.dtype)              # up promoted to float32
    return h @ ffn.w_down
