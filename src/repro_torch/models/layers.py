"""Primitive layers: norms, rope, FFNs, and their initializers.

The functions mirror ``repro.models.layers``; parameters live in small
``nn.Module``s whose weights keep the JAX package's ``(d_in, d_out)``
layout, so a layer computes ``x @ w`` on both sides.  Initializers draw
from an explicit ``torch.Generator`` on the target device; with no
generator the weights are left uninitialised, to be filled by
``model_zoo.params_from_numpy``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.parallel import tensor as TP


def frozen(t: torch.Tensor) -> nn.Parameter:
    """An inference-only parameter."""
    return nn.Parameter(t, requires_grad=False)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.matmul``
    computes it: float32 activations through bf16 weights (whisper's
    encoder over float32 audio frames) give float32, where a torch
    matmul of mixed dtypes raises."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


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


def apply_rope(x: torch.Tensor, cos: Optional[torch.Tensor],
               sin: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (..., S, H, D) rotated by the tables of :func:`rope_tables`.
    The JAX counterpart takes the positions and builds the tables on
    every call; here a decode step builds them once for all layers.
    No tables (``cos`` None: a config with ``rope_theta <= 0``) returns
    x unchanged, as the JAX counterpart does for such a theta."""
    if cos is None:
        return x
    x1, x2 = torch.chunk(x, 2, dim=-1)   # promoted to float32 by cos/sin
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=8)
def _sinusoid_table(seq_len: int, d: int) -> np.ndarray:
    """The float32 numpy table, read-only: the cache holds no tensor, so
    a fake and a real caller never share one."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = 1.0 / (10_000 ** (dim / max(d // 2 - 1, 1)))
    ang = pos * inv
    table = np.concatenate([np.sin(ang), np.cos(ang)],
                           axis=-1).astype(np.float32)
    table.setflags(write=False)
    return table


def sinusoidal_positions(seq_len: int, d: int, device: torch.device
                         ) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (S, d) float32 for the archs
    without rope: computed in float64 by numpy, then cast, as the JAX
    package computes them (the numpy table is built once for a shape).
    Each call makes a fresh tensor from it on ``device``: a fake tensor
    under a fake-tensor mode (``launch.specs.FAKE_MODE``), a real one
    outside it."""
    return torch.tensor(_sinusoid_table(seq_len, d)).to(device)


def decode_positions(lengths: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal embedding (B, d) float32 of each sequence's current
    index ``lengths`` in a decode step: the JAX ``decode_step``'s own
    formula, in float32 throughout (not :func:`sinusoidal_positions`)."""
    half = d // 2
    inv = 1.0 / (10_000 ** (torch.arange(half, device=lengths.device)
                            / max(half - 1, 1)))
    ang = lengths[:, None].float() * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------
class FFN(nn.Module):
    """Dense FFN: gated (SwiGLU-style, ``w_up``, ``w_gate``, ``w_down``)
    or, with ``gated=False``, the GELU MLP (``w_up``, ``w_down``)."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 gated: bool = True):
        super().__init__()
        self.w_up = frozen(dense_init(generator, d_model, d_ff, dtype,
                                      device))
        self.w_down = frozen(dense_init(generator, d_ff, d_model, dtype,
                                        device))
        self.gated = gated
        if gated:
            self.w_gate = frozen(dense_init(generator, d_model, d_ff, dtype,
                                            device))


def ffn_apply(ffn: FFN, x: torch.Tensor,
              tp: Optional[TP.TensorParallel] = None) -> torch.Tensor:
    """The FFN of x (..., D).  With ``tp`` (``parallel.tensor``: the
    weights split over ``model``) ``w_up`` / ``w_gate`` are this rank's
    column blocks and ``w_down`` its row block, x is the output of
    ``copy_to_model``, and the rank's part of y is summed over
    ``model``."""
    up = mm(x, ffn.w_up)
    if ffn.gated:
        gate = F.silu(mm(x, ffn.w_gate).float())
        h = (gate * up).to(x.dtype)              # up promoted to float32
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return TP.reduce_from_model(mm(h, ffn.w_down), tp)


class ReluSqFFN(nn.Module):
    """RWKV's channel mix (``relu_sq_ffn_init``): ``w_k`` (D, d_ff),
    ``w_v`` (d_ff, D) and the token-shift mix ``mix_k`` (D), all in the
    model dtype."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_k = frozen(dense_init(generator, d_model, d_ff, dtype,
                                     device))
        self.w_v = frozen(dense_init(generator, d_ff, d_model, dtype,
                                     device))
        self.mix_k = frozen(torch.full((d_model,), 0.5, dtype=dtype,
                                       device=device))


def token_shift_mix(x: torch.Tensor, x_prev: torch.Tensor,
                    mix: torch.Tensor) -> torch.Tensor:
    """``x mix + x_prev (1 - mix)`` taken in float32, cast to x's dtype."""
    mix = mix.float()
    return (x.float() * mix + x_prev.float() * (1 - mix)).to(x.dtype)


def relu_sq_ffn_apply(ffn: ReluSqFFN, x: torch.Tensor,
                      x_prev: torch.Tensor) -> torch.Tensor:
    """``relu(xk W_k)^2 W_v`` with ``xk`` the token-shift mix of x and
    the previous token's x_prev (both (..., D))."""
    xk = token_shift_mix(x, x_prev, ffn.mix_k)
    h = torch.square(F.relu((xk @ ffn.w_k).float()))
    return h.to(x.dtype) @ ffn.w_v
