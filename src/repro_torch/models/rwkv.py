"""RWKV6 (Finch) time-mix block, attention-free: the port of
``repro.models.rwkv``.

Per head (head size hs) a matrix state S (hs x hs):
  a_t = k_t v_t^T ;  o_t = r_t (S_t + diag(u) a_t) ;
  S_t+1 = diag(w_t) S_t + a_t
with the data-dependent decay w_t = exp(-exp(w0 + tanh(x_t A) B)) per
channel.  Token-shift mixing feeds the previous token into the r, k, v,
g and w projections (each mix taken in float32 and cast to x's dtype
before its matmul, as the JAX package does).

The time recurrence of training and prefill is ``ops.wkv``: on the card
the hand-written kernel pair of ``kernels/wkv.py`` (forward and
backward), on the CPU the plain step loop.  The JAX package runs it as
``chunked_scan`` (chunks of 256 steps), whose assert refuses a sequence
longer than a chunk that is not a whole number of chunks;
``ops.wkv`` refuses it too.  The output groupnorm (per head, eps
64e-5, the population variance), the ``silu(g)`` gate and the
projections stay plain torch.  Decode is the O(1) single-step update in
plain torch ops.  State: ``wkv`` (B, H, hs, hs) and ``shift`` (B, D),
both float32, updated in place.

``w0``, ``u``, ``ln_x_scale`` and ``ln_x_bias`` are float32 in every
model dtype, as the JAX package's ``rwkv_init`` makes them; the rest
takes the model dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, frozen, token_shift_mix

#: the groupnorm's epsilon (``_groupnorm_heads``)
GROUPNORM_EPS = 64e-5


def _dims(cfg) -> Tuple[int, int]:
    """(heads, head size)."""
    hs = cfg.rwkv.head_size
    return cfg.d_model // hs, hs


class RWKV(nn.Module):
    """The JAX ``rwkv_init`` leaves: ``w_r``, ``w_k``, ``w_v``, ``w_g``,
    ``w_o`` (D, D), ``mix`` (5, D), ``w0`` (D), ``w_A`` (D, decay_lora),
    ``w_B`` (decay_lora, D), ``u`` (H, hs), ``ln_x_scale`` and
    ``ln_x_bias`` (D)."""

    def __init__(self, cfg, dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, lora = cfg.d_model, cfg.rwkv.decay_lora
        nh, hs = _dims(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, frozen(dense_init(generator, d, d, dtype,
                                                  device)))
        self.mix = frozen(torch.full((5, d), 0.5, dtype=dtype,
                                     device=device))
        self.w0 = frozen(torch.full((d,), -0.5, **f32))
        self.w_A = frozen(dense_init(generator, d, lora, dtype, device))
        # dense_init's 1 / sqrt(d_in) is the JAX package's 1 / sqrt(lora)
        self.w_B = frozen(dense_init(generator, lora, d, dtype, device))
        self.u = frozen(torch.empty((nh, hs), **f32) if generator is None
                        else torch.randn((nh, hs), generator=generator,
                                         **f32) * 0.1)
        self.ln_x_scale = frozen(torch.ones((d,), **f32))
        self.ln_x_bias = frozen(torch.zeros((d,), **f32))


def _projections(m: RWKV, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift mix then project; x, x_prev (..., D).  Returns r, k,
    v, g in x's dtype and the decay w in float32."""
    def mixed(i: int) -> torch.Tensor:
        return token_shift_mix(x, x_prev, m.mix[i])

    r = mixed(0) @ m.w_r
    k = mixed(1) @ m.w_k
    v = mixed(2) @ m.w_v
    g = mixed(3) @ m.w_g
    dec = torch.tanh((mixed(4) @ m.w_A).float()) @ m.w_B.float()
    w = torch.exp(-torch.exp(m.w0 + dec))              # (..., D) in (0, 1)
    return r, k, v, g, w


def _groupnorm_heads(m: RWKV, o: torch.Tensor, nh: int, hs: int
                     ) -> torch.Tensor:
    """Per-head layernorm of the WKV output, o (..., D) float32: the
    population variance (``jnp.var``, ddof 0) and eps 64e-5."""
    oh = o.reshape(o.shape[:-1] + (nh, hs))
    mu = oh.mean(-1, keepdim=True)
    var = oh.var(-1, keepdim=True, unbiased=False)
    oh = (oh - mu) * torch.rsqrt(var + GROUPNORM_EPS)
    return oh.reshape(o.shape) * m.ln_x_scale + m.ln_x_bias


def _output(m: RWKV, o: torch.Tensor, g: torch.Tensor, x_dtype, cfg
            ) -> torch.Tensor:
    """groupnorm, the ``silu(g)`` gate, cast, ``w_o``."""
    o = _groupnorm_heads(m, o, *_dims(cfg))
    o = o * F.silu(g.float())
    return o.to(x_dtype) @ m.w_o


def rwkv_apply(m: RWKV, x: torch.Tensor, cfg) -> torch.Tensor:
    """Train / prefill forward.  x: (B, S, D) -> (B, S, D).  ``ops.wkv``
    refuses a ragged S over a chunk, as the JAX package's chunk rule."""
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, w = _projections(m, x, x_prev)
    o = ops.wkv(r.float().contiguous(), k.float().contiguous(),
                v.float().contiguous(), w.contiguous(), m.u)
    return _output(m, o, g, x.dtype, cfg)


def rwkv_init_state(cfg, batch: int, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    nh, hs = _dims(cfg)
    return {"wkv": torch.zeros((batch, nh, hs, hs), dtype=torch.float32,
                               device=device),
            "shift": torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                                 device=device)}


def rwkv_decode(m: RWKV, x: torch.Tensor, st: Dict[str, torch.Tensor],
                cfg) -> torch.Tensor:
    """One-token decode.  x: (B, 1, D) -> (B, 1, D); ``st`` updated in
    place."""
    b, _, d = x.shape
    nh, hs = _dims(cfg)
    x_t = x[:, 0]
    r, k, v, g, w = _projections(m, x_t, st["shift"].to(x.dtype))
    rh, kh, vh = (t.reshape(b, nh, hs).float() for t in (r, k, v))
    a = kh[..., :, None] * vh[..., None, :]
    o = torch.einsum("bhi,bhij->bhj", rh,
                     st["wkv"] + m.u[None, :, :, None] * a)
    st["wkv"].copy_(w.reshape(b, nh, hs)[..., :, None] * st["wkv"] + a)
    st["shift"].copy_(x_t.float())
    return _output(m, o.reshape(b, d), g, x.dtype, cfg)[:, None]
