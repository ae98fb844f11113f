"""Mamba (selective SSM) block, Jamba's attention-free mixer: the port of
``repro.models.mamba``.

Mamba-1's selective scan:
  x, z = split(in_proj(u));  x = silu(causal_depthwise_conv(x))
  dt, B, C = x_proj(x);  dt = softplus(dt_proj(dt))
  h_t = exp(dt A) h_{t-1} + dt B x_t ;  y_t = C h_t + D x_t
  out = out_proj(y * silu(z))

The time recurrence of training and prefill is ``ops.selective_scan``:
on the card the hand-written kernel pair of ``kernels/selective_scan.py``
(forward and backward), on the CPU the plain step loop.  The JAX package
runs it as ``chunked_scan`` (chunks of 256 steps), whose assert refuses
a sequence longer than a chunk that is not a whole number of chunks;
:func:`mamba_apply` refuses it too.  The causal depthwise conv, softplus,
``D x`` and ``silu(z)`` stay plain torch, as they stay outside the scan
there (the conv is ``F.conv1d`` in float32; on the card cuDNN may take
it in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off).  Decode
is the O(1) single-step update in plain torch ops.  State: ``conv`` (B,
d_in, d_conv - 1) and ``ssm`` (B, d_in, N), both float32, updated in
place.

``A_log``, ``D`` and ``dt_bias`` are float32 in every model dtype, as
the JAX package never casts them; ``conv_w`` and ``conv_b`` take the
model dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import SCAN_CHUNK
from repro_torch.models.layers import dense_init, frozen


def _dims(cfg) -> Tuple[object, int, int]:
    """(the Mamba config, d_inner, dt_rank)."""
    mc = cfg.mamba
    return mc, mc.expand * cfg.d_model, mc.dt_rank or -(-cfg.d_model // 16)


class Mamba(nn.Module):
    """The JAX ``mamba_init`` leaves: ``in_proj`` (D, 2 d_in),
    ``conv_w`` (d_in, d_conv), ``conv_b`` (d_in), ``x_proj`` (d_in,
    dt_rank + 2N), ``dt_proj`` (dt_rank, d_in), ``dt_bias`` (d_in),
    ``A_log`` (d_in, N), ``D`` (d_in), ``out_proj`` (d_in, D)."""

    def __init__(self, cfg, dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mc, d_in, dt_rank = _dims(cfg)
        d, n, k = cfg.d_model, mc.d_state, mc.d_conv
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = frozen(dense_init(generator, d, 2 * d_in, dtype,
                                         device))
        self.x_proj = frozen(dense_init(generator, d_in, dt_rank + 2 * n,
                                        dtype, device))
        self.out_proj = frozen(dense_init(generator, d_in, d, dtype,
                                          device))
        if generator is None:
            conv_w = torch.empty((d_in, k), dtype=dtype, device=device)
            dt_proj = torch.empty((dt_rank, d_in), dtype=dtype,
                                  device=device)
            dt_bias = torch.empty((d_in,), **f32)
        else:
            conv_w = (torch.randn((d_in, k), generator=generator, **f32)
                      / math.sqrt(k)).to(dtype)
            # dense_init with scale dt_rank ** -0.5, as the JAX package's
            dt_proj = (torch.randn((dt_rank, d_in), generator=generator,
                                   **f32) * dt_rank ** -0.5).to(dtype)
            # dt spread log-uniformly over [1e-3, 0.1], stored as the
            # inverse softplus
            u = torch.rand((d_in,), generator=generator, **f32)
            dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                            + math.log(1e-3)).clamp_min(1e-4)
            dt_bias = torch.log(torch.expm1(dt0))
        self.conv_w = frozen(conv_w)
        self.conv_b = frozen(torch.zeros((d_in,), dtype=dtype,
                                         device=device))
        self.dt_proj = frozen(dt_proj)
        self.dt_bias = frozen(dt_bias)
        self.A_log = frozen(torch.log(torch.arange(
            1, n + 1, **f32)).repeat(d_in, 1))
        self.D = frozen(torch.ones((d_in,), **f32))


def _ssm_inputs(m: Mamba, x: torch.Tensor, cfg):
    """x: (B, S, d_in) after the conv.  Returns dt (float32), B, C
    (float32) and A = -exp(A_log)."""
    mc, _, dt_rank = _dims(cfg)
    proj = x @ m.x_proj
    dt, b_mat, c_mat = torch.split(proj, [dt_rank, mc.d_state, mc.d_state],
                                   dim=-1)
    dt = F.softplus((dt @ m.dt_proj).float() + m.dt_bias.float())
    return dt, b_mat.float(), c_mat.float(), -torch.exp(m.A_log)


def _conv_full(m: Mamba, x: torch.Tensor, cfg) -> torch.Tensor:
    """Causal depthwise conv along time, then silu.  x: (B, S, d_in)."""
    w = m.conv_w.float()                                  # (d_in, K)
    xt = F.pad(x.float().transpose(1, 2), (cfg.mamba.d_conv - 1, 0))
    out = F.conv1d(xt, w[:, None, :], groups=w.shape[0])  # (B, d_in, S)
    out = out + m.conv_b.float()[None, :, None]
    return F.silu(out).transpose(1, 2).to(x.dtype)


def mamba_apply(m: Mamba, u: torch.Tensor, cfg) -> torch.Tensor:
    """Train / prefill forward.  u: (B, S, D) -> (B, S, D)."""
    _, d_in, _ = _dims(cfg)
    s = u.shape[1]
    if s > SCAN_CHUNK and s % SCAN_CHUNK:
        raise ValueError(f"mamba_apply: a sequence of {s} tokens is longer "
                         f"than a {SCAN_CHUNK}-step scan chunk and not a "
                         f"whole number of chunks (the JAX package's "
                         f"chunked_scan refuses it too)")
    x, z = torch.split(u @ m.in_proj, d_in, dim=-1)
    x = _conv_full(m, x, cfg).contiguous()
    dt, bm, cm, a = _ssm_inputs(m, x, cfg)
    y = ops.selective_scan(x, dt.contiguous(), bm.contiguous(),
                           cm.contiguous(), a.contiguous())
    y = y + m.D * x.float()
    y = y * F.silu(z.float())
    return y.to(u.dtype) @ m.out_proj


def mamba_init_state(cfg, batch: int, device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    mc, d_in, _ = _dims(cfg)
    return {"conv": torch.zeros((batch, d_in, mc.d_conv - 1),
                                dtype=torch.float32, device=device),
            "ssm": torch.zeros((batch, d_in, mc.d_state),
                               dtype=torch.float32, device=device)}


def mamba_decode(m: Mamba, u: torch.Tensor, st: Dict[str, torch.Tensor],
                 cfg) -> torch.Tensor:
    """One-token decode.  u: (B, 1, D) -> (B, 1, D); ``st`` updated in
    place."""
    _, d_in, _ = _dims(cfg)
    x, z = torch.split(u[:, 0] @ m.in_proj, d_in, dim=-1)  # (B, d_in)
    window = torch.cat([st["conv"], x.float()[..., None]], dim=-1)
    xc = (torch.einsum("bdk,dk->bd", window, m.conv_w.float())
          + m.conv_b.float())
    xc = F.silu(xc).to(u.dtype)
    dt, bm, cm, a = _ssm_inputs(m, xc[:, None], cfg)
    dt, bm, cm = dt[:, 0], bm[:, 0], cm[:, 0]
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * xc.float())[..., None] * bm[:, None, :]
    h = da * st["ssm"] + dbx
    y = torch.einsum("bdn,bn->bd", h, cm)
    y = y + m.D * xc.float()
    y = y * F.silu(z.float())
    st["conv"].copy_(window[..., 1:])
    st["ssm"].copy_(h)
    return (y.to(u.dtype) @ m.out_proj)[:, None]
