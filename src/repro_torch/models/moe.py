"""Routed mixture-of-experts FFN (GShard-style grouped capacity dispatch).

The port of ``repro.models.moe``.  Tokens are routed in groups of
:data:`GROUP_SIZE`: each token picks its top-k experts from a float32
softmax, takes a place in each expert's queue (token-major, then slot
order) and is dropped where the queue is past the group's capacity.
Dispatch and combine are the JAX package's dense ``(G, E, C)`` tensors
and einsums, so every expert's weights are read in every step, decode
included.  The JAX package scans the groups (``lax.scan``); here they
are one leading axis of every einsum, which leaves each group's sums as
they were.

``lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order on ties, so the experts are picked by a
stable descending sort, which breaks ties the JAX way and keeps the
routed experts and queue positions (integers) equal to the reference's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers import FFN, dense_init, ffn_apply, frozen

GROUP_SIZE = 512  # tokens per routing group
#: groups of at most this many tokens (decode steps, small tests) are
#: dropless: the capacity is the group size
DROPLESS_GROUP = 64


def _experts_init(generator: Optional[torch.Generator], n: int, d_in: int,
                  d_out: int, dtype: torch.dtype, device: torch.device
                  ) -> torch.Tensor:
    if generator is None:
        return torch.empty((n, d_in, d_out), dtype=dtype, device=device)
    return (torch.randn((n, d_in, d_out), generator=generator,
                        dtype=torch.float32, device=device)
            / math.sqrt(d_in)).to(dtype)


class MoE(nn.Module):
    """``router`` (D, E) float32 in every model dtype; ``w_up``,
    ``w_gate`` (E, D, F) and ``w_down`` (E, F, D); ``shared`` a dense
    FFN of width ``expert_d_ff x num_shared_experts`` (or None)."""

    def __init__(self, cfg, dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = cfg.moe
        d, e = cfg.d_model, m.num_experts
        dff = m.expert_d_ff or cfg.d_ff
        self.router = frozen(dense_init(generator, d, e, torch.float32,
                                        device))
        self.w_up = frozen(_experts_init(generator, e, d, dff, dtype,
                                         device))
        self.w_down = frozen(_experts_init(generator, e, dff, d, dtype,
                                           device))
        self.gated = cfg.gated_ffn
        if self.gated:
            self.w_gate = frozen(_experts_init(generator, e, d, dff, dtype,
                                               device))
        self.shared = (FFN(d, dff * m.num_shared_experts, dtype, device,
                           generator, gated=cfg.gated_ffn)
                       if m.num_shared_experts else None)


def capacity(cfg, g: int) -> int:
    """Queue places an expert has in a group of ``g`` tokens."""
    m = cfg.moe
    if g <= DROPLESS_GROUP:
        return g
    return max(1, int(g * m.num_experts_per_tok * m.capacity_factor
                      / m.num_experts))


def route(moe: MoE, xg: torch.Tensor, cfg):
    """Routing of groups ``xg`` (N, G, D): (probs (N, G, E) float32,
    top_p (N, G, k) renormalised, top_i (N, G, k) experts, pos (N, G, k)
    queue positions before clamping, keep (N, G, k) bool)."""
    m = cfg.moe
    e, k = m.num_experts, m.num_experts_per_tok
    cap = capacity(cfg, xg.shape[1])
    probs = torch.softmax(xg.float() @ moe.router, dim=-1)
    # lax.top_k's order: the larger value first, the lower index on ties
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # position of each (token, slot) in its expert's queue, token-major
    onehot = F.one_hot(top_i, e)                              # (N, G, k, E)
    flat = onehot.flatten(1, 2)                               # (N, G k, E)
    before = torch.cumsum(flat, dim=1) - flat
    pos = (before * flat).sum(-1).reshape(top_i.shape)        # (N, G, k)
    keep = (pos < cap) & (top_p > 0)
    return probs, top_p, top_i, pos, keep


def _dispatch_combine(top_p, top_i, pos, keep, e: int, cap: int,
                      dtype: torch.dtype):
    """The (N, G, E, C) dispatch (0 or 1, in ``dtype``) and combine
    (float32) tensors of the JAX package.  A token's k experts differ, so
    each (token, expert) pair has at most one slot: it is formed per
    (token, expert) and placed with one comparison, the values the JAX
    package's sum over slots of one-hot products gives, without its (N,
    G, k, E, C) intermediate."""
    onehot = F.one_hot(top_i, e)                              # (N, G, k, E)
    chosen = (onehot * keep[..., None]).sum(2)                # (N, G, E)
    place = (onehot * torch.clamp(pos, max=cap - 1)[..., None]).sum(2)
    weight = (onehot * (top_p * keep)[..., None]).sum(2)      # float32
    slots = torch.arange(cap, device=top_i.device)
    at = (place[..., None] == slots) & (chosen[..., None] > 0)
    return at.to(dtype), at.float() * weight[..., None]


def _expert_ffn(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: (N, E, C, D) -> (N, E, C, D) with per-expert weights."""
    up = torch.einsum("necd,edf->necf", x, moe.w_up)
    if moe.gated:
        gate = F.silu(torch.einsum("necd,edf->necf", x,
                                   moe.w_gate).float())
        h = (gate * up).to(x.dtype)               # up promoted to float32
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return torch.einsum("necf,efd->necd", h, moe.w_down)


def _route_groups(moe: MoE, xg: torch.Tensor, cfg
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Groups xg: (N, G, D) -> (out (N, G, D), aux (N,) per group)."""
    m = cfg.moe
    n, g, _ = xg.shape
    e, k = m.num_experts, m.num_experts_per_tok
    probs, top_p, top_i, pos, keep = route(moe, xg, cfg)
    # load-balance aux loss (Switch): E * mean(frac_tokens * frac_probs)
    tokens_per_e = F.one_hot(top_i, e).float().sum((1, 2)) / (g * k)
    probs_per_e = probs.mean(1)
    aux = e * (tokens_per_e * probs_per_e).sum(-1)
    disp, combine = _dispatch_combine(top_p, top_i, pos, keep, e,
                                      capacity(cfg, g), xg.dtype)
    expert_in = torch.einsum("ngec,ngd->necd", disp, xg)
    expert_out = _expert_ffn(moe, expert_in)
    out = torch.einsum("ngec,necd->ngd", combine.to(xg.dtype), expert_out)
    if moe.shared is not None:
        out = out + ffn_apply(moe.shared, xg)
    return out, aux


def moe_apply(moe: MoE, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Groups of :data:`GROUP_SIZE`
    along the flattened tokens; aux is the mean over groups."""
    b, s, d = x.shape
    t = b * s
    gsz = min(GROUP_SIZE, t)
    if t % gsz:
        raise ValueError(f"{t} tokens do not split into groups of {gsz}")
    out, aux = _route_groups(moe, x.reshape(t // gsz, gsz, d), cfg)
    return out.reshape(b, s, d), aux.mean()
