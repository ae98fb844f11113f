"""GQA attention: the training path and the dense-cache and paged-cache
decode paths.

Mirrors ``repro.models.attention`` ``full_attention``,
``self_attention``, ``attn_apply``, ``attn_decode_dense`` and
``attn_decode_paged``.  Training attention above
:data:`BLOCKWISE_THRESHOLD` tokens goes to ``kernels.ops.flash_attention``
(the CUDA flash kernels on the card, where the JAX package runs its jnp
``blockwise_attention`` under ``jax.checkpoint``); shorter sequences take
the masked softmax of :func:`full_attention`.  KV caches and pools are
updated in place.  What every layer of one decode step shares (rope
tables at the step's positions, the translated block table, the page
and slot receiving the new token) is computed once per step by
:func:`prepare_decode`: PyTorch runs eagerly, and recomputing it in each
layer only adds small launches.  The mesh branch of the paged path
(``_paged_attend_shardmap``) belongs to the parallel slice and is not
ported yet; MLA and cross-attention wait for their slices too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.core import block_table as BT
from repro_torch.core import kv_page_manager as KVM
from repro_torch.kernels import ops as KOPS
from repro_torch.models.layers import (apply_rope, dense_init, frozen,
                                       rope_tables)

BLOCKWISE_THRESHOLD = 2048
NEG_INF = -1e30


class Attention(nn.Module):
    """q/k/v/o projections, ``(d_in, d_out)`` layout."""

    def __init__(self, cfg, dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
        k = cfg.num_kv_heads
        self.wq = frozen(dense_init(generator, d, h * hd, dtype, device))
        self.wk = frozen(dense_init(generator, d, k * hd, dtype, device))
        self.wv = frozen(dense_init(generator, d, k * hd, dtype, device))
        self.wo = frozen(dense_init(generator, h * hd, d, dtype, device))


@dataclass
class DecodeStep:
    """The per-step operands every attention layer shares.

    lengths: (B,) tokens already cached; the new token goes at index
    ``lengths`` and attention covers ``attend = lengths + 1`` tokens.
    Paged modes: ``phys_all`` is the translated (B, max_pages) map (one
    indirection for flat, two for radix, done once per step: every layer
    reads the same map), ``phys_new``/``slot`` where the new K/V goes.
    Dense mode: ``mask`` over the (B, 1, S_max) cache positions.
    """
    lengths: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    attend: torch.Tensor
    phys_all: Optional[torch.Tensor] = None
    phys_new: Optional[torch.Tensor] = None
    slot: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


def prepare_decode(cfg, lengths: torch.Tensor, kv_mode: str, table,
                   cache_len: int, page_size: int) -> DecodeStep:
    """``cache_len``: dense cache slots per sequence; ``page_size``: KV
    page size of the pools (paged modes)."""
    cos, sin = rope_tables(lengths[:, None], cfg.head_dim, cfg.rope_theta)
    step = DecodeStep(lengths=lengths, cos=cos, sin=sin, attend=lengths + 1)
    if kv_mode == "dense":
        kpos = torch.arange(cache_len, device=lengths.device)
        step.mask = kpos[None, None, :] < step.attend[:, None, None]
        return step
    step.phys_all = BT.translate_all(table, kv_mode)     # (B, max_pages)
    bidx = torch.arange(lengths.shape[0], device=lengths.device)
    # XLA clamps an out-of-range gather index; clamp explicitly to match
    logical = (lengths // page_size).clamp_max(step.phys_all.shape[1] - 1)
    step.phys_new = step.phys_all[bidx, logical.long()].clamp_min(0).long()
    step.slot = (lengths % page_size).long()
    return step


def _project_qkv(attn: Attention, x: torch.Tensor, step: DecodeStep, cfg):
    """q, k (rotated in one pass) and v for the step's new token."""
    b = x.shape[0]
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qk = torch.cat([x @ attn.wq, x @ attn.wk], dim=-1).reshape(b, 1, h + kh,
                                                                hd)
    qk = apply_rope(qk, step.cos, step.sin)
    v = (x @ attn.wv).reshape(b, 1, kh, hd)
    return qk[:, :, :h], qk[:, :, h:], v


def _gqa_scores_attend(q, k, v, mask, scale):
    """q: (B,Sq,H,D) k,v: (B,Skv,K,D) mask: (B|1, Sq, Skv) bool."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def full_attention(q, k, v, *, causal: bool, window: int = 0
                   ) -> torch.Tensor:
    """Masked softmax attention. q:(B,Sq,H,D), k/v:(B,Skv,K,D), query i
    at position i.  ``window``: if >0, keys older than ``window``
    positions are masked.
    """
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return _gqa_scores_attend(q, k, v, mask[None],
                              1.0 / math.sqrt(q.shape[-1]))


def self_attention(q, k, v, *, causal: bool = True, window: int = 0
                   ) -> torch.Tensor:
    """The JAX package's branch: blockwise (flash) attention above
    :data:`BLOCKWISE_THRESHOLD` tokens, masked softmax below."""
    if q.shape[1] > BLOCKWISE_THRESHOLD and q.shape[1] == k.shape[1]:
        return KOPS.flash_attention(q, k, v, causal=causal, window=window)
    return full_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# GQA layer: train
# ---------------------------------------------------------------------------
def attn_apply(attn: Attention, x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, cfg) -> torch.Tensor:
    """Causal GQA self-attention of a decoder layer.  x: (B, S, D);
    ``cos``/``sin``: rope tables at the sequence's positions
    (:func:`rope_tables`, built once for all layers).  Returns y:
    (B, S, D)."""
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = apply_rope((x @ attn.wq).reshape(b, s, h, hd), cos, sin)
    k = apply_rope((x @ attn.wk).reshape(b, s, kh, hd), cos, sin)
    v = (x @ attn.wv).reshape(b, s, kh, hd)
    out = self_attention(q, k, v, causal=True)
    return out.reshape(b, s, h * hd) @ attn.wo


# ---------------------------------------------------------------------------
# GQA layer: dense-cache decode  (cache: (B, S_max, K, D))
# ---------------------------------------------------------------------------
def attn_decode_dense(attn: Attention, x: torch.Tensor, cache_k, cache_v,
                      step: DecodeStep, cfg) -> torch.Tensor:
    """One-token decode against a contiguous KV cache.

    x: (B, 1, D).  The new token is written at index ``step.lengths``,
    in place.  Returns y: (B, 1, D).
    """
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(attn, x, step, cfg)
    idx = (torch.arange(b, device=x.device), step.lengths.long())
    cache_k.index_put_(idx, k[:, 0])
    cache_v.index_put_(idx, v[:, 0])
    out = _gqa_scores_attend(q, cache_k, cache_v, step.mask,
                             1.0 / math.sqrt(hd))
    return out.reshape(b, 1, h * hd) @ attn.wo


# ---------------------------------------------------------------------------
# GQA layer: paged-cache decode (the NDPage path)
# ---------------------------------------------------------------------------
def attn_decode_paged(attn: Attention, x: torch.Tensor, kp, vp,
                      step: DecodeStep, cfg) -> torch.Tensor:
    """One-token decode against paged KV pools.

    kp/vp: (N_pages, page, K, D) pools, updated in place.  The new
    token's K/V is appended before the attention, which then covers
    ``step.attend`` tokens through the translated map ``step.phys_all``.
    Returns y: (B, 1, D).
    """
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(attn, x, step, cfg)
    KVM.append_kv(kp, vp, k[:, 0], v[:, 0], step.phys_new, step.slot)
    out = KOPS.paged_attention(q, kp, vp, step.phys_all, step.attend)
    return out.reshape(b, 1, h * hd) @ attn.wo
