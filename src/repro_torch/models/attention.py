"""GQA attention, causal or sliding-window, and DeepSeek's multi-head
latent attention (MLA): the training path and the dense-cache and
paged-cache decode paths.

Mirrors ``repro.models.attention`` ``full_attention``,
``self_attention``, ``attn_apply``, ``attn_decode_dense``,
``attn_decode_paged``, ``mla_apply`` and ``mla_decode``.  Training
attention above :data:`BLOCKWISE_THRESHOLD` tokens goes to
``kernels.ops.flash_attention`` (the CUDA flash kernels on the card,
where the JAX package runs its jnp ``blockwise_attention`` under
``jax.checkpoint``); shorter sequences take the masked softmax of
:func:`full_attention`.  KV caches and pools are
updated in place.  What every layer of one decode step shares (rope
tables at the step's positions, one pair for each rotated width, the
translated block table, the page and slot receiving the new token, the
dense caches' masks with and without the window) is computed once per
step by :func:`prepare_decode`:
PyTorch runs eagerly, and recomputing it in each layer only adds small
launches.  A sliding-window layer passes ``window`` (the config's
``window_size``; 0 for a global layer) to every path, as the JAX
package's ``block_apply_decode`` does; its KV pages outside the window
stay mapped, as they do there.

MLA rotates only its ``qk_rope_head_dim`` columns, so its rope tables
are built at that width (the JAX package's ``apply_rope`` takes its
frequencies from the width of the tensor it rotates).  Its training
path joins the 128 + 64 query and key columns into one head of 192, pads
v to it and runs :func:`self_attention` (above the threshold the flash
kernel at head_dim 192); its decode is the absorbed-matrix attention
over a dense latent cache, whatever the KV mode: an MLA layer has no KV
pool.

The paged path's mesh branch (:func:`_paged_attend_mesh`, the JAX
package's ``_paged_attend_shardmap``): with a ``DeviceMesh`` installed
(``parallel.context.use_mesh``) whose ``model`` axis is above 1, each
rank holds its ``state_sharding`` shard of the pools
(``init_decode_state`` builds them so) and serves its data shard's
sequences with shard-local page ids.  The projections are replicated:
every model rank computes q, k, v for all heads and keeps its own.
Three layouts, chosen by ``parallel.sharding.paged_mode``, the rule
that also sizes the pools:
  kv     kv heads divide ``model``: each rank attends over its kv heads
         and their query groups, through the hand-written paged kernel
         at the shard's heads;
  qhead  (``qhead_strategy``) the pools are replicated over ``model``
         and each rank's query heads read their kv head: the paged
         kernel once for each kv head the rank's query heads read;
  hd     head_dim split over ``model``: the float32 score partials are
         all-reduced over ``model`` before the softmax.  The kernel
         cannot take a sum in the middle of its softmax, and the JAX
         package runs jnp there, so this mode runs plain torch; it is
         chosen by the rule, never by a kernel's failure.
Then ``y = sum over model of out_shard @ wo[the shard's rows]``, an
all-reduce over ``model`` (the JAX package's ``einsum("bshd,hdD->bsD")``
over a sharded ``out``).

Training over a ``model`` axis (``parallel.tensor``): :func:`attn_apply`
with ``tp`` takes this rank's blocks of the weights, projects and ropes
its ``h / m`` query heads and the kv heads they read
(``tensor.head_layout``), runs :func:`self_attention` on them (above
2,048 tokens the flash kernels at the local head counts) and sums its
part of y (:func:`attn_shard`, through ``wo``'s row block) over
``model``.

An encoder-decoder (whisper) adds :func:`cross_kv` and
:func:`cross_attn_apply`: a decoder layer's queries over the encoder
output's keys and values, the masked softmax of :func:`full_attention`
without a mask, in training and in decode alike (the JAX package's jnp
path; no kernel), the K/V recomputed from the encoder output at every
call as there.  Its encoder runs :func:`attn_apply` with ``causal``
False.  A config with ``rope_theta <= 0`` rotates nothing: it has no
rope widths and builds no tables.  Projections go through
``layers.mm``, so float32 activations (the encoder over float32 audio
frames) through bf16 weights run in float32, as ``jnp.matmul``
promotes them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.core import kv_page_manager as KVM
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.ref import _paged_mask
from repro_torch.models.layers import (RMSNorm, apply_rope, dense_init,
                                       frozen, mm, rope_tables)
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import tensor as TP
from repro_torch.parallel.context import (axis_group, axis_rank,
                                          axis_size, current_mesh,
                                          model_size)

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


class MLA(nn.Module):
    """Multi-head latent attention: the query down/up projections with
    their norm, the joint KV down projection (latent + rope key), its
    norm, the per-head key and value up projections and the output,
    ``(d_in, d_out)`` layout."""

    def __init__(self, cfg, dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim

        def dense(d_in, d_out):
            return frozen(dense_init(generator, d_in, d_out, dtype, device))

        self.w_dq = dense(d, m.q_lora_rank)
        self.q_norm = RMSNorm(m.q_lora_rank, dtype, device)
        self.w_uq = dense(m.q_lora_rank, h * qk)
        self.w_dkv = dense(d, m.kv_lora_rank + m.qk_rope_head_dim)
        self.kv_norm = RMSNorm(m.kv_lora_rank, dtype, device)
        self.w_uk = dense(m.kv_lora_rank, h * m.qk_nope_head_dim)
        self.w_uv = dense(m.kv_lora_rank, h * m.v_head_dim)
        self.wo = dense(h * m.v_head_dim, d)


def rope_width(cfg, mixer_kind: str) -> int:
    """The width a layer of ``mixer_kind`` rotates: the head for GQA,
    ``qk_rope_head_dim`` for MLA, 0 (none) for Mamba and RWKV and for
    every layer of a config without rope (``rope_theta <= 0``)."""
    if mixer_kind in (C.MAMBA, C.RWKV) or cfg.rope_theta <= 0:
        return 0
    return (cfg.mla.qk_rope_head_dim if mixer_kind == C.ATTN_MLA
            else cfg.head_dim)


def rope_widths(cfg) -> Set[int]:
    """The widths the config's attention layers rotate."""
    return {w for w in (rope_width(cfg, mk) for mk, _ in cfg.layer_kinds())
            if w}


@dataclass
class DecodeStep:
    """The per-step operands every attention layer shares.

    lengths: (B,) tokens already cached; the new token goes at index
    ``lengths`` and attention covers ``attend = lengths + 1`` tokens.
    ``rope[width]``: (cos, sin) at the step's positions for each width
    a layer rotates (:func:`rope_widths`).
    Paged modes: ``phys_all`` is the translated (B, max_pages) map (one
    indirection for flat, two for radix, done once per step: every layer
    reads the same map), ``phys_new``/``slot`` where the new K/V goes.
    Dense mode: ``masks[window]`` over the (B, 1, S_max) cache
    positions, for the global layers (window 0) and, if the config has a
    window, for its sliding-window layers.  MLA layers: ``latent_mask``
    (B, 1, 1, S_max) over their latent cache, in every mode.
    """
    lengths: torch.Tensor
    rope: Dict[int, Tuple[torch.Tensor, torch.Tensor]]
    attend: torch.Tensor
    phys_all: Optional[torch.Tensor] = None
    phys_new: Optional[torch.Tensor] = None
    slot: Optional[torch.Tensor] = None
    masks: Optional[Dict[int, torch.Tensor]] = None
    latent_mask: Optional[torch.Tensor] = None


def prepare_decode(cfg, lengths: torch.Tensor, kv_mode: str, table,
                   cache_len: int, page_size: int, latent_len: int = 0
                   ) -> DecodeStep:
    """``cache_len``: dense cache slots per sequence and ``page_size``:
    KV page size of the pools (0 when no layer has a dense cache or a
    pool); ``latent_len``: MLA latent cache slots per sequence (0
    without MLA layers)."""
    rope = {w: rope_tables(lengths[:, None], w, cfg.rope_theta)
            for w in rope_widths(cfg)}
    step = DecodeStep(lengths=lengths, rope=rope, attend=lengths + 1)
    if latent_len:
        kpos = torch.arange(latent_len, device=lengths.device)
        step.latent_mask = (kpos[None, None, None, :]
                            < step.attend[:, None, None, None])
    if kv_mode == "dense":
        if cache_len:
            kpos = torch.arange(cache_len,
                                device=lengths.device)[None, None, :]
            step.masks = {0: kpos < step.attend[:, None, None]}
            if cfg.window_size > 0:
                step.masks[cfg.window_size] = step.masks[0] & (
                    kpos > lengths[:, None, None] - cfg.window_size)
        return step
    if not page_size:
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
    qk = apply_rope(qk, *step.rope.get(hd, (None, None)))
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
def attn_apply(attn: Attention, x: torch.Tensor,
               cos: Optional[torch.Tensor], sin: Optional[torch.Tensor],
               cfg, window: int = 0, causal: bool = True,
               tp: Optional[TP.TensorParallel] = None) -> torch.Tensor:
    """GQA self-attention, causal for a decoder layer and not for an
    encoder's, keys older than ``window`` positions masked if ``window``
    > 0.  x: (B, S, D); ``cos``/``sin``: rope tables at the sequence's
    positions (:func:`rope_tables`, built once for all layers; None
    without rope).  With ``tp`` (tensor parallelism over ``model``) the
    weights are this rank's blocks, x is the output of
    ``parallel.tensor.copy_to_model``, and the rank's
    :func:`attn_shard` is summed over ``model``.  Returns y: (B, S,
    D)."""
    y = attn_shard(attn, x, cos, sin, cfg, window, causal, tp)
    return TP.reduce_from_model(y, tp)


def attn_shard(attn: Attention, x: torch.Tensor,
               cos: Optional[torch.Tensor], sin: Optional[torch.Tensor],
               cfg, window: int = 0, causal: bool = True,
               tp: Optional[TP.TensorParallel] = None) -> torch.Tensor:
    """The attention of the rank's heads (``parallel.tensor.head_layout``)
    through ``wo``'s row block: the rank's part of y (all of it without
    ``tp``).  The flash kernels run at the local head counts."""
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wk, wv, index = attn.wk, attn.wv, None
    if tp is not None:
        lay = TP.head_layout(h, kh, tp)
        h, kh, index = lay.heads, lay.kv_heads, lay.kv_index
        if not lay.kv_split:     # whole weights: the kv heads read here
            cols = slice(lay.kv0 * hd, (lay.kv0 + kh) * hd)
            wk, wv = wk[:, cols], wv[:, cols]
        if attn.wq.shape[1] != h * hd or wk.shape[1] != kh * hd:
            raise ValueError(
                f"wq {tuple(attn.wq.shape)} / wk {tuple(wk.shape)} are not "
                f"a block of {h} / {kh} heads of {hd}: shard the weights "
                "over model (train_loop.shard_train_state)")
    q = apply_rope(mm(x, attn.wq).reshape(b, s, h, hd), cos, sin)
    k = apply_rope(mm(x, wk).reshape(b, s, kh, hd), cos, sin)
    v = mm(x, wv).reshape(b, s, kh, hd)
    if index is not None:        # one kv head for each query head
        idx = torch.tensor(index, device=x.device)
        k, v = k[:, :, idx], v[:, :, idx]
    out = self_attention(q, k, v, causal=causal, window=window)
    return mm(out.reshape(b, s, h * hd), attn.wo)


# ---------------------------------------------------------------------------
# cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------
def cross_attn_apply(attn: Attention, x: torch.Tensor, enc_k: torch.Tensor,
                     enc_v: torch.Tensor, cfg) -> torch.Tensor:
    """Decoder cross-attention over the encoder's K/V (no mask).  x:
    (B, S, D) (S 1 in decode); enc_k / enc_v: (B, S_enc, KH, Dh) from
    :func:`cross_kv`.  The scores and weights are float32 and the output
    takes q's dtype, as in :func:`_gqa_scores_attend`.  Returns y:
    (B, S, D)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = mm(x, attn.wq).reshape(b, s, h, hd)
    out = full_attention(q, enc_k, enc_v, causal=False)
    return mm(out.reshape(b, s, h * hd), attn.wo)


def cross_kv(attn: Attention, enc_out: torch.Tensor, cfg):
    """The cross-attention's K and V, (B, S_enc, KH, Dh) each, from the
    encoder output (B, S_enc, D)."""
    b, se, _ = enc_out.shape
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    k = mm(enc_out, attn.wk).reshape(b, se, kh, hd)
    v = mm(enc_out, attn.wv).reshape(b, se, kh, hd)
    return k, v


# ---------------------------------------------------------------------------
# GQA layer: dense-cache decode  (cache: (B, S_max, K, D))
# ---------------------------------------------------------------------------
def attn_decode_dense(attn: Attention, x: torch.Tensor, cache_k, cache_v,
                      step: DecodeStep, cfg, window: int = 0
                      ) -> torch.Tensor:
    """One-token decode against a contiguous KV cache.

    x: (B, 1, D).  The new token is written at index ``step.lengths``,
    in place; with ``window`` > 0 only the last ``window`` tokens are
    attended.  Returns y: (B, 1, D).
    """
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(attn, x, step, cfg)
    idx = (torch.arange(b, device=x.device), step.lengths.long())
    cache_k.index_put_(idx, k[:, 0])
    cache_v.index_put_(idx, v[:, 0])
    out = _gqa_scores_attend(q, cache_k, cache_v, step.masks[window],
                             1.0 / math.sqrt(hd))
    return out.reshape(b, 1, h * hd) @ attn.wo


# ---------------------------------------------------------------------------
# GQA layer: paged-cache decode (the NDPage path)
# ---------------------------------------------------------------------------
def attn_decode_paged(attn: Attention, x: torch.Tensor, kp, vp,
                      step: DecodeStep, cfg, window: int = 0
                      ) -> torch.Tensor:
    """One-token decode against paged KV pools.

    kp/vp: (N_pages, page, K, D) pools, updated in place.  The new
    token's K/V is appended before the attention, which then covers
    ``step.attend`` tokens (the last ``window`` of them if ``window`` >
    0) through the translated map ``step.phys_all``.  Returns y:
    (B, 1, D).
    """
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(attn, x, step, cfg)
    mesh = current_mesh()
    if model_size(mesh) > 1:
        return _paged_attend_mesh(mesh, attn, q, k[:, 0], v[:, 0], kp, vp,
                                  step, cfg, window)
    KVM.append_kv(kp, vp, k[:, 0], v[:, 0], step.phys_new, step.slot)
    out = KOPS.paged_attention(q, kp, vp, step.phys_all, step.attend,
                               window=window)
    return out.reshape(b, 1, h * hd) @ attn.wo


def _paged_attend_mesh(mesh, attn: Attention, q, k_new, v_new, kp, vp,
                       step: DecodeStep, cfg, window: int) -> torch.Tensor:
    """The shard-local paged append and attend of this rank (see the
    module docstring).  q: (B, 1, H, hd), k_new / v_new: (B, K, hd) for
    every head; kp / vp: this rank's (N, page, K', hd') pools;
    ``step.phys_all``: (B, max_pages) shard-local page ids.  Returns the
    layer's output y: (B, 1, D), the same on every model rank."""
    b = q.shape[0]
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n_model = axis_size(mesh, "model")
    r = axis_rank(mesh, "model")
    dp = axis_size(mesh, SH.batch_axes(mesh)) if SH.batch_axes(mesh) else 1
    mode = SH.paged_mode(mesh, cfg, n_pages=kp.shape[0] * dp,
                         page=kp.shape[1])
    wo3 = attn.wo.reshape(h, hd, cfg.d_model)
    if mode == "replicated":
        KVM.append_kv(kp, vp, k_new, v_new, step.phys_new, step.slot)
        out = KOPS.paged_attention(q, kp, vp, step.phys_all, step.attend,
                                   window=window)
        return out.reshape(b, 1, h * hd) @ attn.wo
    if mode == "hd":
        hl = hd // n_model
        cols = slice(r * hl, (r + 1) * hl)
        KVM.append_kv(kp, vp, k_new[..., cols], v_new[..., cols],
                      step.phys_new, step.slot)
        out = _paged_hd_partial(mesh, q[..., cols], kp, vp, step, hd,
                                window)
        w_rows = wo3[:, cols]
    else:
        hq = h // n_model
        heads = range(r * hq, (r + 1) * hq)
        if mode == "kv":
            kl = kh // n_model
            kvs = slice(r * kl, (r + 1) * kl)
            KVM.append_kv(kp, vp, k_new[:, kvs], v_new[:, kvs],
                          step.phys_new, step.slot)
            out = KOPS.paged_attention(q[:, :, r * hq:(r + 1) * hq], kp, vp,
                                       step.phys_all, step.attend,
                                       window=window)
        else:                                          # qhead
            KVM.append_kv(kp, vp, k_new, v_new, step.phys_new, step.slot)
            g = h // kh
            parts = []
            # the rank's query heads, in runs that read one kv head
            for j in sorted({i // g for i in heads}):
                lo, hi = max(j * g, heads[0]), min((j + 1) * g, heads[-1] + 1)
                parts.append(KOPS.paged_attention(
                    q[:, :, lo:hi], kp[:, :, j:j + 1], vp[:, :, j:j + 1],
                    step.phys_all, step.attend, window=window))
            out = torch.cat(parts, dim=2)
        w_rows = wo3[r * hq:(r + 1) * hq]
    y = torch.einsum("bshd,hdD->bsD", out, w_rows)
    return comm.all_reduce(y, axis_group(mesh, "model"))


def _paged_hd_partial(mesh, q_l, kp, vp, step: DecodeStep, hd: int,
                      window: int) -> torch.Tensor:
    """head_dim-split paged attention: this rank's head_dim columns of q
    (B, 1, H, hd / model) against its columns of the pools; the float32
    score partials summed over ``model``, then the masked softmax and
    the weighted sum of this rank's value columns.  Returns (B, 1, H,
    hd / model) in q's dtype."""
    b, _, h, hl = q_l.shape
    _, page, kh, _ = kp.shape
    ks, vs = KVM.gather_kv(kp, vp, step.phys_all)
    qg = q_l.reshape(b, 1, kh, h // kh, hl)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), ks.float())
    comm.all_reduce(scores, axis_group(mesh, "model"))
    scores = scores / math.sqrt(hd)
    mask = _paged_mask(step.phys_all, step.attend, page, window)
    scores = scores.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(vs.dtype).float(),
                       vs.float())
    return out.reshape(b, 1, h, hl).to(q_l.dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------
def _mla_q(mla: MLA, x: torch.Tensor, cos, sin, cfg):
    """(q_nope, q_rope rotated): (B, S, H, nope) and (B, S, H, rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    cq = mla.q_norm(x @ mla.w_dq, cfg.rms_norm_eps)
    q = (cq @ mla.w_uq).reshape(b, s, cfg.num_heads,
                                m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_latent(mla: MLA, x: torch.Tensor, cos, sin, cfg):
    """(c_kv normed (B, S, kv_lora), k_rope rotated (B, S, rope))."""
    m = cfg.mla
    c_kv, k_rope = (x @ mla.w_dkv).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = mla.kv_norm(c_kv, cfg.rms_norm_eps)
    return c_kv, apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]


def mla_apply(mla: MLA, x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg) -> torch.Tensor:
    """MLA train: expand the latent to per-head K/V and attend causally.
    x: (B, S, D); ``cos``/``sin``: rope tables at ``qk_rope_head_dim``.
    The rope columns join the others in one head of ``nope + rope``
    (192 at full width), v is padded to it with zeros and the output
    sliced back; the scale is 1/sqrt(nope + rope), the JAX package's
    (its ``out_scale`` is 1)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _mla_q(mla, x, cos, sin, cfg)
    c_kv, k_rope = _mla_latent(mla, x, cos, sin, cfg)
    k_nope = (c_kv @ mla.w_uk).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_kv @ mla.w_uv).reshape(b, s, h, m.v_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    pad = q_full.shape[-1] - m.v_head_dim
    out = self_attention(q_full, k_full, F.pad(v, (0, max(pad, 0))),
                         causal=True)
    out = out[..., :m.v_head_dim]
    return out.reshape(b, s, h * m.v_head_dim) @ mla.wo


def mla_decode(mla: MLA, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_kr: torch.Tensor, step: DecodeStep, cfg
               ) -> torch.Tensor:
    """Absorbed-matrix MLA decode in the latent space.  x: (B, 1, D);
    cache_ckv (B, S_max, kv_lora) and cache_kr (B, S_max, rope) take the
    new token at ``step.lengths``, in place.  Scores and context in
    float32, scaled by 1/sqrt(nope + rope); cast to the model dtype
    before ``wo``.  Returns y: (B, 1, D)."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    cos, sin = step.rope.get(m.qk_rope_head_dim, (None, None))
    q_nope, q_rope = _mla_q(mla, x, cos, sin, cfg)
    c_kv, k_rope = _mla_latent(mla, x, cos, sin, cfg)
    idx = (torch.arange(b, device=x.device), step.lengths.long())
    cache_ckv.index_put_(idx, c_kv[:, 0])
    cache_kr.index_put_(idx, k_rope[:, 0])
    # absorb W_uk into q: q_lat (B, 1, H, kv_lora)
    w_uk = mla.w_uk.reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshn,chn->bshc", q_nope.float(), w_uk.float())
    ckv = cache_ckv.float()
    scores = (torch.einsum("bshc,btc->bhst", q_lat, ckv)
              + torch.einsum("bshr,btr->bhst", q_rope.float(),
                             cache_kr.float())
              ) / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = scores.masked_fill(~step.latent_mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btc->bshc", w, ckv)
    w_uv = mla.w_uv.reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bshc,chv->bshv", ctx, w_uv.float())
    return out.reshape(b, 1, h * m.v_head_dim).to(x.dtype) @ mla.wo
