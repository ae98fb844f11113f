"""Block + stack assembly for training and decode.

The JAX package scans one period of ``layer_pattern`` over stacked
parameters (``lax.scan``); PyTorch runs eagerly, so the stack here is an
``nn.ModuleList`` with one ``Block`` per layer and training and decode
are Python loops over it, the ``prefix_pattern`` blocks first, in
``cfg.layer_kinds()`` order.  Training sums the MoE layers' aux losses
over the stack, as the JAX package's ``stack_apply_train`` does.  With
``cfg.remat`` each training block runs under ``torch.utils.checkpoint``
(the JAX side remats each period with ``jax.checkpoint``, and its
prefix blocks not at all; the numbers are the same).  Decode state is a
list with one dict per layer.  KV backends of a GQA layer:
  dense       contiguous per-layer KV cache (the no-translation baseline)
  paged_flat  NDPage flattened single-level block table (one indirection)
  paged_radix 2-level directory->leaf block table (two indirections)
An MLA layer holds its dense latent cache (``ckv``, ``kr``) in every
mode, as the JAX package's ``block_init_state`` does; a Mamba layer its
recurrent state (``conv``, ``ssm``, float32); an RWKV layer its own
(``wkv``, ``shift``, float32) and, with a dense FFN, the channel mix's
token shift (``ffn_shift``, float32).  :func:`reset_recurrent_state`
zeroes a layer's recurrent state for one batch slot.

Ported blocks: global (``ATTN``), sliding-window (``ATTN_LOCAL``) or
latent (``ATTN_MLA``) attention, Mamba (``MAMBA``) and RWKV6
(``RWKV``), the last two with no rope, with a dense FFN (gated or GELU;
in a config with ``cfg.rwkv`` RWKV's relu^2 channel mix, which shifts
the norm2 output by one token) or a routed mixture of experts
(``MOE_FF``).

An encoder-decoder (whisper) builds its decoder stack with ``cross``:
each block adds ``norm_cross`` and a cross-attention (``cross``), run
after the mixer and before the FFN over the encoder output ``enc_out``
(training and decode), as the JAX package's blocks do.  Its encoder is
a stack of the same blocks without ``cross``, run with ``causal``
False.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import config as C
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models.layers import (FFN, ReluSqFFN, RMSNorm, ffn_apply,
                                       relu_sq_ffn_apply, rope_tables)
from repro_torch.parallel import tensor as TP

_MIXERS = (C.ATTN, C.ATTN_LOCAL, C.ATTN_MLA, C.MAMBA, C.RWKV)
#: the keys of a layer's decode state that carry a sequence's recurrent
#: state (a Mamba or an RWKV layer's, the channel mix's token shift),
#: reset when a slot takes a new sequence
RECURRENT_STATE = ("conv", "ssm", "wkv", "shift", "ffn_shift")


def _check_kinds(cfg, mixer_kind: str, ffn_kind: str) -> None:
    if mixer_kind not in _MIXERS or ffn_kind not in (C.DENSE_FF,
                                                     C.MOE_FF):
        raise ValueError((mixer_kind, ffn_kind))
    if mixer_kind == C.MAMBA and cfg.mamba is None:
        raise ValueError(f"{cfg.name}: a Mamba layer needs cfg.mamba")
    if mixer_kind == C.RWKV and cfg.rwkv is None:
        raise ValueError(f"{cfg.name}: an RWKV layer needs cfg.rwkv")


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------
class Block(nn.Module):
    def __init__(self, cfg, mixer_kind: str, ffn_kind: str,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 cross: bool = False):
        super().__init__()
        _check_kinds(cfg, mixer_kind, ffn_kind)
        dt = cfg.torch_dtype
        self.norm1 = RMSNorm(cfg.d_model, dt, device)
        self.norm2 = RMSNorm(cfg.d_model, dt, device)
        self.mla = mixer_kind == C.ATTN_MLA
        self.mamba = mixer_kind == C.MAMBA
        self.rwkv = mixer_kind == C.RWKV
        if self.mamba:
            self.mixer = M.Mamba(cfg, dt, device, generator)
        elif self.rwkv:
            self.mixer = R.RWKV(cfg, dt, device, generator)
        elif self.mla:
            self.mixer = A.MLA(cfg, dt, device, generator)
        else:
            self.mixer = A.Attention(cfg, dt, device, generator)
        self.moe = ffn_kind == C.MOE_FF
        #: RWKV's relu^2 channel mix in place of the dense FFN
        self.channel_mix = not self.moe and cfg.rwkv is not None
        if self.moe:
            self.ffn = MOE.MoE(cfg, dt, device, generator)
        elif self.channel_mix:
            self.ffn = ReluSqFFN(cfg.d_model, cfg.d_ff, dt, device,
                                 generator)
        else:
            self.ffn = FFN(cfg.d_model, cfg.d_ff, dt, device, generator,
                           gated=cfg.gated_ffn)
        #: keys older than this are masked (0: a global layer)
        self.window = cfg.window_size if mixer_kind == C.ATTN_LOCAL else 0
        #: the width of the rope tables the mixer takes (0: none)
        self.rope_width = A.rope_width(cfg, mixer_kind)
        #: an encoder-decoder's decoder block: cross-attention over the
        #: encoder output after the mixer (None elsewhere)
        self.norm_cross = self.cross = None
        if cross:
            self.norm_cross = RMSNorm(cfg.d_model, dt, device)
            self.cross = A.Attention(cfg, dt, device, generator)


def _ffn(block: Block, h: torch.Tensor, cfg,
         shift_prev: Optional[torch.Tensor] = None,
         tp: Optional[TP.TensorParallel] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, aux): aux is the MoE's load-balance loss, 0 for a dense FFN.
    The channel mix shifts h (the norm2 output) along the sequence in
    training, zero first; in decode it takes ``shift_prev`` (B, D), the
    previous token's.  With ``tp`` a dense FFN runs on its blocks, h
    through ``copy_to_model``."""
    if block.moe:
        return MOE.moe_apply(block.ffn, h, cfg)
    zero = torch.zeros((), device=h.device)
    if block.channel_mix:
        prev = (F.pad(h, (0, 0, 1, 0))[:, :-1] if shift_prev is None
                else shift_prev[:, None].to(h.dtype))
        return relu_sq_ffn_apply(block.ffn, h, prev), zero
    return ffn_apply(block.ffn, TP.copy_to_model(h, tp), tp), zero


def _cross(block: Block, x: torch.Tensor, enc_out: Optional[torch.Tensor],
           cfg) -> torch.Tensor:
    """x plus the block's cross-attention over ``enc_out``, if the block
    has one and an encoder output is given."""
    if enc_out is None or block.cross is None:
        return x
    hc = block.norm_cross(x, cfg.rms_norm_eps)
    ek, ev = A.cross_kv(block.cross, enc_out, cfg)
    return x + A.cross_attn_apply(block.cross, hc, ek, ev, cfg)


def block_apply_train(block: Block, x: torch.Tensor,
                      cos: Optional[torch.Tensor],
                      sin: Optional[torch.Tensor], cfg,
                      enc_out: Optional[torch.Tensor] = None,
                      causal: bool = True,
                      tp: Optional[TP.TensorParallel] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D); ``cos``/``sin`` at the block's ``rope_width``
    (None for a Mamba or an RWKV block, and without rope); ``enc_out``
    the encoder output a cross block attends to; ``causal`` False for an
    encoder block.  With ``tp`` (a GQA block with a dense FFN, its
    weights split over ``model``) the attention's and the FFN's inputs
    pass ``copy_to_model``, where the JAX block constrains its
    activations; the norms and the residual stream stay replicated.
    Returns (x', aux)."""
    h = block.norm1(x, cfg.rms_norm_eps)
    if block.mamba:
        x = x + M.mamba_apply(block.mixer, h, cfg)
    elif block.rwkv:
        x = x + R.rwkv_apply(block.mixer, h, cfg)
    elif block.mla:
        x = x + A.mla_apply(block.mixer, h, cos, sin, cfg)
    else:
        x = x + A.attn_apply(block.mixer, TP.copy_to_model(h, tp), cos, sin,
                             cfg, block.window, causal, tp)
    x = _cross(block, x, enc_out, cfg)
    y, aux = _ffn(block, block.norm2(x, cfg.rms_norm_eps), cfg, tp=tp)
    return x + y, aux


def block_init_state(cfg, mixer_kind: str, ffn_kind: str, batch: int,
                     max_len: int, kv_mode: str, page_size: int,
                     pages_per_layer: int, device: torch.device,
                     pool_heads: Optional[Tuple[int, int]] = None
                     ) -> Dict[str, torch.Tensor]:
    """``pool_heads``: the (kv heads, head_dim) of a paged pool, this
    rank's shard of them under a mesh (default: the config's)."""
    st = _mixer_state(cfg, mixer_kind, batch, max_len, kv_mode, page_size,
                      pages_per_layer, device, pool_heads)
    if cfg.rwkv is not None and ffn_kind == C.DENSE_FF:
        st["ffn_shift"] = torch.zeros((batch, cfg.d_model),
                                      dtype=torch.float32, device=device)
    return st


def _mixer_state(cfg, mixer_kind: str, batch: int, max_len: int,
                 kv_mode: str, page_size: int, pages_per_layer: int,
                 device: torch.device,
                 pool_heads: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, torch.Tensor]:
    dt = cfg.torch_dtype
    if mixer_kind == C.RWKV:
        return R.rwkv_init_state(cfg, batch, device)
    if mixer_kind == C.MAMBA:
        return M.mamba_init_state(cfg, batch, device)
    if mixer_kind == C.ATTN_MLA:
        m = cfg.mla
        return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                   dtype=dt, device=device),
                "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dt, device=device)}
    k, hd = cfg.num_kv_heads, cfg.head_dim
    if kv_mode == "dense":
        shape = (batch, max_len, k, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    shape = (pages_per_layer, page_size) + (pool_heads or (k, hd))
    return {"kp": torch.zeros(shape, dtype=dt, device=device),
            "vp": torch.zeros(shape, dtype=dt, device=device)}


def block_apply_decode(block: Block, st: Dict[str, torch.Tensor],
                       x: torch.Tensor, step: A.DecodeStep, cfg,
                       kv_mode: str,
                       enc_out: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """x: (B,1,D).  Updates ``st`` in place; returns x'.  A cross block
    attends to ``enc_out`` after the mixer."""
    h = block.norm1(x, cfg.rms_norm_eps)
    if block.mamba:
        y = M.mamba_decode(block.mixer, h, st, cfg)
    elif block.rwkv:
        y = R.rwkv_decode(block.mixer, h, st, cfg)
    elif block.mla:
        y = A.mla_decode(block.mixer, h, st["ckv"], st["kr"], step, cfg)
    elif kv_mode == "dense":
        y = A.attn_decode_dense(block.mixer, h, st["k"], st["v"], step, cfg,
                                block.window)
    else:
        y = A.attn_decode_paged(block.mixer, h, st["kp"], st["vp"], step,
                                cfg, block.window)
    x = _cross(block, x + y, enc_out, cfg)
    h2 = block.norm2(x, cfg.rms_norm_eps)
    shift_prev = st.get("ffn_shift")
    y2 = _ffn(block, h2, cfg, shift_prev)[0]
    if shift_prev is not None:
        shift_prev.copy_(h2[:, 0].float())
    return x + y2


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------
class Stack(nn.Module):
    """Prefix blocks followed by the periods of ``layer_pattern``, one
    module per layer (``cfg.layer_kinds()`` order); with ``cross`` each
    block has a cross-attention (an encoder-decoder's decoder)."""

    def __init__(self, cfg, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 cross: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(cfg, mk, fk, device, generator, cross)
            for mk, fk in cfg.layer_kinds())


def stack_apply_train(stack: Stack, x: torch.Tensor,
                      positions: torch.Tensor, cfg, *,
                      enc_out: Optional[torch.Tensor] = None,
                      causal: bool = True,
                      tp: Optional[TP.TensorParallel] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D); positions: (B|1, S); ``enc_out``: the encoder output
    of an encoder-decoder's decoder stack; ``causal`` False for its
    encoder; ``tp``: the ``model`` axis the blocks' weights are split
    over.  Returns (x, aux_sum).  The rope tables are built once for
    all layers, one pair for each width a layer rotates (inside a
    checkpointed block they would be rebuilt in the backward's
    recompute).  ``tp`` is an argument of each block, not read from
    the installed mesh, because a checkpointed block's recompute runs
    in the backward, on autograd's own thread for a card."""
    rope = {w: rope_tables(positions, w, cfg.rope_theta)
            for w in A.rope_widths(cfg)}
    aux = torch.zeros((), device=x.device)
    for block in stack.layers:
        cos, sin = rope.get(block.rope_width, (None, None))
        if cfg.remat:
            x, a = checkpoint(block_apply_train, block, x, cos, sin, cfg,
                              enc_out, causal, tp, use_reentrant=False)
        else:
            x, a = block_apply_train(block, x, cos, sin, cfg, enc_out,
                                     causal, tp)
        aux = aux + a
    return x, aux


def stack_init_state(cfg, batch: int, max_len: int, kv_mode: str,
                     page_size: int, pages_per_layer: int,
                     device: torch.device,
                     pool_heads: Optional[Tuple[int, int]] = None
                     ) -> List[Dict[str, Any]]:
    return [block_init_state(cfg, mk, fk, batch, max_len, kv_mode,
                             page_size, pages_per_layer, device, pool_heads)
            for mk, fk in cfg.layer_kinds()]


def reset_recurrent_state(state: List[Dict[str, Any]], slot: int) -> None:
    """Zero batch row ``slot`` of every layer's recurrent state, for a
    new sequence in that slot (a KV cache is read only up to the
    sequence's length, so it needs no reset)."""
    for st in state:
        for key in RECURRENT_STATE:
            if key in st:
                st[key][slot].zero_()


def stack_apply_decode(stack: Stack, state: List[Dict[str, Any]],
                       x: torch.Tensor, lengths: torch.Tensor, cfg, *,
                       kv_mode: str, table=None,
                       enc_out: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """x: (B,1,D); ``enc_out``: the encoder output (B, S_enc, D) the
    cross blocks attend to.  Updates the per-layer states in place;
    returns x.
    The operands all layers share are prepared once for the step; the
    cache length, page size and latent length come from the first layer
    that holds such a cache (an MLA, a Mamba or an RWKV layer has no KV
    cache or pool)."""

    def dim1(key: str) -> int:
        return next((st[key].shape[1] for st in state if key in st), 0)

    step = A.prepare_decode(
        cfg, lengths, kv_mode, table,
        cache_len=dim1("k") if kv_mode == "dense" else 0,
        page_size=dim1("kp") if kv_mode != "dense" else 0,
        latent_len=dim1("ckv"))
    for block, st in zip(stack.layers, state):
        x = block_apply_decode(block, st, x, step, cfg, kv_mode, enc_out)
    return x
