"""Block + stack assembly for training and decode.

The JAX package scans one period of ``layer_pattern`` over stacked
parameters (``lax.scan``); PyTorch runs eagerly, so the stack here is an
``nn.ModuleList`` with one ``Block`` per layer and training and decode
are Python loops over it.  With ``cfg.remat`` each training block runs
under ``torch.utils.checkpoint`` (the JAX side remats each period with
``jax.checkpoint``; internlm2's period is one block).  Decode state is a
list with one dict per layer.  KV backends:
  dense       contiguous per-layer KV cache (the no-translation baseline)
  paged_flat  NDPage flattened single-level block table (one indirection)
  paged_radix 2-level directory->leaf block table (two indirections)

Only the ``(ATTN, DENSE_FF)`` blocks of dense GQA models (gated FFN) are
ported; other kinds raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import config as C
from repro_torch.models import attention as A
from repro_torch.models.layers import FFN, RMSNorm, ffn_apply, rope_tables

_ROADMAP_ITEM = "ROADMAP module queue item 8, other model families"
_NOT_PORTED = {C.ATTN_LOCAL: "sliding-window attention",
               C.ATTN_MLA: "MLA attention", C.MAMBA: "Mamba blocks",
               C.RWKV: "RWKV blocks", C.MOE_FF: "mixture-of-experts FFNs"}


def _check_kinds(cfg, mixer_kind: str, ffn_kind: str) -> None:
    for kind in (mixer_kind, ffn_kind):
        if kind in _NOT_PORTED:
            raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED[kind]} "
                                      f"not ported yet ({_ROADMAP_ITEM})")
    if mixer_kind != C.ATTN or ffn_kind != C.DENSE_FF:
        raise ValueError((mixer_kind, ffn_kind))
    if cfg.rwkv is not None or not cfg.gated_ffn:
        raise NotImplementedError(f"{cfg.name}: only gated FFNs are ported "
                                  f"yet ({_ROADMAP_ITEM})")


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------
class Block(nn.Module):
    def __init__(self, cfg, mixer_kind: str, ffn_kind: str,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_kinds(cfg, mixer_kind, ffn_kind)
        dt = cfg.torch_dtype
        self.norm1 = RMSNorm(cfg.d_model, dt, device)
        self.norm2 = RMSNorm(cfg.d_model, dt, device)
        self.mixer = A.Attention(cfg, dt, device, generator)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, dt, device, generator)


def block_apply_train(block: Block, x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, cfg
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Returns (x', aux); aux is 0 for a dense FFN."""
    h = block.norm1(x, cfg.rms_norm_eps)
    x = x + A.attn_apply(block.mixer, h, cos, sin, cfg)
    h2 = block.norm2(x, cfg.rms_norm_eps)
    return x + ffn_apply(block.ffn, h2), torch.zeros((), device=x.device)


def block_init_state(cfg, batch: int, max_len: int, kv_mode: str,
                     page_size: int, pages_per_layer: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    dt = cfg.torch_dtype
    k, hd = cfg.num_kv_heads, cfg.head_dim
    if kv_mode == "dense":
        shape = (batch, max_len, k, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    shape = (pages_per_layer, page_size, k, hd)
    return {"kp": torch.zeros(shape, dtype=dt, device=device),
            "vp": torch.zeros(shape, dtype=dt, device=device)}


def block_apply_decode(block: Block, st: Dict[str, torch.Tensor],
                       x: torch.Tensor, step: A.DecodeStep, cfg,
                       kv_mode: str) -> torch.Tensor:
    """x: (B,1,D).  Updates ``st`` in place; returns x'."""
    h = block.norm1(x, cfg.rms_norm_eps)
    if kv_mode == "dense":
        y = A.attn_decode_dense(block.mixer, h, st["k"], st["v"], step, cfg)
    else:
        y = A.attn_decode_paged(block.mixer, h, st["kp"], st["vp"], step,
                                cfg)
    x = x + y
    h2 = block.norm2(x, cfg.rms_norm_eps)
    return x + ffn_apply(block.ffn, h2)


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------
class Stack(nn.Module):
    """Prefix blocks followed by the periods of ``layer_pattern``, one
    module per layer (``cfg.layer_kinds()`` order)."""

    def __init__(self, cfg, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(cfg, mk, fk, device, generator)
            for mk, fk in cfg.layer_kinds())


def stack_apply_train(stack: Stack, x: torch.Tensor,
                      positions: torch.Tensor, cfg
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D); positions: (B|1, S).  Returns (x, aux_sum).  The
    rope tables are built once for all layers (inside a checkpointed
    block they would be rebuilt in the backward's recompute)."""
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    aux = torch.zeros((), device=x.device)
    for block in stack.layers:
        if cfg.remat:
            x, a = checkpoint(block_apply_train, block, x, cos, sin, cfg,
                              use_reentrant=False)
        else:
            x, a = block_apply_train(block, x, cos, sin, cfg)
        aux = aux + a
    return x, aux


def stack_init_state(cfg, batch: int, max_len: int, kv_mode: str,
                     page_size: int, pages_per_layer: int,
                     device: torch.device) -> List[Dict[str, Any]]:
    return [block_init_state(cfg, batch, max_len, kv_mode, page_size,
                             pages_per_layer, device)
            for _ in range(cfg.num_layers)]


def stack_apply_decode(stack: Stack, state: List[Dict[str, Any]],
                       x: torch.Tensor, lengths: torch.Tensor, cfg, *,
                       kv_mode: str, table=None) -> torch.Tensor:
    """x: (B,1,D).  Updates the per-layer states in place; returns x.
    The operands all layers share are prepared once for the step."""
    first = state[0]
    step = A.prepare_decode(
        cfg, lengths, kv_mode, table,
        cache_len=first["k"].shape[1] if kv_mode == "dense" else 0,
        page_size=first["kp"].shape[1] if kv_mode != "dense" else 0)
    for block, st in zip(stack.layers, state):
        x = block_apply_decode(block, st, x, step, cfg, kv_mode)
    return x
