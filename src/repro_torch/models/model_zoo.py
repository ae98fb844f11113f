"""Top-level model API: init / train forward / prefill / decode.

Entry points used by train/, serving/ and launch/ (counterparts of
``repro.models.model_zoo``):

  init_params(cfg, generator, device)    -> Model
  params_from_numpy(cfg, tree, device)   -> Model (the JAX weights)
  params_to_numpy(model)                 -> the JAX init_params tree
  forward_train(model, cfg, batch)       -> (logits, aux_loss)
  init_decode_state(cfg, batch, max_len, kv_mode, page_size, ...) -> state
  decode_step(model, cfg, state, tokens, kv_mode) -> (logits, state)
  prefill(model, cfg, tokens, ...)       -> (logits, state)

KV modes: "dense" | "paged_flat" (NDPage) | "paged_radix" (2-level
baseline).  A model's weights are built frozen, for decode; the trainer
(``train.train_loop``) turns ``requires_grad`` on.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.models import transformer as T
from repro_torch.models.layers import (RMSNorm, dense_init, embed_init,
                                       frozen)
from repro_torch.util.device import DeviceLike, resolve_device

DEFAULT_PAGE_SIZE = 64


class Model(nn.Module):
    """Embedding, the decode stack, final norm and LM head (weights in
    the JAX package's ``(d_in, d_out)`` layout).  With
    ``cfg.tie_embeddings`` there is no LM head: the logits are
    ``x @ embed.T``, and the embedding takes its gradient from both
    uses."""

    def __init__(self, cfg: C.ArchConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.is_encdec or cfg.rope_theta <= 0:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder and non-rope models are not "
                "ported yet (ROADMAP module queue item 8d)")
        dt = cfg.torch_dtype
        self.embed = frozen(embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, dt, device))
        self.stack = T.Stack(cfg, device, generator)
        self.final_norm = RMSNorm(cfg.d_model, dt, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        frozen(dense_init(generator, cfg.d_model,
                                          cfg.vocab_size, dt, device)))
        self.cfg = cfg


def model_device(model: Model) -> torch.device:
    return model.embed.device


# ---------------------------------------------------------------------------
# init, and the JAX package's parameter tree
# ---------------------------------------------------------------------------
def init_params(cfg: C.ArchConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Model:
    """Random weights drawn from ``generator`` (which must live on
    ``device``), built directly on the device."""
    return Model(cfg, resolve_device(device), generator)


def _block_leaves(block: T.Block) -> List[Tuple[Tuple[str, ...],
                                                torch.Tensor]]:
    """(path in the JAX block tree, parameter) of every weight of a
    block: the block's modules are named as the JAX tree's subtrees
    (``norm1.scale``, ``mixer.q_norm.scale``, ``ffn.shared.w_up``, ...),
    so a parameter's dotted name is its path."""
    return [(tuple(name.split(".")), p)
            for name, p in block.named_parameters()]


def _nest(leaves) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, value in leaves:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def _leaf(tree: Dict[str, Any], path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def params_from_numpy(cfg: C.ArchConfig, tree: Dict[str, Any],
                      device: DeviceLike = "cuda") -> Model:
    """The port's model holding the weights of a JAX ``init_params`` tree
    given as numpy arrays.  ``stack.prefix`` holds one block per prefix
    layer; ``stack.scan`` holds each ``layer_pattern`` position's blocks
    stacked over the periods, so layer ``i >= len(prefix)`` is period
    ``(i - len(prefix)) // len(pattern)`` of ``block_{(i - len(prefix))
    % len(pattern)}``.  Every weight keeps its ``(d_in, d_out)`` layout,
    so nothing is transposed; an MoE's expert weights are ``(E, d_in,
    d_out)`` there and here, its router float32, its shared experts the
    ``ffn.shared`` subtree, and MLA's norms the ``mixer.q_norm`` and
    ``mixer.kv_norm`` subtrees."""
    model = Model(cfg, resolve_device(device))

    def put(param: torch.Tensor, arr) -> None:
        src = torch.tensor(np.asarray(arr, np.float32))
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(src.shape)} for a parameter of "
                             f"shape {tuple(param.shape)}")
        param.copy_(src.to(param.dtype))

    n_prefix, period = len(cfg.prefix_pattern), len(cfg.layer_pattern)
    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.final_norm.scale, tree["final_norm"]["scale"])
        if model.lm_head is not None:
            put(model.lm_head, tree["lm_head"])
        for i, block in enumerate(model.stack.layers):
            if i < n_prefix:
                bp, at = tree["stack"]["prefix"][i], ()
            else:
                p, j = divmod(i - n_prefix, period)
                bp, at = tree["stack"]["scan"][f"block_{j}"], (p,)
            for path, param in _block_leaves(block):
                put(param, _leaf(bp, path)[at])
    return model


def params_to_numpy(model: Model, *, grads: bool = False
                    ) -> Dict[str, Any]:
    """The reverse of :func:`params_from_numpy`: the model's weights (or,
    with ``grads``, their ``.grad``) as float32 numpy arrays in the JAX
    ``init_params`` tree: the prefix blocks in ``stack.prefix``, the
    layers of each ``layer_pattern`` position stacked on the leading
    period axis of ``stack.scan``, no ``lm_head`` with tied
    embeddings."""
    cfg = model.cfg

    def get(param: torch.Tensor) -> np.ndarray:
        t = param.grad if grads else param
        if t is None:
            raise ValueError("a parameter has no gradient")
        return t.detach().float().cpu().numpy()

    layers = list(model.stack.layers)
    n_prefix, period = len(cfg.prefix_pattern), len(cfg.layer_pattern)
    prefix = [_nest((path, get(p)) for path, p in _block_leaves(b))
              for b in layers[:n_prefix]]
    scan = {}
    for j in range(period if cfg.num_periods else 0):
        blocks = [_block_leaves(b) for b in layers[n_prefix + j::period]]
        scan[f"block_{j}"] = _nest(
            (path, np.stack([get(leaves[k][1]) for leaves in blocks]))
            for k, (path, _) in enumerate(blocks[0]))
    out = {"embed": get(model.embed),
           "stack": {"prefix": prefix, "scan": scan},
           "final_norm": {"scale": get(model.final_norm.scale)}}
    if model.lm_head is not None:
        out["lm_head"] = get(model.lm_head)
    return out


def _logits(model: Model, cfg, x: torch.Tensor) -> torch.Tensor:
    x = model.final_norm(x, cfg.rms_norm_eps)
    head = model.embed.T if model.lm_head is None else model.lm_head
    return (x @ head).float()


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------
def forward_train(model: Model, cfg: C.ArchConfig,
                  batch: Dict[str, torch.Tensor]):
    """batch: tokens (B, S_tok) on the model's device, and with
    ``cfg.vision_tokens`` the stub frontend's ``vision_embeds`` (B, Tv,
    D), prepended to the token embeddings.  Returns (logits (B, Tv +
    S_tok, V) float32, aux_loss scalar)."""
    tokens = batch["tokens"]
    x = model.embed[tokens.long()]
    if cfg.vision_tokens:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, aux = T.stack_apply_train(model.stack, x, positions, cfg)
    return _logits(model, cfg, x), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_decode_state(cfg: C.ArchConfig, batch: int, max_len: int,
                      kv_mode: str = "dense",
                      page_size: int = DEFAULT_PAGE_SIZE,
                      num_pages: int | None = None,
                      device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Zero-initialized decode state on ``device``.

    For paged modes the default table is the identity pre-mapped layout
    (page p of seq b -> physical b*max_pages+p); the serving engine
    replaces it with KVPageManager-built tables.  ``num_pages`` sizes the
    physical KV pools (default ``batch * max_pages``); callers with a
    host-side page allocator MUST pass their pool size.
    """
    device = resolve_device(device)
    max_pages = -(-max_len // page_size)
    padded_len = max_pages * page_size
    pages_per_layer = (batch * max_pages if num_pages is None
                       else num_pages)
    state: Dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "stack": T.stack_init_state(cfg, batch, padded_len, kv_mode,
                                    page_size, pages_per_layer, device),
    }
    if kv_mode != "dense":
        flat = torch.arange(batch * max_pages, dtype=torch.int32,
                            device=device).reshape(batch, max_pages)
        state["table"] = (flat if kv_mode == BT.FLAT
                          else BT.radix_from_flat(
                              flat, leaf_size=BT.leaf_size_for(max_pages)))
    return state


@torch.no_grad()
def decode_step(model: Model, cfg: C.ArchConfig, state: Dict[str, Any],
                tokens: torch.Tensor, kv_mode: str = "dense"):
    """One decode step. tokens: (B,) int.  Returns (logits (B, V) f32,
    state).  The KV caches in ``state`` are updated in place; the
    returned state carries the new lengths."""
    lengths = state["lengths"]
    x = model.embed[tokens.long()][:, None, :]
    x = T.stack_apply_decode(model.stack, state["stack"], x, lengths, cfg,
                             kv_mode=kv_mode, table=state.get("table"))
    logits = _logits(model, cfg, x)[:, 0]
    new_state = dict(state)
    new_state["lengths"] = lengths + 1
    return logits, new_state


def prefill(model: Model, cfg: C.ArchConfig, tokens: torch.Tensor,
            kv_mode: str = "dense", max_len: Optional[int] = None,
            page_size: int = DEFAULT_PAGE_SIZE):
    """Sequential prefill through decode_step (exercises the paged append
    path exactly as decode does).  tokens: (B, S_prompt) on the model's
    device."""
    b, sp = tokens.shape
    max_len = max_len or (sp + 128)
    state = init_decode_state(cfg, b, max_len, kv_mode, page_size,
                              device=tokens.device)
    logits = None
    for t in range(sp):
        logits, state = decode_step(model, cfg, state, tokens[:, t],
                                    kv_mode)
    return logits, state
