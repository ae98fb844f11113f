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

An encoder-decoder (whisper) adds the ``encoder`` stack and its
``enc_norm``: :func:`_encode` runs the stub frontend's audio frames
(B, S_enc, D) with sinusoidal positions through the non-causal encoder,
``forward_train`` and ``prefill(audio_frames=)`` feed its output to
the decoder's cross-attention, and the decode state carries it as
``enc_out`` (zeros of the model dtype until a prefill encodes frames;
the serving engine has no audio path, as the JAX engine has none).  A
config without rope (``rope_theta <= 0``) adds sinusoidal positions to
the token embeddings instead, in training and in decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.models import transformer as T
from repro_torch.models.layers import (RMSNorm, decode_positions,
                                       dense_init, embed_init, frozen,
                                       sinusoidal_positions)
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import tensor as TP
from repro_torch.parallel.context import (axis_size, current_mesh,
                                          model_size)
from repro_torch.util.device import DeviceLike, resolve_device

DEFAULT_PAGE_SIZE = 64


class Model(nn.Module):
    """Embedding, the decode stack, final norm and LM head (weights in
    the JAX package's ``(d_in, d_out)`` layout).  With
    ``cfg.tie_embeddings`` there is no LM head: the logits are
    ``x @ embed.T``, and the embedding takes its gradient from both
    uses.  An encoder-decoder adds the ``encoder`` stack (the blocks of
    :func:`_encoder_cfg`, no cross-attention) and ``enc_norm``; its
    decoder stack's blocks have cross-attention."""

    def __init__(self, cfg: C.ArchConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = cfg.torch_dtype
        self.embed = frozen(embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, dt, device))
        self.stack = T.Stack(cfg, device, generator, cross=cfg.is_encdec)
        self.final_norm = RMSNorm(cfg.d_model, dt, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        frozen(dense_init(generator, cfg.d_model,
                                          cfg.vocab_size, dt, device)))
        self.encoder = self.enc_norm = None
        if cfg.is_encdec:
            self.encoder = T.Stack(_encoder_cfg(cfg), device, generator)
            self.enc_norm = RMSNorm(cfg.d_model, dt, device)
        self.cfg = cfg


def _encoder_cfg(cfg: C.ArchConfig) -> C.ArchConfig:
    """The encoder's config: ``encoder_layers`` global attention layers
    with the dense FFN, no prefix, no encoder of its own."""
    return dataclasses.replace(
        cfg, num_layers=cfg.encoder_layers,
        layer_pattern=((C.ATTN, C.DENSE_FF),), prefix_pattern=(),
        encoder_layers=0)


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
    ``mixer.kv_norm`` subtrees.  An encoder-decoder's tree adds
    ``encoder`` (a stack tree of :func:`_encoder_cfg`'s blocks) and
    ``enc_norm``, and each decoder block's ``norm_cross`` and ``cross``
    subtrees."""
    model = Model(cfg, resolve_device(device))

    def put(param: torch.Tensor, arr) -> None:
        src = torch.tensor(np.asarray(arr, np.float32))
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(src.shape)} for a parameter of "
                             f"shape {tuple(param.shape)}")
        param.copy_(src.to(param.dtype))

    def put_stack(stack: T.Stack, sub: Dict[str, Any], scfg) -> None:
        n_prefix, period = len(scfg.prefix_pattern), len(scfg.layer_pattern)
        for i, block in enumerate(stack.layers):
            if i < n_prefix:
                bp, at = sub["prefix"][i], ()
            else:
                p, j = divmod(i - n_prefix, period)
                bp, at = sub["scan"][f"block_{j}"], (p,)
            for path, param in _block_leaves(block):
                put(param, _leaf(bp, path)[at])

    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.final_norm.scale, tree["final_norm"]["scale"])
        if model.lm_head is not None:
            put(model.lm_head, tree["lm_head"])
        put_stack(model.stack, tree["stack"], cfg)
        if cfg.is_encdec:
            put_stack(model.encoder, tree["encoder"], _encoder_cfg(cfg))
            put(model.enc_norm.scale, tree["enc_norm"]["scale"])
    return model


def params_to_numpy(model: Model, *, grads: bool = False
                    ) -> Dict[str, Any]:
    """The reverse of :func:`params_from_numpy`: the model's weights (or,
    with ``grads``, their ``.grad``) as float32 numpy arrays in the JAX
    ``init_params`` tree: the prefix blocks in ``stack.prefix``, the
    layers of each ``layer_pattern`` position stacked on the leading
    period axis of ``stack.scan``, no ``lm_head`` with tied
    embeddings; an encoder-decoder's ``encoder`` and ``enc_norm``
    beside them."""
    cfg = model.cfg

    def get(param: torch.Tensor) -> np.ndarray:
        t = param.grad if grads else param
        if t is None:
            raise ValueError("a parameter has no gradient")
        return t.detach().float().cpu().numpy()

    def stack_tree(stack: T.Stack, scfg) -> Dict[str, Any]:
        layers = list(stack.layers)
        n_prefix, period = len(scfg.prefix_pattern), len(scfg.layer_pattern)
        prefix = [_nest((path, get(p)) for path, p in _block_leaves(b))
                  for b in layers[:n_prefix]]
        scan = {}
        for j in range(period if scfg.num_periods else 0):
            blocks = [_block_leaves(b) for b in layers[n_prefix + j::period]]
            scan[f"block_{j}"] = _nest(
                (path, np.stack([get(leaves[k][1]) for leaves in blocks]))
                for k, (path, _) in enumerate(blocks[0]))
        return {"prefix": prefix, "scan": scan}

    out = {"embed": get(model.embed),
           "stack": stack_tree(model.stack, cfg),
           "final_norm": {"scale": get(model.final_norm.scale)}}
    if model.lm_head is not None:
        out["lm_head"] = get(model.lm_head)
    if cfg.is_encdec:
        out["encoder"] = stack_tree(model.encoder, _encoder_cfg(cfg))
        out["enc_norm"] = {"scale": get(model.enc_norm.scale)}
    return out


def _logits(model: Model, cfg, x: torch.Tensor,
            tp: Optional[TP.TensorParallel] = None) -> torch.Tensor:
    """float32 logits; with ``tp`` and a vocab the ``model`` axis divides,
    the rank's vocab block of them (the head's column block, or the
    tied embedding's row block that the lookup reads)."""
    x = model.final_norm(x, cfg.rms_norm_eps)
    if TP.vocab_block(cfg.vocab_size, tp) is not None:
        x = TP.copy_to_model(x, tp)
    head = model.embed.T if model.lm_head is None else model.lm_head
    return (x @ head).float()


def _encode(model: Model, cfg, audio_frames: torch.Tensor) -> torch.Tensor:
    """Stub-frontend encoder: the frames are precomputed embeddings (B,
    S_enc, D).  Sinusoidal positions in the frames' dtype, the
    non-causal encoder stack, ``enc_norm``; float32 frames keep the
    encoder in float32 whatever the weights' dtype, as in the JAX
    package."""
    se = audio_frames.shape[1]
    pos = sinusoidal_positions(se, cfg.d_model, audio_frames.device)
    x = audio_frames + pos.to(audio_frames.dtype)[None]
    positions = torch.arange(se, device=x.device)[None]
    x, _ = T.stack_apply_train(model.encoder, x, positions,
                               _encoder_cfg(cfg), causal=False)
    return model.enc_norm(x, cfg.rms_norm_eps)


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------
def forward_train(model: Model, cfg: C.ArchConfig,
                  batch: Dict[str, torch.Tensor]):
    """batch: tokens (B, S_tok) on the model's device, with
    ``cfg.vision_tokens`` the stub frontend's ``vision_embeds`` (B, Tv,
    D), prepended to the token embeddings, and for an encoder-decoder
    its ``audio_frames`` (B, S_enc, D), which the encoder reads.  A
    config without rope adds sinusoidal positions to the embeddings.
    Returns (logits (B, Tv + S_tok, V) float32, aux_loss scalar).

    Under an installed mesh whose ``model`` axis is above 1
    (``parallel.context.use_mesh``; the train step installs its own)
    the model holds this rank's blocks (``train_loop.shard_train_state``)
    and runs tensor-parallel (``parallel.tensor``): the embedding and
    the head are vocab-parallel where the axis divides the vocab, and
    the logits are the rank's vocab block, never gathered."""
    tp = TP.tensor_parallel()
    if tp is not None:
        TP.check_supported(cfg, tp.size)
    tokens = batch["tokens"]
    x = TP.vocab_embed(model.embed, tokens.long(), cfg.vocab_size, tp)
    if cfg.vision_tokens:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None]
    if cfg.rope_theta <= 0:     # sinusoidal-position archs (whisper)
        x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(
            x.dtype)[None]
    enc_out = (_encode(model, cfg, batch["audio_frames"]) if cfg.is_encdec
               else None)
    x, aux = T.stack_apply_train(model.stack, x, positions, cfg,
                                 enc_out=enc_out, tp=tp)
    return _logits(model, cfg, x, tp), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_decode_state(cfg: C.ArchConfig, batch: int, max_len: int,
                      kv_mode: str = "dense",
                      page_size: int = DEFAULT_PAGE_SIZE,
                      num_pages: int | None = None,
                      device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Zero-initialized decode state on ``device``; an encoder-decoder's
    carries a zero ``enc_out`` (B, S_enc, D) in the model dtype, which
    :func:`prefill` with audio frames replaces.

    For paged modes the default table is the identity pre-mapped layout
    (page p of seq b -> physical b*max_pages+p); the serving engine
    replaces it with KVPageManager-built tables.  ``num_pages`` sizes the
    physical KV pools (default ``batch * max_pages``); callers with a
    host-side page allocator MUST pass their pool size.

    Under a mesh (``parallel.context.use_mesh``) ``batch`` and
    ``num_pages`` count this rank's own sequences and pages (its data
    shard, with shard-local page ids), and a paged pool holds this
    rank's shard of its heads or head_dim over ``model``
    (``parallel.sharding.state_sharding``; ``paged_mode``).  Over a
    ``model`` axis above 1 only paged GQA layers are split; a dense
    cache and the other mixers' state are ROADMAP item 10b-ii-c.
    """
    device = resolve_device(device)
    max_pages = -(-max_len // page_size)
    padded_len = max_pages * page_size
    pages_per_layer = (batch * max_pages if num_pages is None
                       else num_pages)
    state: Dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "stack": T.stack_init_state(
            cfg, batch, padded_len, kv_mode, page_size, pages_per_layer,
            device, _pool_heads(cfg, kv_mode, pages_per_layer, page_size)),
    }
    if kv_mode != "dense":
        flat = torch.arange(batch * max_pages, dtype=torch.int32,
                            device=device).reshape(batch, max_pages)
        state["table"] = (flat if kv_mode == BT.FLAT
                          else BT.radix_from_flat(
                              flat, leaf_size=BT.leaf_size_for(max_pages)))
    if cfg.is_encdec:
        state["enc_out"] = torch.zeros(
            (batch, cfg.encoder_seq_len, cfg.d_model),
            dtype=cfg.torch_dtype, device=device)
    return state


def _pool_heads(cfg: C.ArchConfig, kv_mode: str, pages: int,
                page_size: int) -> Optional[Tuple[int, int]]:
    """This rank's (kv heads, head_dim) of a paged pool under the
    installed mesh's ``model`` axis (None: the config's)."""
    mesh = current_mesh()
    n_model = model_size(mesh)
    if n_model == 1:
        return None
    unsplit = [mk for mk, _ in cfg.layer_kinds()
               if mk not in (C.ATTN, C.ATTN_LOCAL)]
    if kv_mode == "dense" or unsplit:
        raise NotImplementedError(
            f"{cfg.name}: decode over a model axis of {n_model} with "
            f"{'a dense cache' if kv_mode == 'dense' else unsplit[0]} "
            "layers is ROADMAP item 10b-ii-c; the mesh branch splits paged "
            "GQA layers")
    axes = SH.batch_axes(mesh)
    dp = axis_size(mesh, axes) if axes else 1
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    mode = SH.paged_mode(mesh, cfg, n_pages=pages * dp, page=page_size)
    return {"kv": (kh // n_model, hd), "hd": (kh, hd // n_model)}.get(
        mode, (kh, hd))


@torch.no_grad()
def decode_step(model: Model, cfg: C.ArchConfig, state: Dict[str, Any],
                tokens: torch.Tensor, kv_mode: str = "dense"):
    """One decode step. tokens: (B,) int.  Returns (logits (B, V) f32,
    state).  The KV caches in ``state`` are updated in place; the
    returned state carries the new lengths.  A config without rope adds
    the sinusoidal embedding of each sequence's index; an
    encoder-decoder's cross-attention reads ``state["enc_out"]``."""
    lengths = state["lengths"]
    x = model.embed[tokens.long()][:, None, :]
    if cfg.rope_theta <= 0:
        x = x + decode_positions(lengths, cfg.d_model)[:, None, :].to(
            x.dtype)
    x = T.stack_apply_decode(model.stack, state["stack"], x, lengths, cfg,
                             kv_mode=kv_mode, table=state.get("table"),
                             enc_out=state.get("enc_out"))
    logits = _logits(model, cfg, x)[:, 0]
    new_state = dict(state)
    new_state["lengths"] = lengths + 1
    return logits, new_state


def prefill(model: Model, cfg: C.ArchConfig, tokens: torch.Tensor,
            kv_mode: str = "dense", max_len: Optional[int] = None,
            page_size: int = DEFAULT_PAGE_SIZE,
            audio_frames: Optional[torch.Tensor] = None):
    """Sequential prefill through decode_step (exercises the paged append
    path exactly as decode does).  tokens: (B, S_prompt) on the model's
    device; an encoder-decoder needs ``audio_frames`` (B, S_enc, D),
    whose encoding becomes the state's ``enc_out``."""
    b, sp = tokens.shape
    max_len = max_len or (sp + 128)
    state = init_decode_state(cfg, b, max_len, kv_mode, page_size,
                              device=tokens.device)
    if cfg.is_encdec:
        assert audio_frames is not None, (
            f"{cfg.name}: an encoder-decoder prefill needs audio_frames")
        with torch.no_grad():
            state["enc_out"] = _encode(model, cfg, audio_frames)
    logits = None
    for t in range(sp):
        logits, state = decode_step(model, cfg, state, tokens[:, t],
                                    kv_mode)
    return logits, state
