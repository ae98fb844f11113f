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

from typing import Any, Dict, Optional

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
    the JAX package's ``(d_in, d_out)`` layout)."""

    def __init__(self, cfg: C.ArchConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (cfg.is_encdec or cfg.vision_tokens or cfg.rope_theta <= 0
                or cfg.tie_embeddings or cfg.prefix_pattern):
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder, vision, non-rope, tied-"
                "embedding and prefix-layer models are not ported yet "
                "(ROADMAP module queue item 8)")
        dt = cfg.torch_dtype
        self.embed = frozen(embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, dt, device))
        self.stack = T.Stack(cfg, device, generator)
        self.final_norm = RMSNorm(cfg.d_model, dt, device)
        self.lm_head = frozen(dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, dt, device))
        self.cfg = cfg


def model_device(model: Model) -> torch.device:
    return model.embed.device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: C.ArchConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Model:
    """Random weights drawn from ``generator`` (which must live on
    ``device``), built directly on the device."""
    return Model(cfg, resolve_device(device), generator)


def params_from_numpy(cfg: C.ArchConfig, tree: Dict[str, Any],
                      device: DeviceLike = "cuda") -> Model:
    """The port's model holding the weights of a JAX ``init_params`` tree
    given as numpy arrays.  The stacked period axis of ``stack.scan``
    is split into one module per layer; every weight keeps its
    ``(d_in, d_out)`` layout, so nothing is transposed."""
    model = Model(cfg, resolve_device(device))

    def put(param: torch.Tensor, arr) -> None:
        src = torch.tensor(np.asarray(arr, np.float32))
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(src.shape)} for a parameter of "
                             f"shape {tuple(param.shape)}")
        param.copy_(src.to(param.dtype))

    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.final_norm.scale, tree["final_norm"]["scale"])
        put(model.lm_head, tree["lm_head"])
        for i, block in enumerate(model.stack.layers):
            period, j = divmod(i, len(cfg.layer_pattern))
            bp = tree["stack"]["scan"][f"block_{j}"]
            put(block.norm1.scale, bp["norm1"]["scale"][period])
            put(block.norm2.scale, bp["norm2"]["scale"][period])
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(block.mixer, name), bp["mixer"][name][period])
            for name in ("w_up", "w_down", "w_gate"):
                put(getattr(block.ffn, name), bp["ffn"][name][period])
    return model


def params_to_numpy(model: Model, *, grads: bool = False
                    ) -> Dict[str, Any]:
    """The reverse of :func:`params_from_numpy`: the model's weights (or,
    with ``grads``, their ``.grad``) as float32 numpy arrays in the JAX
    ``init_params`` tree, the layers of each ``layer_pattern`` position
    stacked on the leading period axis of ``stack.scan``."""
    cfg = model.cfg

    def get(param: torch.Tensor) -> np.ndarray:
        t = param.grad if grads else param
        if t is None:
            raise ValueError("a parameter has no gradient")
        return t.detach().float().cpu().numpy()

    period = len(cfg.layer_pattern)
    scan = {}
    for j in range(period):
        blocks = list(model.stack.layers)[j::period]
        stack = lambda f: np.stack([get(f(b)) for b in blocks])  # noqa: E731
        scan[f"block_{j}"] = {
            "norm1": {"scale": stack(lambda b: b.norm1.scale)},
            "norm2": {"scale": stack(lambda b: b.norm2.scale)},
            "mixer": {n: stack(lambda b, n=n: getattr(b.mixer, n))
                      for n in ("wq", "wk", "wv", "wo")},
            "ffn": {n: stack(lambda b, n=n: getattr(b.ffn, n))
                    for n in ("w_up", "w_down", "w_gate")},
        }
    return {"embed": get(model.embed),
            "stack": {"prefix": [], "scan": scan},
            "final_norm": {"scale": get(model.final_norm.scale)},
            "lm_head": get(model.lm_head)}


def _logits(model: Model, cfg, x: torch.Tensor) -> torch.Tensor:
    x = model.final_norm(x, cfg.rms_norm_eps)
    return (x @ model.lm_head).float()


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------
def forward_train(model: Model, cfg: C.ArchConfig,
                  batch: Dict[str, torch.Tensor]):
    """batch: tokens (B, S) on the model's device.  Returns (logits
    (B, S, V) float32, aux_loss scalar)."""
    tokens = batch["tokens"]
    x = model.embed[tokens.long()]
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
