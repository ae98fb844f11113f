"""Input, parameter and decode-state specs with no allocation
(counterpart of ``repro.launch.specs``).

The JAX package's specs are ``jax.ShapeDtypeStruct``s; here they are fake
tensors (``torch._subclasses.fake_tensor``: a shape, a dtype and a
device, no storage), all made under :data:`FAKE_MODE`, the one mode this
module owns, so that the specs and the steps ``roofline.flop_stats``
runs on them share it.  Under :data:`FAKE_MODE` the port's
``resolve_device`` accepts ``cuda`` with no card present, since nothing
runs; outside it, asking for a card that is not there still raises.

The default device is the card.  A CPU-only build of PyTorch makes fake
``cuda`` tensors but cannot index them (its indexing takes a CUDA
device guard), so on such a host build the specs with ``device="cpu"``:
the kernels' wrappers route fake tensors by their type, not their
device, so the count is the same.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import config as C
from repro_torch.models import init_decode_state
from repro_torch.models.model_zoo import DEFAULT_PAGE_SIZE, Model
from repro_torch.util.device import DeviceLike, resolve_device

#: the fake-tensor mode of every spec, and of the steps run on them
FAKE_MODE = FakeTensorMode()


def train_input_specs(cfg: C.ArchConfig, shape: C.ShapeConfig,
                      device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Batch specs for a train / prefill step: tokens and labels, and a
    VLM's ``vision_embeds`` and an encoder-decoder's ``audio_frames`` in
    the model dtype."""
    with FAKE_MODE:
        dev = resolve_device(device)
        b, s = shape.global_batch, shape.seq_len
        s_tok = s - cfg.vision_tokens
        ids = dict(dtype=torch.int32, device=dev)
        batch: Dict[str, Any] = {"tokens": torch.empty((b, s_tok), **ids),
                                 "labels": torch.empty((b, s_tok), **ids)}
        act = dict(dtype=cfg.torch_dtype, device=dev)
        if cfg.vision_tokens:
            batch["vision_embeds"] = torch.empty(
                (b, cfg.vision_tokens, cfg.d_model), **act)
        if cfg.is_encdec:
            batch["audio_frames"] = torch.empty(
                (b, cfg.encoder_seq_len, cfg.d_model), **act)
    return batch


def param_specs(cfg: C.ArchConfig, device: DeviceLike = "cuda") -> Model:
    """The whole model with fake weights (frozen, as ``init_params``
    builds it)."""
    with FAKE_MODE:
        return Model(cfg, resolve_device(device))


def decode_state_specs(cfg: C.ArchConfig, shape: C.ShapeConfig,
                       kv_mode: str = "paged_flat",
                       page_size: int = DEFAULT_PAGE_SIZE,
                       device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Decode-state specs for a serve step, the cache at ``seq_len``; an
    attention-free arch has no KV path, so its state is dense."""
    if cfg.attn_free:
        kv_mode = "dense"
    with FAKE_MODE:
        return init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                 kv_mode, page_size, device=device)


def decode_token_specs(shape: C.ShapeConfig,
                       device: DeviceLike = "cuda") -> torch.Tensor:
    with FAKE_MODE:
        return torch.empty((shape.global_batch,), dtype=torch.int32,
                           device=resolve_device(device))
