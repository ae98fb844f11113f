"""A FLOP counter that sees the aten ops and the hand kernels
(counterpart of ``dot_flops`` in ``repro.roofline.hlo_stats``).

The JAX package counts the dots of a compiled step's HLO.  torch has no
HLO, so :func:`flop_stats` counts a step as it runs:
``torch.utils.flop_counter.FlopCounterMode`` counts each aten op it has
a formula for (matrix products, convolutions, attention), and the hand
kernels, which are ``ctypes`` calls it never sees, report their own
counts (``roofline.counts``) from their wrappers, for a launch and for
a fake call alike.  So the same step counted on the card and on fake
tensors gives the same dict.  The collective counters of
``hlo_stats`` (``collective_stats``, ``collective_bytes``,
``count_collectives``) come with the multi-device dry-run.

:func:`step_flops` counts one step of an (arch, shape) cell on
``launch.specs``'s fake tensors, the step ``repro.launch.dryrun`` lowers
for the shape's kind: train (forward, backward with the activation
checkpoints' recompute, AdamW), prefill (the training forward) or decode
(one ``decode_step`` on the flat paged state; an attention-free arch's
state is dense).
Nothing is allocated, and no plain scan is walked: fake tensors take the
kernels' shape-only routes.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.launch import specs as SP
from repro_torch.models import decode_step, forward_train
from repro_torch.roofline import counts
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import (TrainState, make_train_step,
                                          trainable)
from repro_torch.util.device import DeviceLike


@contextlib.contextmanager
def flop_stats() -> Iterator[Dict[str, int]]:
    """Count the FLOPs of the code run inside.  The dict it yields is
    filled on exit: each aten op by name (``aten.mm``, ...), each hand
    kernel by name and direction (``flash_attention_sm90_fwd``,
    ``paged_attention``, ``wkv_bwd``, ...), and ``total``."""
    got: Dict[str, int] = {}
    with counts.recording() as kernels, \
            FlopCounterMode(display=False) as counter:
        yield got
    aten = counter.get_flop_counts().get("Global", {})
    got.update(sorted((str(op), int(n)) for op, n in aten.items()))
    got.update(sorted(kernels.items()))
    got["total"] = sum(got.values())


def step_flops(cfg: C.ArchConfig, shape: C.ShapeConfig, *,
               device: DeviceLike = "cuda", microbatches: int = 1
               ) -> Dict[str, int]:
    """:func:`flop_stats` of one step of ``shape``'s kind on fake
    tensors (``device="cpu"`` on a host whose PyTorch has no CUDA; see
    ``launch.specs``).  A train step runs ``make_train_step`` with
    ``microbatches`` microbatches."""
    model = SP.param_specs(cfg, device)
    with SP.FAKE_MODE:
        if shape.kind == "train":
            model = trainable(model)
            state = TrainState(params=model, opt=adamw_init(
                dict(model.named_parameters())), rng=0)
            step = make_train_step(cfg, AdamWConfig(), microbatches)
            batch = SP.train_input_specs(cfg, shape, device)
            with flop_stats() as got:
                step(state, batch)
            return got
        if shape.kind == "prefill":
            batch = SP.train_input_specs(cfg, shape, device)
            del batch["labels"]
            with torch.no_grad(), flop_stats() as got:
                forward_train(model, cfg, batch)
            return got
        kv_mode = "dense" if cfg.attn_free else BT.FLAT
        st = SP.decode_state_specs(cfg, shape, kv_mode, device=device)
        tokens = SP.decode_token_specs(shape, device)
        with flop_stats() as got:
            decode_step(model, cfg, st, tokens, kv_mode)
        return got
