"""train_step: microbatched gradient accumulation over the model zoo
(counterpart of ``repro.train.train_loop``).

The loss is computed per microbatch (logits never exist for the whole
global batch), its softmax cross-entropy in float32 with a z-loss term.
Gradients accumulate in float32 and the AdamW update applies once per
step.  The model's parameters are updated in place; the state's
optimizer moments are float32 dictionaries keyed by parameter name.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models import forward_train, init_params
from repro_torch.models.model_zoo import Model
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.util.device import DeviceLike, resolve_device

Z_LOSS = 1e-4
AUX_WEIGHT = 1e-2
_PARALLEL = "ROADMAP module queue item 10, parallel/launch/roofline"


class TrainState(NamedTuple):
    params: Model
    opt: Dict[str, Any]
    rng: int                 # the seed the weights were drawn from


def trainable(model: Model) -> Model:
    """``model`` with ``requires_grad`` on (decode builds it frozen)."""
    return model.requires_grad_(True)


def init_train_state(cfg, seed: int = 0, device: DeviceLike = "cuda"
                     ) -> TrainState:
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = trainable(init_params(cfg, gen, device))
    return TrainState(params=model, opt=adamw_init(
        dict(model.named_parameters())), rng=seed)


def loss_fn(model: Model, cfg, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss with masking + z-loss + aux (the JAX formula)."""
    logits, aux = forward_train(model, cfg, batch)     # (B, S, V) f32
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    if mask is None:
        mask = torch.ones(targets.shape, device=logits.device)
    else:
        mask = mask[:, 1:].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    xent = (logz - gold) * mask
    zloss = Z_LOSS * torch.square(logz) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (xent.sum() + zloss.sum()) / denom + AUX_WEIGHT * aux
    return loss, {"xent": xent.sum().detach() / denom,
                  "aux": aux.detach()}


def decayed_names(model: Model):
    """The parameters AdamW decays: those whose leaf in the JAX
    ``init_params`` tree has ``ndim >= 2``.  Every per-layer parameter
    there carries the stacked period axis, so the layers' norm scales
    (1-D here, (periods, d) there) are decayed and only the final
    norm's scale is not."""
    return {n for n, p in model.named_parameters()
            if p.ndim + n.startswith("stack.") >= 2}


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    """The global batch cut into n microbatches along the batch dim."""
    for v in batch.values():
        if v.shape[0] % n:
            raise ValueError(f"batch {v.shape[0]} not divisible into {n} "
                             "microbatches")
    return [{k: v.chunk(n)[i] for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg, opt_cfg: AdamWConfig, num_microbatches: int = 1,
                    compress=None, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics), metrics as
    floats: loss, xent, aux, grad_norm, lr."""
    if compress is not None:
        raise NotImplementedError(
            f"gradient compression is not ported yet ({_PARALLEL})")
    if mesh is not None:
        raise NotImplementedError(f"meshes are not ported yet ({_PARALLEL})")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.params
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        if num_microbatches == 1:
            loss, parts = loss_fn(model, cfg, batch)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
            loss = loss.detach()
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), device=next(iter(params.values())).device)
            sums: Dict[str, torch.Tensor] = {}
            for mb in _microbatches(batch, num_microbatches):
                mb_loss, mb_parts = loss_fn(model, cfg, mb)
                mb_loss.backward()
                for n, p in params.items():
                    grads[n].add_(p.grad)
                    p.grad = None
                loss += mb_loss.detach()
                for k, v in mb_parts.items():
                    sums[k] = sums.get(k, 0) + v
            torch._foreach_div_(list(grads.values()), num_microbatches)
            loss = loss / num_microbatches
            parts = {k: v / num_microbatches for k, v in sums.items()}
        _, opt, om = adamw_update(opt_cfg, params, grads, state.opt,
                                  decay=decayed_names(model))
        model.zero_grad(set_to_none=True)
        metrics = {"loss": float(loss),
                   **{k: float(v) for k, v in parts.items()}, **om}
        return TrainState(params=model, opt=opt, rng=state.rng), metrics

    return train_step
