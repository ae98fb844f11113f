"""train_step: microbatched gradient accumulation over the model zoo
(counterpart of ``repro.train.train_loop``).

The loss is computed per microbatch (logits never exist for the whole
global batch), its softmax cross-entropy in float32 with a z-loss term.
Gradients accumulate in float32 and the AdamW update applies once per
step.  The model's parameters are updated in place; the state's
optimizer moments are float32 dictionaries keyed by parameter name.

Data parallelism (``mesh``, a ``DeviceMesh`` of this rank's process
group): each rank trains on its own rows of the global batch
(``SyntheticLM.batch_at(step, rank, world)``) in ``num_microbatches``
microbatches of its own, and the gradients, the loss and its parts are
averaged over the mesh's batch axes (``pod``, ``data``); with
``compress`` (``parallel.compression.make_dp_int8_allreduce``) that
reduction is the int8 all-reduce, after accumulation and before AdamW,
where the JAX step applies ``compress``.  Rank r's microbatch j is rows
``[(r * n + j) * B / (n * dp), ...)`` of the global batch: the JAX
step's microbatch ``r * n + j`` of ``n * dp``, so a step on ``dp``
ranks equals the JAX single-device step in ``n * dp`` microbatches, the
MoE routing groups included; only the gradient sums run in another
order.  With ``cfg.fsdp`` (:func:`shard_train_state`) each parameter
and its AdamW moments are stored sharded over ``data`` on the dim
``parallel.sharding.param_spec`` gives; the step gathers the
parameters for the forward, reduces the gradients and keeps this
rank's block, updates the blocks, and clips by the norm of the whole
gradient (the shards' squared norms summed over the ranks).

Tensor parallelism (a ``model`` axis above 1, ``parallel.tensor``):
:func:`shard_train_state` cuts each parameter the ``model`` axis splits
(``parallel.sharding.train_spec``) and its AdamW moments to this rank's
block, and the step runs the forward and backward under the mesh
(``context.use_mesh``), so the layers run on their shards between the
``copy_to_model`` / ``reduce_from_model`` boundaries and the loss takes
the vocab-split logits through the vocab-parallel log-sum-exp and gold
logit.  The ranks of one ``model`` group read the same rows, so a step
on a ``(d, m)`` mesh still equals the JAX single-device step in ``n x
d`` microbatches.  The gradients of ``wk`` / ``wv`` kept whole where the
kv heads do not divide the axis are partial and are summed over
``model``; every other gradient is the rank's block or, for a
replicated leaf (the norms), equal on every ``model`` rank.  The clip's
norm sums the squared norms of the split leaves over the axes that split
them and counts the replicated leaves once.  It covers the dense
attention stack (``attn`` / ``attn_local`` mixers, dense FFNs); the
other mixers raise (``parallel.tensor.check_supported``: ROADMAP item
10b-ii-b), and so do query heads or an FFN width that do not divide the
axis.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import forward_train, init_params
from repro_torch.models.model_zoo import Model
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import tensor as TP
from repro_torch.parallel.context import (axis_group, axis_rank, axis_size,
                                          use_mesh)
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.util.device import DeviceLike, host_float, resolve_device

Z_LOSS = 1e-4
AUX_WEIGHT = 1e-2
#: the model attribute holding {name: dim} of the parameters stored
#: sharded over ``data`` on that dim (:func:`shard_train_state`)
FSDP_LAYOUT = "fsdp_layout"
#: ... and over ``model`` (tensor parallelism)
MODEL_LAYOUT = "model_layout"
#: the model attribute naming, in parameter order, the parameters kept
#: whole over ``model`` whose gradients are partial there (``wk`` /
#: ``wv`` where the kv heads do not divide the axis)
MODEL_PARTIAL = "model_partial"


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
    if cfg.vision_tokens:
        # prepended vision positions produce logits but have no labels
        logits = logits[:, cfg.vision_tokens:]
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    if mask is None:
        mask = torch.ones(targets.shape, device=logits.device)
    else:
        mask = mask[:, 1:].float()
    tp = TP.tensor_parallel()       # the vocab may be split over model
    logz = TP.vocab_logz(logits, cfg.vocab_size, tp)
    gold = TP.vocab_gold(logits, targets, cfg.vocab_size, tp)
    xent = (logz - gold) * mask
    zloss = Z_LOSS * torch.square(logz) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (xent.sum() + zloss.sum()) / denom + AUX_WEIGHT * aux
    return loss, {"xent": xent.sum().detach() / denom,
                  "aux": aux.detach()}


def decayed_names(model: Model):
    """The parameters AdamW decays: those whose leaf in the JAX
    ``init_params`` tree has ``ndim >= 2``.  The parameters of the
    scanned layers carry the stacked period axis there, so their norm
    scales (1-D here, (periods, d) there) are decayed: the decoder
    stack's layers after the prefix (their ``norm_cross`` too) and
    every layer of an encoder-decoder's encoder (its stack has no
    prefix); the prefix layers' norm scales, the final norm's and
    ``enc_norm``'s are not."""
    n_prefix = len(model.cfg.prefix_pattern)

    def stacked(name: str) -> bool:  # "<stack|encoder>.layers.<i>.<...>"
        top, _, rest = name.partition(".")
        return (top == "encoder" or top == "stack"
                and int(rest.split(".")[1]) >= n_prefix)

    return {n for n, p in model.named_parameters()
            if p.ndim + stacked(n) >= 2}


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    """The global batch cut into n microbatches along the batch dim."""
    for v in batch.values():
        if v.shape[0] % n:
            raise ValueError(f"batch {v.shape[0]} not divisible into {n} "
                             "microbatches")
    return [{k: v.chunk(n)[i] for k, v in batch.items()} for i in range(n)]


class DataParallel:
    """The parallel sides of a step on ``mesh``: the process group of its
    batch axes (``pod``, ``data``; all ranks when the ``model`` axis is
    1), the group and coordinate of its ``data`` axis, over which FSDP
    storage is split, and its ``model`` axis (``tp``, None at 1)."""

    def __init__(self, mesh):
        self.tp = TP.tensor_parallel(mesh)
        axes = SH.batch_axes(mesh)
        self.size = axis_size(mesh, axes) if axes else 1
        self.group = axis_group(mesh, axes) if axes else None
        has_data = "data" in SH.mesh_axes(mesh)
        self.data_group = axis_group(mesh, "data") if has_data else None
        self.data_size = axis_size(mesh, "data") if has_data else 1
        self.data_rank = axis_rank(mesh, "data") if has_data else 0

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over the batch axes, in place."""
        if self.size > 1:
            comm.all_reduce(t, self.group).div_(self.size)
        return t

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (split over data)."""
        return t.chunk(self.data_size, dim)[self.data_rank].contiguous()

    def gather(self, model: Model) -> Dict[str, torch.Tensor]:
        """Every sharded parameter made whole in place (``p.data``);
        returns the shards it held."""
        layout = getattr(model, FSDP_LAYOUT)
        shards = {}
        for name, p in model.named_parameters():
            if name in layout:
                shards[name] = p.data
                p.data = comm.all_gather(p.data, self.data_group,
                                         layout[name])
        return shards

    def grad_norm(self, grads: Dict[str, torch.Tensor], data_split,
                  model_split) -> float:
        """The norm of the whole gradient: each split leaf's squared norm
        summed over the axes that split it (``data_split``: FSDP blocks;
        ``model_split``: tensor-parallel blocks; a leaf may be in both),
        the replicated leaves' counted once."""
        dev = next(iter(grads.values())).device
        sums = torch.zeros(4, dtype=torch.float32, device=dev)
        for name, g in grads.items():
            at = (name in data_split) + 2 * (name in model_split)
            sums[at] += torch.square(
                torch.linalg.vector_norm(g, dtype=torch.float32))
        # [whole, data, model, both]: data-split sums over data, then
        # the model-split ones (with the blocks of both) over model
        if data_split:
            sums[1::2] = comm.all_reduce(sums[1::2].clone(),
                                         self.data_group)
        if model_split:
            sums[2] = comm.all_reduce(sums[2:].sum(), self.tp.group)
            sums[3] = 0
        return float(torch.sqrt(sums.sum()))


@torch.no_grad()
def shard_train_state(state: TrainState, mesh, cfg) -> TrainState:
    """``state`` (whole, the same on every rank) with each parameter that
    ``train_spec`` splits over ``model``, and under ``cfg.fsdp`` over
    ``data``, and its AdamW moments, cut to this rank's block; the model
    records the layouts (:data:`FSDP_LAYOUT`, :data:`MODEL_LAYOUT`) and
    the leaves whose gradients are partial over ``model``
    (:data:`MODEL_PARTIAL`).  Without a split, ``state`` as it is."""
    TP.check_supported(cfg, SH.mesh_axes(mesh).get("model", 1))
    dp = DataParallel(mesh)
    model = state.params
    specs = SH.train_sharding(model, mesh, cfg)
    layout = (SH.axis_dims(specs, "data")
              if cfg.fsdp and dp.data_size > 1 else {})
    mlayout = SH.axis_dims(specs, "model") if dp.tp else {}
    # in parameter order: every rank must call the collectives in one
    # order (a set's order follows the process's string hash)
    partial = tuple(n for n in specs if dp.tp and n not in mlayout
                    and n.split(".")[-1] in ("wk", "wv"))
    setattr(model, FSDP_LAYOUT, layout)
    setattr(model, MODEL_LAYOUT, mlayout)
    setattr(model, MODEL_PARTIAL, partial)
    params = dict(model.named_parameters())
    cut = {"data": layout, "model": mlayout}
    for name, spec in specs.items():
        spec = SH.P(*(a if a in cut and name in cut[a] else None
                      for a in spec))
        if not any(spec):
            continue
        params[name].data = SH.shard_tensor(params[name].data, spec, mesh)
        for key in ("mu", "nu"):
            state.opt[key][name] = SH.shard_tensor(state.opt[key][name],
                                                   spec, mesh)
    return state


@torch.no_grad()
def logical_state(state: TrainState, mesh=None) -> TrainState:
    """The whole state on the host: every sharded parameter and moment
    gathered over ``data`` and ``model`` (a collective: every rank calls
    it), as a TrainState whose params are ``{name: tensor}`` (the
    parameters and buffers), so the checkpoint it makes is the one a
    single process writes."""
    model = state.params
    layout = getattr(model, FSDP_LAYOUT, {})
    mlayout = getattr(model, MODEL_LAYOUT, {})
    dp = DataParallel(mesh) if layout or mlayout else None

    def whole(name, t):
        if name in layout:
            t = comm.all_gather(t, dp.data_group, layout[name])
        if name in mlayout:
            t = comm.all_gather(t, dp.tp.group, mlayout[name])
        return t.detach().cpu()

    params = {n: whole(n, p) for n, p in model.named_parameters()}
    params.update({n: b.detach().cpu() for n, b in model.named_buffers()})
    opt = {key: {n: whole(n, t) for n, t in state.opt[key].items()}
           for key in ("mu", "nu")}
    opt["step"] = state.opt["step"]
    return TrainState(params=params, opt=opt, rng=state.rng)


def make_train_step(cfg, opt_cfg: AdamWConfig, num_microbatches: int = 1,
                    compress=None, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics), metrics as
    floats: loss, xent, aux, grad_norm, lr (NaN but lr on fake
    tensors).  With ``mesh``, ``batch`` is this rank's rows (those of
    its batch-axes coordinate: the ranks of one ``model`` group read the
    same rows), the state is :func:`shard_train_state`'s, and the
    metrics are the averages over the data-parallel ranks; ``compress``
    (a function of the gradient dictionary) replaces the data-parallel
    mean, or without a mesh transforms the gradients before AdamW."""
    if mesh is not None:
        TP.check_supported(cfg, SH.mesh_axes(mesh).get("model", 1))
    dp = DataParallel(mesh) if mesh is not None else None

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.params
        layout = getattr(model, FSDP_LAYOUT, {}) if dp else {}
        mlayout = getattr(model, MODEL_LAYOUT, {}) if dp else {}
        if dp and dp.tp and not hasattr(model, MODEL_LAYOUT):
            raise ValueError("a model axis above 1 trains the blocks of "
                             "shard_train_state")
        shards = dp.gather(model) if layout else {}
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            loss, grads, parts = _accumulate(model, cfg, batch, params,
                                             num_microbatches)
        gnorm: Optional[float] = None
        if dp is not None:
            for name in getattr(model, MODEL_PARTIAL, ()):
                comm.all_reduce(grads[name], dp.tp.group)
            grads = (compress(grads) if compress is not None
                     else {n: dp.mean(g) for n, g in grads.items()})
            loss = dp.mean(loss.clone())
            parts = {k: dp.mean(v.clone()) for k, v in parts.items()}
            model.zero_grad(set_to_none=True)
            for name, shard in shards.items():
                params[name].data = shard
                grads[name] = dp.block(grads[name], layout[name])
            if layout or mlayout:
                gnorm = dp.grad_norm(grads, layout, mlayout)
        elif compress is not None:
            grads = compress(grads)
        _, opt, om = adamw_update(opt_cfg, params, grads, state.opt,
                                  decay=decayed_names(model), gnorm=gnorm)
        model.zero_grad(set_to_none=True)
        metrics = {"loss": host_float(loss),
                   **{k: host_float(v) for k, v in parts.items()}, **om}
        return TrainState(params=model, opt=opt, rng=state.rng), metrics

    return train_step


def _accumulate(model: Model, cfg, batch: Dict[str, torch.Tensor],
                params: Dict[str, torch.Tensor], num_microbatches: int):
    """(loss, float32 gradients, parts) of ``batch``: the means over its
    microbatches."""
    if num_microbatches == 1:
        loss, parts = loss_fn(model, cfg, batch)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in params.items()}, parts
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
    return (loss / num_microbatches, grads,
            {k: v / num_microbatches for k, v in sums.items()})
