"""Logical-axis sharding rules: DP / FSDP / TP / EP over the mesh (the
rules of ``repro.parallel.sharding``, over ``torch.distributed``).

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  Batch shards over (pod, data); tensor-parallel dims over
``model``; MoE experts over ``model`` (expert parallelism); with
``cfg.fsdp`` parameter and optimizer d_model dims additionally shard
over ``data`` (ZeRO-3 analogue).

A spec is a :class:`P`: a tuple with one entry per tensor dim, each
``None``, an axis name or a tuple of names, as a JAX ``PartitionSpec``
(it compares equal, entry for entry, to the JAX ``P`` of the same
entries).  The rules take a ``DeviceMesh`` or any object with
``axis_names`` and a ``shape`` mapping each name to its size, as the
JAX rules take ``tests/test_sharding.py``'s ``FakeMesh``.  Every rule
passes through :func:`valid_spec`, which drops a mesh axis from any
tensor dim it does not divide: small archs degrade to replication on
that dim instead of erroring.

The port's layers are not stacked (one ``nn.Module`` a layer), so a
per-layer parameter has no leading period axis: its spec is the JAX
spec of the stacked leaf with that leading ``None`` removed.
:func:`to_placements` turns a spec into DTensor placements,
:func:`constrain` redistributes a DTensor to a spec, and
:func:`shard_tensor` takes this rank's block of a whole tensor (the
storage a spec gives one rank).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import tensor as TP


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of axis names), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of an object with
    ``axis_names`` and ``shape[name]``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def valid_spec(spec: Sequence, shape: Tuple[int, ...], mesh,
               allow_uneven: bool = False) -> P:
    """Drop mesh axes that don't divide their tensor dim (graceful TP).

    ``allow_uneven``: keep a single axis on a non-divisible dim when the
    dim is at least the axis size (the shards are then uneven, as
    ``torch.chunk`` cuts them).  Used for activation constraints, never
    for parameters.
    """
    sizes = mesh_axes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    used: set = set()
    for dim, axes in zip(shape, entries):
        if axes is None:
            out.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        keep: list = []
        rem = dim
        for a in tup:
            if a not in sizes or a in used:
                continue
            size = sizes[a]
            if rem % size == 0:
                keep.append(a)
                used.add(a)
                rem //= size
            elif allow_uneven and not keep and rem >= size:
                keep.append(a)
                used.add(a)
                rem = -(-rem // size)
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return P(*out)


# ---------------------------------------------------------------------------
# parameter rules, dispatched on the parameter's name
# ---------------------------------------------------------------------------
def _rule_for(path: Tuple[str, ...], ndim: int, fsdp: bool) -> P:
    """Spec for the TRAILING logical dims of a parameter."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    dp = "data" if fsdp else None

    if name == "embed" or name == "lm_head":
        return P("model", dp) if name == "embed" else P(dp, "model")
    # attention
    if name in ("wq", "wk", "wv"):
        return P(dp, "model")
    if name == "wo":
        return P("model", dp)
    # MLA
    if name in ("w_dq", "w_dkv"):
        return P(dp, None)
    if name in ("w_uq", "w_uk", "w_uv"):
        return P(None, "model")
    # MoE experts: EP over model on the expert dim + fsdp on d_model/d_ff
    if parent == "ffn" and name in ("w_up", "w_gate", "w_down") and ndim >= 3:
        return P("model", dp, None)
    if name == "router":
        return P(dp, None)
    # dense FFN (incl. shared experts, rwkv channel-mix w_k/w_v)
    if name in ("w_up", "w_gate", "w_k"):
        return P(dp, "model")
    if name in ("w_down", "w_v"):
        return P("model", dp)
    # mamba
    if name == "in_proj":
        return P(dp, "model")
    if name in ("conv_w", "conv_b", "x_proj", "A_log", "D"):
        return P("model")
    if name == "dt_proj":
        return P(None, "model")
    if name == "out_proj":
        return P("model", dp)
    # rwkv time-mix
    if name in ("w_r", "w_g"):
        return P(dp, "model")
    if name == "w_o":
        return P("model", dp)
    if name in ("w_A", "w_B"):
        return P(None, None)
    # norms, biases, scalars, mixes: replicate
    return P()


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               fsdp: bool) -> P:
    """The spec of one parameter (the port's layers carry no period
    axis, so there is no ``scanned`` flag)."""
    return valid_spec(_rule_for(path, len(shape), fsdp), shape, mesh)


def param_sharding(model, mesh, cfg) -> Dict[str, P]:
    """{name: spec} for each of the model's ``named_parameters`` (fake
    tensors too)."""
    return {name: param_spec(tuple(name.split(".")), tuple(p.shape), mesh,
                             cfg.fsdp)
            for name, p in model.named_parameters()}


def train_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               cfg) -> P:
    """The storage of one parameter in the port's train step: its
    :func:`param_spec`, with the ``model`` split kept only where the
    compute path splits the weight (``parallel.tensor.splits_weight``).
    ``valid_spec`` keeps ``wk`` / ``wv``'s column split wherever ``kh x
    head_dim`` divides the axis, which can cut a head in two (gemma3-1b's
    one kv head at ``model`` 2); GSPMD reshards that away, eager code
    cannot run attention on half a head, so those weights stay whole on
    every rank (``parallel.tensor.head_layout``)."""
    spec = param_spec(path, shape, mesh, cfg.fsdp)
    if not TP.splits_weight(path[-1], cfg, mesh_axes(mesh).get("model", 1)):
        spec = P(*(None if a == "model" else a for a in spec))
    return spec


def train_sharding(model, mesh, cfg) -> Dict[str, P]:
    """{name: :func:`train_spec`} for each of the model's parameters."""
    return {name: train_spec(tuple(name.split(".")), tuple(p.shape), mesh,
                             cfg)
            for name, p in model.named_parameters()}


def axis_dims(specs: Dict[str, P], axis: str) -> Dict[str, int]:
    """{name: dim} of the specs that split a dim over ``axis``."""
    out = {}
    for name, spec in specs.items():
        for d, axes in enumerate(spec):
            if axes is not None and axis in (
                    (axes,) if isinstance(axes, str) else axes):
                out[name] = d
    return out


# ---------------------------------------------------------------------------
# decode-state rules
# ---------------------------------------------------------------------------
QHEAD_POOL_BUDGET = 12 * 2 ** 30


def qhead_strategy(mesh, *, h: int, kh: int, hd: int, n_attn_layers: int,
                   n_pages: int, page: int) -> bool:
    """The paged-KV decode layout when kv heads do not divide ``model``
    (the JAX package's H5 rule).

    True  -> query heads shard over "model", pool replicated over "model"
             (no score all-reduce; softmax fully local): MQA / small-K
             archs whose total pool fits the per-device budget.
    False -> head_dim shards over "model"; float32 score partials are
             all-reduced.
    Storage (:func:`state_sharding`) and compute (the paged decode's mesh
    branch) both read it.
    """
    n_model = mesh_axes(mesh)["model"]
    dp = _axis_size(mesh, batch_axes(mesh))
    bytes_repl = (n_pages * page * kh * hd * 2 * 2 * n_attn_layers
                  // max(dp, 1))
    return (h % n_model == 0 and kh < n_model
            and bytes_repl <= QHEAD_POOL_BUDGET)


def _n_attn_layers(cfg) -> int:
    return sum(1 for mk, _ in cfg.layer_kinds()
               if mk in ("attn", "attn_local"))


def paged_mode(mesh, cfg, *, n_pages: int, page: int) -> str:
    """How the paged pools (``n_pages`` over the whole mesh) lie over
    ``model``: "kv" (kv heads divide it), "qhead" (:func:`qhead_strategy`:
    pools replicated, query heads split), "hd" (head_dim split) or
    "replicated" (none divides: every model rank attends over every
    head)."""
    n_model = mesh_axes(mesh).get("model", 1)
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    if kh % n_model == 0:
        return "kv" if n_model > 1 else "replicated"
    if qhead_strategy(mesh, h=cfg.num_heads, kh=kh, hd=hd,
                      n_attn_layers=_n_attn_layers(cfg), n_pages=n_pages,
                      page=page):
        return "qhead"
    return "hd" if hd % n_model == 0 else "replicated"


def _state_rule(name: str, shape, mesh, batch: Tuple[str, ...],
                cfg=None) -> P:
    """KV caches / recurrent state. Batch axes shard sequences across
    (pod, data)."""
    n_model = mesh_axes(mesh).get("model", 1)
    if name in ("k", "v"):            # dense cache (B, S, K, H)
        rule = [batch, "model", None, None]
        if shape[-2] % n_model == 0:   # prefer heads; else the sequence
            rule = [batch, None, "model", None]
    elif name in ("kp", "vp"):        # paged pools (N, page, K, H)
        kv_heads = shape[-2]
        if kv_heads % n_model == 0:
            rule = [batch, None, "model", None]
        elif cfg is not None and qhead_strategy(
                mesh, h=cfg.num_heads, kh=kv_heads, hd=shape[-1],
                n_attn_layers=_n_attn_layers(cfg), n_pages=shape[-4],
                page=shape[-3]):
            rule = [batch, None, None, None]      # replicate over model
        else:
            rule = [batch, None, None, "model"]   # shard head_dim
    elif name == "ckv":               # MLA latent (B, S, lora)
        rule = [batch, None, "model"]
    elif name == "kr":
        rule = [batch, None, None]
    elif name in ("conv", "ssm"):     # mamba (B, d_in, K) / (B, d_in, N)
        rule = [batch, "model", None]
    elif name == "wkv":               # rwkv (B, H, hs, hs)
        rule = [batch, "model", None, None]
    elif name in ("shift", "ffn_shift"):
        rule = [batch, None]
    else:
        rule = [None] * len(shape)
    return valid_spec(rule, shape, mesh)


def state_sharding(state, mesh, cfg) -> Dict[str, Any]:
    """Specs in the structure of a decode state (``init_decode_state``
    without a mesh: the whole batch, every page)."""
    batch = batch_axes(mesh)

    def spec_of(name: str, leaf) -> P:
        shape = tuple(leaf.shape)
        if name == "lengths":
            return valid_spec([batch], shape, mesh)
        if name in ("table", "directory", "leaves"):
            return valid_spec([batch] if name != "leaves" else [], shape,
                              mesh)
        if name == "enc_out":
            return valid_spec([batch, None, None], shape, mesh)
        return _state_rule(name, shape, mesh, batch, cfg)

    def walk(name: str, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        if dataclasses.is_dataclass(node):          # a RadixTable
            # the JAX tree names its two leaves by flat index, which no
            # rule names: both are replicated there, and so here
            return type(node)(**{f.name: walk("", getattr(node, f.name))
                                 for f in dataclasses.fields(node)})
        if isinstance(node, (list, tuple)):
            return [walk(name, v) for v in node]
        return spec_of(name, node)

    return walk("", state)


# ---------------------------------------------------------------------------
# specs as storage: DTensor placements and a rank's block
# ---------------------------------------------------------------------------
def _mesh_dims(mesh) -> List[str]:
    return list(mesh_axes(mesh))


def to_placements(spec: Sequence, mesh) -> list:
    """DTensor placements, one for each mesh dimension: ``Shard(d)`` for
    the tensor dim ``d`` whose entry names the mesh axis, ``Replicate()``
    for an axis no entry names.  A tensor dim split over several axes is
    split in the mesh's axis order."""
    from torch.distributed.tensor import Replicate, Shard

    where: Dict[str, int] = {}
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate()
            for a in _mesh_dims(mesh)]


def constrain(x, mesh, *entries):
    """``x`` laid out as ``entries`` (divisibility-checked): a DTensor is
    redistributed; a plain tensor, the same whole tensor on every rank,
    is distributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    sp = valid_spec(entries, tuple(x.shape), mesh)
    placements = to_placements(sp, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)


def axis_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each mesh axis."""
    return {a: mesh.get_local_rank(a) for a in _mesh_dims(mesh)}


def block(shape: Sequence[int], spec: Sequence, mesh,
          coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that the rank at ``coords``
    holds under ``spec`` (even splits; a dim over several axes is split
    in the spec's axis order, major first, as JAX lays it out)."""
    sizes = mesh_axes(mesh)
    out = []
    for d, dim in enumerate(shape):
        axes = spec[d] if d < len(spec) else None
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        n, idx = 1, 0
        for a in axes:
            n, idx = n * sizes[a], idx * sizes[a] + coords[a]
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec: Sequence, mesh,
                 coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``, a
    contiguous copy (``coords``: the rank's axis coordinates, by default
    read from a ``DeviceMesh``)."""
    coords = axis_coords(mesh) if coords is None else coords
    return t[block(t.shape, spec, mesh, coords)].contiguous()


def shard_state(state, mesh, cfg, coords: Optional[Dict[str, int]] = None):
    """This rank's shard of a whole decode state, leaf by leaf, per
    :func:`state_sharding`."""
    specs = state_sharding(state, mesh, cfg)
    coords = axis_coords(mesh) if coords is None else coords

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if dataclasses.is_dataclass(node):
            return type(node)(**{f.name: walk(getattr(node, f.name),
                                              getattr(spec, f.name))
                                 for f in dataclasses.fields(node)})
        if isinstance(node, (list, tuple)):
            return [walk(v, s) for v, s in zip(node, spec)]
        return shard_tensor(node, spec, mesh, coords)

    return walk(state, specs)
