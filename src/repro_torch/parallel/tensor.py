"""Tensor parallelism over the mesh's ``model`` axis: what GSPMD derives
for the JAX package's mesh step, written out for eager PyTorch as
Megatron-style shards held in plain tensors (the hand kernels take plain
CUDA tensors, so nothing on the compute path is a DTensor).

Each rank holds its ``model`` block of every parameter that
``parallel.sharding.train_spec`` splits over ``model`` and computes on
its shard between two boundaries, the JAX package's ``constrain_act``
sites, where an autograd Function runs ``comm.all_reduce`` on the
``model`` group (so ``comm.stats`` counts it):

  copy_to_model      identity forward, all-reduce backward: the input of
                     a column-parallel projection (the attention's q / k
                     / v, the FFN's up and gate, the vocab-parallel LM
                     head), whose gradient each rank holds a part of;
  reduce_from_model  all-reduce forward, identity backward: the output
                     of a row-parallel projection (``wo``, ``w_down``)
                     and of the vocab-parallel embedding lookup.

Between them every rank computes the same replicated activations (the
residual stream, the norms), so their gradients come out equal on every
``model`` rank with no collective of their own.

:func:`head_layout` is a rank's share of the attention heads: ``h / m``
query heads, and the kv heads they read.  Where the kv heads divide the
axis they split with the query heads; else ``wk`` / ``wv`` stay whole on
every rank, each rank projects only the kv heads its query heads read,
and the gradients of ``wk`` / ``wv`` are partial sums that the train
step adds up over ``model``.  Query heads that do not divide the axis
raise: there is no padding and no fallback.

The vocab-parallel terms: :func:`vocab_embed` looks up the ids inside
the rank's vocab block (0 elsewhere) and reduces; :func:`vocab_logz` is
the log-sum-exp over the whole vocab, a MAX all-reduce of the row
maxima, then a SUM all-reduce of the shifted exp-sums; :func:`vocab_gold`
takes the gold logit from the shard that owns it through a SUM
all-reduce.  A vocab that the axis does not divide stays whole
(``valid_spec``'s replicated fallback), and these are the plain
lookup, ``torch.logsumexp`` and ``torch.gather``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import config as C
from repro_torch.parallel import comm
from repro_torch.parallel.context import (axis_group, axis_rank,
                                          current_mesh, model_size)


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the ``model`` axis: its process group, the
    axis size and the rank's coordinate."""
    group: Any
    size: int
    rank: int


def tensor_parallel(mesh=None) -> Optional[TensorParallel]:
    """The ``model`` axis of ``mesh`` (default: the installed mesh,
    ``context.use_mesh``); None without a mesh or where the axis is 1."""
    mesh = current_mesh() if mesh is None else mesh
    n = model_size(mesh)
    if n == 1:
        return None
    return TensorParallel(axis_group(mesh, "model"), n,
                          axis_rank(mesh, "model"))


def check_supported(cfg, n_model: int) -> None:
    """Raise ``NotImplementedError`` where training over a ``model`` axis
    of ``n_model`` is not ported: a mixer other than ``attn`` /
    ``attn_local``, a mixture of experts, an RWKV channel mix and an
    encoder-decoder (item 10b-ii-b), and query heads or an FFN width
    that do not divide the axis."""
    if n_model == 1:
        return
    what = [mk for mk, _ in cfg.layer_kinds()
            if mk not in (C.ATTN, C.ATTN_LOCAL)]
    what += [fk for _, fk in cfg.layer_kinds() if fk != C.DENSE_FF]
    if cfg.rwkv is not None:
        what.append("the RWKV channel mix")
    if cfg.is_encdec:
        what.append("an encoder-decoder")
    if what:
        raise NotImplementedError(
            f"{cfg.name}: training over a model axis of {n_model} with "
            f"{what[0]} layers is ROADMAP item 10b-ii-b; tensor parallelism "
            "covers the dense attention stack (attn / attn_local mixers "
            "with dense FFNs)")
    if cfg.num_heads % n_model:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.num_heads} query heads over a model axis "
            f"of {n_model}: uneven heads (num_heads % model != 0) are not "
            "split; their layout is left to ROADMAP item 10c")
    if cfg.d_ff % n_model:
        raise NotImplementedError(
            f"{cfg.name}: an FFN width of {cfg.d_ff} over a model axis of "
            f"{n_model}: an uneven FFN (d_ff % model != 0) is not split; "
            "its layout is left to ROADMAP item 10c")


def vocab_split(vocab: int, n_model: int) -> bool:
    """Whether the embedding, the LM head and the logits are split over
    vocab: where the axis divides the vocab (else ``valid_spec``'s
    replicated fallback)."""
    return n_model > 1 and vocab % n_model == 0


def kv_split(kv_heads: int, n_model: int) -> bool:
    """Whether ``wk`` / ``wv`` are split with the query heads: where the
    kv heads divide the axis (else whole on every rank)."""
    return kv_heads % n_model == 0


def splits_weight(name: str, cfg, n_model: int) -> bool:
    """Whether the train step holds a ``model`` block of the weight
    ``name`` that the sharding rules split over ``model``: the one rule
    that ``sharding.train_spec`` stores by and the compute path reads
    (:func:`vocab_block`, :func:`head_layout`).  The query heads and the
    FFN width always divide the axis (:func:`check_supported`)."""
    if name in ("embed", "lm_head"):
        return vocab_split(cfg.vocab_size, n_model)
    if name in ("wk", "wv"):
        return kv_split(cfg.num_kv_heads, n_model)
    return True


# ---------------------------------------------------------------------------
# the two boundaries
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.clone(memory_format=torch.contiguous_format),
                               ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: Optional[TensorParallel]
                  ) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``model``."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[TensorParallel]
                      ) -> torch.Tensor:
    """``x`` summed over ``model``; its gradient passed on as it is."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------
class HeadLayout(NamedTuple):
    """A rank's attention heads: its ``heads`` query heads (the rank's
    block of them); the ``kv_heads`` kv heads from ``kv0`` that it
    projects, out of ``wk`` / ``wv`` as its column block (``kv_split``)
    or as columns of the whole weights; ``kv_index``, where the rank's
    query heads fall into their groups unevenly, the kv head (of those
    projected) of each query head, by which k and v are widened to one
    head a query head."""
    heads: int
    kv_heads: int
    kv0: int
    kv_split: bool
    kv_index: Optional[Tuple[int, ...]]


def head_layout(h: int, kh: int, tp: TensorParallel) -> HeadLayout:
    m, r = tp.size, tp.rank
    if h % m:
        raise NotImplementedError(
            f"{h} query heads over a model axis of {m}: uneven heads are "
            "not split")
    hl = h // m
    if kv_split(kh, m):
        return HeadLayout(hl, kh // m, r * (kh // m), True, None)
    g = h // kh
    q0 = r * hl
    lo, hi = q0 // g, (q0 + hl - 1) // g + 1
    index = None if g % hl == 0 else tuple((q0 + i) // g - lo
                                           for i in range(hl))
    return HeadLayout(hl, hi - lo, lo, False, index)


# ---------------------------------------------------------------------------
# vocab-parallel embedding and loss terms
# ---------------------------------------------------------------------------
def vocab_block(vocab: int, tp: Optional[TensorParallel],
                width: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """(first id, ids) of the rank's vocab block; None where the vocab is
    whole on every rank (no axis, or one that does not divide it).
    ``width``: with ``tp``, the vocab rows or columns of the tensor at
    hand (a table, the logits), which must be the block's."""
    if tp is None or not vocab_split(vocab, tp.size):
        block = None
    else:
        n = vocab // tp.size
        block = tp.rank * n, n
    if tp is not None and width is not None and width != (
            vocab if block is None else n):
        raise ValueError(
            f"{width} vocab rows or columns where the rank holds "
            f"{'all' if block is None else n} of {vocab}: shard the weights "
            "over model (train_loop.shard_train_state)")
    return block


def _local_ids(ids: torch.Tensor, block: Tuple[int, int]):
    lo, n = block
    local = ids - lo
    inside = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), inside


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, vocab: int,
                tp: Optional[TensorParallel]) -> torch.Tensor:
    """The embedding rows of ``ids`` from the rank's block of ``table``
    (0 for an id outside it), summed over ``model``."""
    block = vocab_block(vocab, tp, table.shape[0])
    if block is None:
        return table[ids]
    local, inside = _local_ids(ids, block)
    rows = table[local].masked_fill(~inside[..., None], 0)
    return reduce_from_model(rows, tp)


def vocab_logz(logits: torch.Tensor, vocab: int,
               tp: Optional[TensorParallel]) -> torch.Tensor:
    """``logsumexp`` over the whole vocab of the rank's logits (..., V /
    m): the row maxima's MAX over ``model``, then the shifted exp-sums'
    SUM."""
    if vocab_block(vocab, tp, logits.shape[-1]) is None:
        return torch.logsumexp(logits, dim=-1)
    top = comm.all_reduce(logits.detach().amax(dim=-1), tp.group,
                          dist.ReduceOp.MAX)
    sums = torch.exp(logits - top[..., None]).sum(dim=-1)
    return top + torch.log(reduce_from_model(sums, tp))


def vocab_gold(logits: torch.Tensor, targets: torch.Tensor, vocab: int,
               tp: Optional[TensorParallel]) -> torch.Tensor:
    """The logit of each target id, from the shard that holds it."""
    block = vocab_block(vocab, tp, logits.shape[-1])
    if block is None:
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    local, inside = _local_ids(targets, block)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    return reduce_from_model(gold.masked_fill(~inside, 0), tp)

