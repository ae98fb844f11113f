"""The collectives the parallel paths use, over ``torch.distributed``,
with a count of the bytes each rank hands to them.

Every collective of the port goes through here, so that one rule holds
everywhere: a CUDA tensor on a gloo group takes gloo's CUDA path where
gloo has one (all-reduce, broadcast, all-gather) and is staged through
a host copy, explicitly, where it has none: gloo's send of a CUDA
tensor fails on the H100's host ("writev ... Bad address") and breaks
the pair.  Gloo on CUDA tensors is what two ranks sharing one card run
on (NCCL refuses two ranks on one device); with a card a rank, the
group is NCCL and nothing is staged.  A 16-bit float tensor is gathered
as raw bytes.

:data:`stats` counts, per process, the collectives called and the bytes
of the tensors handed to them (an all-reduce counts its tensor once, an
all-gather the rank's own block, a send or receive its tensor): the
traffic a rank puts on the wire is at most a small multiple of it,
which the algorithm (ring, tree) decides.  :func:`reset_stats` zeroes
it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

#: collectives called and bytes handed to them, in this process
stats: Dict[str, int] = {"calls": 0, "bytes": 0}

#: gloo operations that take CUDA tensors themselves
_GLOO_CUDA = ("all_reduce", "broadcast", "all_gather")


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def _count(t: torch.Tensor) -> None:
    stats["calls"] += 1
    stats["bytes"] += t.numel() * t.element_size()


def _staged(op: str, t: torch.Tensor, group) -> bool:
    """True where ``t`` must go through a host copy for ``op``."""
    return (t.device.type == "cuda" and op not in _GLOO_CUDA
            and dist.get_backend(group) == "gloo")


def _global(group_rank: int, group) -> int:
    return (group_rank if group is None
            else dist.get_global_rank(group, group_rank))


def size(group=None) -> int:
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced over ``group``, in place; returns ``t``."""
    _count(t)
    if size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from the group's rank ``src`` (a group rank), in place."""
    _count(t)
    if size(group) > 1:
        dist.broadcast(t, src=_global(src, group), group=group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    group-rank order."""
    _count(t)
    n = size(group)
    if n == 1:
        return t
    src = t.contiguous()
    if src.element_size() == 2 and dist.get_backend(group) == "gloo":
        # gathered as raw bytes: a copy needs no arithmetic, and gloo's
        # kernels do not take every 16-bit float type
        src = src.view(torch.uint8)
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).view(t.dtype)


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """``t`` to group rank ``dst`` (blocking)."""
    _count(t)
    if _staged("send", t, group):
        t = t.cpu()
    dist.send(t.contiguous(), dst=_global(dst, group), group=group)


def recv(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive into ``t`` from group rank ``src``; returns ``t``."""
    _count(t)
    if _staged("recv", t, group):
        host = torch.empty(t.shape, dtype=t.dtype)
        dist.recv(host, src=_global(src, group), group=group)
        return t.copy_(host)
    dist.recv(t, src=_global(src, group), group=group)
    return t


def rank(group=None) -> int:
    return dist.get_rank(group)


def barrier(group=None, device: Optional[torch.device] = None) -> None:
    """A barrier (an all-reduce of one element on ``device``: a gloo
    group's barrier has no device to wait on)."""
    all_reduce(torch.zeros(1, device=device), group)
