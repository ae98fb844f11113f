"""Set-associative LRU caches/TLBs as explicit state tensors.

The port's copy of ``repro.sim.cache_model``, in torch ops.  A cache
instance is a dict of tensors:
    tags: (sets, ways) int32   stored tag+1; 0 = invalid
    lru:  (sets, ways) int32   per-way last-use stamp
    ctr:  ()           int32   monotonic stamp counter

``access`` is a pure function: it returns a new state and leaves its
argument untouched.  Keys are 64B line ids (caches) or VPNs (TLBs); any
int32 key space works (set and tag by truncating division, as
``jax.lax.rem``/``div``; a negative set index wraps, as indexing does in
both packages).  The simulator's engine does not use it: its scan keeps
every table of a chunk in one kernel (``kernels/lru_scan``); this is the
standalone model of one table.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

State = Dict[str, torch.Tensor]


def make(num_sets: int, ways: int, device="cpu") -> State:
    return {
        "tags": torch.zeros((num_sets, ways), dtype=torch.int32,
                            device=device),
        "lru": torch.zeros((num_sets, ways), dtype=torch.int32,
                           device=device),
        "ctr": torch.zeros((), dtype=torch.int32, device=device),
    }


def access(state: State, key, *, insert, enabled) -> Tuple[State, torch.Tensor]:
    """One lookup (+fill on miss if ``insert``).

    key: () int32; insert/enabled: () bool.  Returns (state, hit).
    ``enabled=False`` leaves the tables untouched and reports a miss (the
    stamp counter still advances) — used for bypass (NDPage metadata) and
    invalid access slots.  On a hit the first matching way is refreshed;
    on a miss with ``insert`` the way of least stamp (the first of them)
    takes the tag.
    """
    dev = state["tags"].device
    key = torch.as_tensor(key, dtype=torch.int32, device=dev)
    insert = torch.as_tensor(insert, dtype=torch.bool, device=dev)
    enabled = torch.as_tensor(enabled, dtype=torch.bool, device=dev)
    num_sets = state["tags"].shape[0]
    set_ = torch.fmod(key, num_sets).long()
    tag = torch.div(key, num_sets, rounding_mode="trunc") + 1  # 0 = invalid

    row_tags = state["tags"][set_]                 # (ways,)
    row_lru = state["lru"][set_]
    matches = row_tags == tag
    hit = matches.any() & enabled

    victim = torch.argmin(row_lru)
    way = torch.where(hit, torch.argmax(matches.to(torch.int32)), victim)

    ctr = state["ctr"] + 1
    do_write = enabled & (hit | insert)
    new_tags = state["tags"].clone()
    new_lru = state["lru"].clone()
    new_tags[set_, way] = torch.where(do_write, tag, row_tags[way])
    new_lru[set_, way] = torch.where(do_write, ctr, row_lru[way])
    return {"tags": new_tags, "lru": new_lru, "ctr": ctr}, hit
