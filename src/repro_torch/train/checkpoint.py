"""Fault-tolerant checkpointing: atomic, keep-last-k (the protocol of
``repro.train.checkpoint``, over a tree of tensors).

Layout per step:
    <dir>/step_000042/
        manifest.json     step, leaf paths/shapes/dtypes, extra (cursor)
        tensors.pt        one CPU tensor per leaf, keyed by its path
    <dir>/LATEST          text file naming the last COMMITTED step

Commit protocol: write into ``step_X.tmp``, then ``os.replace`` ->
``step_X`` and rewrite LATEST; a crash mid-write never corrupts a
committed checkpoint.  A tree is nested dicts, lists, tuples (named
tuples too) and ``nn.Module``s (their named parameters and buffers)
with tensors or Python numbers at the leaves.  ``restore`` copies the
saved tensors into the tensors of ``like`` in place (a full-width
model and its moments are not held twice) and returns the tree.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    if isinstance(tree, nn.Module):
        return ([(n, p) for n, p in tree.named_parameters()]
                + [(n, b) for n, b in tree.named_buffers()])
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return out


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomically save ``tree`` (model / optimizer state) at ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = {k: (v.detach().cpu() if torch.is_tensor(v) else
                  torch.tensor(v))
              for k, v in _flatten(tree)}
    torch.save(leaves, os.path.join(tmp, "tensors.pt"))
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(t.shape), "dtype": str(t.dtype)}
                   for k, t in leaves.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                     # atomic commit
    _write_latest(ckpt_dir, step)
    _gc(ckpt_dir, keep)
    return final


def _write_latest(ckpt_dir: str, step: int) -> None:
    tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _fill(like, data: Dict[str, torch.Tensor], prefix: str = ""):
    kids = _children(like)
    if kids is None:
        saved = data[prefix]
        if torch.is_tensor(like):
            if tuple(saved.shape) != tuple(like.shape):
                raise ValueError(f"{prefix}: saved shape {tuple(saved.shape)}"
                                 f" != {tuple(like.shape)}")
            with torch.no_grad():
                like.copy_(saved)
            return like
        return type(like)(saved.item())
    if isinstance(like, nn.Module):
        for key, child in kids:
            _fill(child, data, f"{prefix}/{key}" if prefix else key)
        return like
    filled = [_fill(child, data, f"{prefix}/{key}" if prefix else key)
              for key, child in kids]
    if isinstance(like, dict):
        return dict(zip(like.keys(), filled))
    if hasattr(like, "_fields"):               # a named tuple
        return type(like)(*filled)
    return type(like)(filled)


def restore(ckpt_dir: str, like, step: Optional[int] = None
            ) -> Tuple[Any, Dict]:
    """Restore into the structure (and the tensors) of ``like``.
    Returns (tree, extra)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    data = torch.load(os.path.join(final, "tensors.pt"), weights_only=True)
    return _fill(like, data), manifest["extra"]
