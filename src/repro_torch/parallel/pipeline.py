"""Pipeline parallelism: a GPipe stage runner over ranks (the port of
``repro.parallel.pipeline``).

Each rank of the group is one stage.  Schedule: classic GPipe
fill-drain.  For S stages and M microbatches the loop runs S + M - 1
ticks; stage s computes microbatch (t - s) when 0 <= t - s < M, stage 0
from the input, every other stage from the activation the stage before
it sent (point-to-point ``send`` / ``recv``, through
:mod:`repro_torch.parallel.comm`).  The last stage collects the finished
microbatches and broadcasts them, so every rank returns the whole
output, as the JAX package's ``psum`` of ``outs`` does.  Bubble fraction
= (S - 1) / (S + M - 1).

The stage function must be shape-preserving (d_model in == d_model
out), as the framework's block stacks are.  The runner is forward only:
no path of the JAX package differentiates through it, and the port's
autodiff through it is ROADMAP item 10b-ii-d.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.context import axis_group


def _stage_slice(tree: Any, s: int) -> Any:
    if torch.is_tensor(tree):
        return tree[s]
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, s) for v in tree)
    raise TypeError(f"stage_params leaf of type {type(tree).__name__}")


@torch.no_grad()
def pipeline_run(group_or_mesh, axis: str, stage_fn: Callable,
                 stage_params: Any, x_micro: torch.Tensor) -> torch.Tensor:
    """Run microbatches through pipeline stages laid out on ``axis``.

    ``group_or_mesh``: a ``DeviceMesh`` (the stages are its ``axis``) or
    a process group (its ranks are the stages; ``axis`` is then only a
    name).  stage_fn(params_slice, x) -> x is one stage's computation;
    stage_params is a tree (tensors, dicts, lists) with leading dim ==
    number of stages, of which this rank takes its own slice; x_micro:
    (M, mb, S, D) microbatches, the same on every rank.  Returns the (M,
    mb, S, D) outputs after all stages, on every rank.
    """
    group = (group_or_mesh if not hasattr(group_or_mesh, "mesh_dim_names")
             else axis_group(group_or_mesh, axis))
    n_stages = comm.size(group)
    sid = comm.rank(group)
    m = x_micro.shape[0]
    params_me = _stage_slice(stage_params, sid)
    outs = torch.zeros_like(x_micro)
    buf = torch.empty_like(x_micro[0])
    for t in range(n_stages + m - 1):
        if not 0 <= t - sid < m:
            continue
        if sid == 0:
            x_in = x_micro[t]
        else:
            x_in = comm.recv(buf, sid - 1, group)
        y = stage_fn(params_me, x_in)
        if sid < n_stages - 1:
            comm.send(y, sid + 1, group)
        else:
            outs[t - (n_stages - 1)] = y
    return comm.broadcast(outs, n_stages - 1, group)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages + n_micro - 1)
