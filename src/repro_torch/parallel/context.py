"""The mesh context (the port of ``repro.parallel.context``).

Models stay mesh-agnostic; a launcher, a test or the serving path
installs a ``DeviceMesh`` here with :func:`use_mesh`, and the code that
has a mesh branch (the paged decode, ``models/attention.py``; the decode
state's pools, ``models/model_zoo.py``) reads :func:`current_mesh`.
Without an installed mesh every such branch is skipped.

:func:`constrain_act` is the activation constraint of the JAX package:
a no-op without a mesh or when ``x`` is not a DTensor, else a
redistribution of ``x`` to ``valid_spec(..., allow_uneven=True)``.  The
port's eager layers take plain tensors, so in tensor-parallel training
the JAX package's ``constrain_act`` sites (the attention's q / k / v and
output, the FFN's up projection, the block's residual stream) are the
boundaries of ``parallel.tensor``: ``copy_to_model`` before the
attention and the FFN (``models/transformer.py`` ``block_apply_train``),
``reduce_from_model`` after ``wo`` and ``w_down``
(``models/attention.py`` ``attn_apply``, ``models/layers.py``
``ffn_apply``).  Training installs its mesh here for the forward and
backward (``train.train_loop.make_train_step``).

:func:`axis_group` is the process group of one mesh axis or of several
(the batch axes ``("pod", "data")`` together), and :func:`axis_rank`
this rank's place on them.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Union

_state = threading.local()

BATCH = "__batch__"   # placeholder resolved to ("pod", "data") of the mesh


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def constrain_act(x, *entries):
    """``x`` redistributed to ``entries`` (divisibility-checked, uneven
    splits allowed) when a mesh is installed and ``x`` is a DTensor;
    else ``x``.  Use the BATCH sentinel for the batch dimension; e.g.
    ``constrain_act(x, BATCH, None, "model")``."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.parallel.sharding import (batch_axes, to_placements,
                                               valid_spec)
    resolved = tuple(batch_axes(mesh) if e == BATCH else e for e in entries)
    spec = valid_spec(resolved, tuple(x.shape), mesh, allow_uneven=True)
    return x.redistribute(mesh, to_placements(spec, mesh))


def _names(axes: Union[str, Sequence[str]]) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_group(mesh, axes: Union[str, Sequence[str]]):
    """The process group of the ranks that differ only on ``axes`` (one
    axis name or several)."""
    names = _names(axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def axis_size(mesh, axes: Union[str, Sequence[str]]) -> int:
    from repro_torch.parallel.sharding import mesh_axes
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in _names(axes))


def axis_rank(mesh, axes: Union[str, Sequence[str]]) -> int:
    """This rank's index on ``axes`` (major first)."""
    from repro_torch.parallel.sharding import mesh_axes
    sizes = mesh_axes(mesh)
    idx = 0
    for a in _names(axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def model_size(mesh: Optional[object]) -> int:
    """The size of the ``model`` axis (1 without a mesh)."""
    if mesh is None:
        return 1
    from repro_torch.parallel.sharding import mesh_axes
    return mesh_axes(mesh).get("model", 1)
