"""Parallelism over ``torch.distributed`` (the port of ``repro.parallel``):
the sharding rules (``sharding``), the mesh context (``context``), the
collectives with their byte count (``comm``), int8 gradient compression
(``compression``), tensor parallelism's boundaries, head layout and
vocab-parallel terms (``tensor``) and the GPipe stage runner
(``pipeline``)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    batch_axes,
    constrain,
    param_sharding,
    param_spec,
    state_sharding,
    valid_spec,
)
