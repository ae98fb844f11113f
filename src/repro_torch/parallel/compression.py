"""Gradient compression: int8 error-feedback quantization and an int8
all-reduce (the port of ``repro.parallel.compression``).

Each leaf is quantized to int8 with a per-leaf scale; error feedback
carries the quantization error forward (Karimireddy et al. 2019).
:func:`make_dp_int8_allreduce` is the data-parallel reduction of the
train step when ``compress`` is given: each rank quantizes its own
gradient, the ranks take the largest scale, requantize against it so the
codes add, sum the int8 codes widened to int32 and rescale by the
largest scale over the number of ranks.  Gradients are dictionaries
keyed by parameter name (the port's trees).

The arithmetic follows the JAX body step for step in float32
(``torch.round`` and ``jnp.round`` both round half to even), so the int8
codes equal the JAX package's exactly.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import comm
from repro_torch.parallel.context import axis_group

Grads = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_quantize(grads: Grads, error: Grads) -> Tuple[Grads, Grads]:
    """Error-feedback quantization: (dequantized grads, new error)."""
    out, err = {}, {}
    for name, g in grads.items():
        g32 = g.float() + error[name]
        q, s = quantize_int8(g32)
        out[name] = dequantize_int8(q, s)
        err[name] = g32 - out[name]
    return out, err


def zeros_error_like(grads: Grads) -> Grads:
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def requantize_int8(x: torch.Tensor, s_max: torch.Tensor) -> torch.Tensor:
    """``x``'s int8 codes against the scale ``s_max`` (the largest of the
    ranks'), so that the ranks' codes add."""
    return torch.clamp(torch.round(x / s_max), -127, 127).to(torch.int8)


def int8_allreduce(g: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over ``group`` of each rank's ``g``, moved as int8 codes
    (widened to int32 for the sum) against the largest scale; float32."""
    x = g.float()
    _, s = quantize_int8(x)
    s_max = comm.all_reduce(s.clone(), group, dist.ReduceOp.MAX)
    q = requantize_int8(x, s_max)
    total = comm.all_reduce(q.to(torch.int32), group)
    n = torch.tensor(float(comm.size(group)), device=x.device)
    return total.float() * s_max / n


def make_dp_int8_allreduce(mesh, axis: str = "data"
                           ) -> Callable[[Grads], Grads]:
    """The int8 all-reduce over the process group of mesh axis ``axis``
    (or of several axes, a tuple), applied to every leaf of a gradient
    dictionary: each rank's local gradients in, their mean out."""
    group = axis_group(mesh, axis)
    return lambda grads: {n: int8_allreduce(g, group)
                          for n, g in grads.items()}
