"""AdamW with decoupled weight decay, global-norm clipping and a
linear-warmup + cosine-decay schedule: the JAX package's formula
(``repro.train.optimizer``), written with ``torch._foreach_*`` ops.

``torch.optim.AdamW`` is not that formula: it keeps bf16 moments for
bf16 parameters and neither clips nor exempts vectors from decay.  Here
the moments are float32, the gradients are clipped by their global
norm, decay applies only to parameters with ``ndim >= 2``, and the
update is computed in float32 and cast to the parameter's dtype.

Parameters and their moments are dictionaries keyed by parameter name.
The update writes the parameters and moments in place (the JAX update
returns new arrays; in place saves a copy of every tensor at full width)
and runs over groups of at most :data:`GROUP_ELEMENTS` elements, a
tensor larger than that (deepseek-v2's 1.26 G-element expert weights) in
flat pieces, so its float32 temporaries stay a few GB however large the
model or any one weight.  The global norm takes each gradient's float32
norm without a float32 copy of the gradients.  On fake tensors
(``launch.specs``: shapes, no storage) the update runs as one group of
whole tensors, since there are no temporaries to bound, and its gradient
norm is NaN.
"""
from __future__ import annotations

import math
from typing import Collection, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.util.device import host_float, is_fake

#: elements per group of parameters the update processes at once
GROUP_ELEMENTS = 1 << 27


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``, computed in float32 as the JAX
    package does."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi) * t))
    return float(cfg.lr * warm * cos)


def adamw_init(params: Dict[str, torch.Tensor]) -> Dict[str, object]:
    zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                    device=p.device)
                     for n, p in params.items()}
    return {"mu": zeros(), "nu": zeros(), "step": 0}


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
    return torch.sqrt(sum(torch.square(n) for n in norms))


Piece = Tuple[str, int, int]     # (name, first flat element, end)


def _groups(names: List[str], params: Dict[str, torch.Tensor]
            ) -> List[List[Piece]]:
    """Pieces of at most GROUP_ELEMENTS elements in groups of at most as
    many, in ``names`` order; fake tensors, one group of whole
    tensors."""
    if names and is_fake(params[names[0]]):
        return [[(n, 0, params[n].numel()) for n in names]]
    groups: List[List[Piece]] = []
    cur: List[Piece] = []
    size = 0
    for n in names:
        numel = params[n].numel()
        for a in range(0, max(numel, 1), GROUP_ELEMENTS):
            piece = (n, a, min(a + GROUP_ELEMENTS, numel))
            if cur and size + piece[2] - a > GROUP_ELEMENTS:
                groups.append(cur)
                cur, size = [], 0
            cur.append(piece)
            size += piece[2] - a
    return groups + ([cur] if cur else [])


def _views(tensors: Dict[str, torch.Tensor], group: List[Piece]
           ) -> List[torch.Tensor]:
    """Each piece's elements of its tensor: the tensor itself where the
    piece is all of it, else a flat view, so writes reach the tensor
    (``view`` raises on a non-contiguous one)."""
    return [tensors[n] if e - a == tensors[n].numel()
            else tensors[n].view(-1)[a:e] for n, a, e in group]


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt_state,
                 decay: Optional[Collection[str]] = None,
                 gnorm: Optional[float] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object],
                            Dict[str, float]]:
    """One update of ``params`` (in place) from ``grads``.  Returns
    (params, opt_state, {"grad_norm", "lr"}).  ``grads`` may be float32
    buffers that the update is free to overwrite.  ``decay`` names the
    parameters that take weight decay (default: those with ``ndim >=
    2``; the train step passes the names whose JAX counterpart has
    ``ndim >= 2``).  ``gnorm``: the global gradient norm the clip
    takes, where ``grads`` are one rank's shards of the gradient (the
    data-parallel step sums the shards' squared norms over the ranks);
    by default the norm of ``grads``."""
    step = opt_state["step"] + 1
    names = list(params)
    if gnorm is None:
        gnorm = host_float(global_norm([grads[n] for n in names]))
    scale = float(torch.clamp(
        _f32(cfg.clip_norm) / max(_f32(gnorm), _f32(1e-9)), max=1.0))
    lr = schedule(cfg, step)
    b1c = float(1 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1 - _f32(cfg.b2) ** _f32(step))
    mu_all, nu_all = opt_state["mu"], opt_state["nu"]
    for group in _groups(names, params):
        ps, mu, nu = (_views(t, group) for t in (params, mu_all, nu_all))
        g = [v.float() for v in _views(grads, group)]
        torch._foreach_mul_(g, scale)
        torch._foreach_mul_(mu, cfg.b1)
        torch._foreach_add_(mu, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(nu, cfg.b2)
        torch._foreach_mul_(g, g)
        torch._foreach_add_(nu, g, alpha=1 - cfg.b2)
        del g
        denom = torch._foreach_div(nu, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(mu, b1c)
        torch._foreach_div_(delta, denom)
        del denom
        p32 = [p.float() for p in ps]
        decayed = [i for i, (n, _, _) in enumerate(group)
                   if (params[n].ndim >= 2 if decay is None
                       else n in decay)]
        if decayed and cfg.weight_decay:
            torch._foreach_add_([delta[i] for i in decayed],
                                [p32[i] for i in decayed],
                                alpha=cfg.weight_decay)
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(p32, delta)
        del delta
        for p, new in zip(ps, p32):
            p.copy_(new)
    opt_state = {"mu": mu_all, "nu": nu_all, "step": step}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
