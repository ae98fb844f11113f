"""The hand kernels' operation counts, the card's rates, and the recorder
each kernel's wrapper reports its work to.

One source for two readers: ``chip_smoke.py``'s least times (a kernel's
bytes over :data:`HBM_BYTES_PER_S`, its operations over
:data:`PEAK_FLOPS` of its dtype) and ``roofline.flop_stats``'s counter.
Every count is arithmetic on shapes and masks, never on data, so a fake
tensor (no storage) is counted as the real one is:

- flash attention: 4 D an attended (query, key) pair and head forward
  (QK^T and PV), 10 D backward (the five products of the flash
  backward); :func:`flash_kernel_flops` counts the products the kernels
  run (the dQ kernel recomputes S and dP: 14 D);
- paged attention: 4 D a (token, query head), QK^T and PV;
- WKV: :data:`WKV_FLOPS` a state element and step;
- the selective scan: :data:`SCAN_FLOPS` a (step, channel, state).

While a :func:`recording` is open, each wrapper of a hand kernel adds
its count to it under the kernel's name and direction, for a launch and
for a fake call alike (``repro_torch.util.device.is_fake``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List

import numpy as np
import torch

from repro_torch.roofline.analysis import HW

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.  float32: the
#: TF32 tensor-core peak (494.7 TFLOP/s) over three, the least time for
#: float32-accurate products, which the simt flash kernels run as 3xTF32
HBM_BYTES_PER_S = HW.hbm_bw
PEAK_FLOPS = {torch.bfloat16: HW.peak_flops, torch.float32: 494.7e12 / 3}
#: float32 outside the tensor cores (the WKV kernels' plain FMAs)
FP32_SIMT_FLOPS = 67e12

#: the least flops a WKV state element and step (an FMA counts 2): the
#: forward's sum of r S (2) and w S + k v (3); the backward's state
#: recomputed (3), w G + r do (3), and dr, dk, dv, dw (2 each).  The u
#: terms are rank one a row and step (o += (r u k) v, dr += u k (v do),
#: dk += u r (v do), dv += (k u r) do): O(hs) a step, left out
WKV_FLOPS = {"fwd": 5, "bwd": 14}
#: flops a (step, channel, state) of the selective scan (an FMA counts
#: 2; the exp of dt a is one special-function result, not counted).
#: Forward 6: dt a (1), (dt x) b (1), h = dA h + dBx (2), y += c h (2).
#: Backward 18: dA and h recomputed (1 + 1 + 2), g = dA' g' + c dy (3),
#: dc += h dy (2), db += g dt x (2), dx and d(dt) through g b (2), d(dt)
#: and da through g h_prev dA a (3 + 2)
SCAN_FLOPS = {"fwd": 6, "bwd": 18}


def attended_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves in a sequence of ``s``, per
    (sequence, head)."""
    qp = np.arange(s)
    hi = qp if causal else np.full(s, s - 1)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros(s, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(b: int, s: int, h: int, d: int, causal: bool, window: int,
                backward: bool) -> int:
    """The least operations of a flash call on q (b, s, h, d)."""
    return (10 if backward else 4) * b * h * d * attended_pairs(
        s, causal, window)


def flash_kernel_flops(b: int, s: int, h: int, d: int, causal: bool,
                       window: int, backward: bool) -> int:
    """Operations of the products the flash kernels run: 4 D an attended
    pair and head forward, 14 D backward (seven products where the bound
    counts five)."""
    return (14 if backward else 4) * b * h * d * attended_pairs(
        s, causal, window)


def paged_flops(tokens: int, h: int, d: int) -> int:
    """Operations of a paged decode over ``tokens`` attended (sequence,
    token) pairs with h query heads of d."""
    return 4 * tokens * h * d


def paged_capacity(b: int, max_pages: int, page: int, window: int) -> int:
    """The (sequence, token) pairs of a paged decode at the state's
    capacity: every page of every table row, or the window where it is
    shorter."""
    cap = max_pages * page
    return b * (min(cap, window) if window > 0 else cap)


def wkv_flops(elems: int, hs: int, backward: bool) -> int:
    """:data:`WKV_FLOPS` for ``elems`` = B S H hs elements of r."""
    return WKV_FLOPS["bwd" if backward else "fwd"] * elems * hs


def scan_flops(b: int, s: int, d: int, n: int, backward: bool) -> int:
    """:data:`SCAN_FLOPS` for x (b, s, d) and n states."""
    return SCAN_FLOPS["bwd" if backward else "fwd"] * scan_exps(b, s, d, n)


def scan_exps(b: int, s: int, d: int, n: int) -> int:
    """The exps of exp(dt a): one a (step, channel, state)."""
    return b * s * d * n


_recorders: List[Dict[str, int]] = []


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Collect the hand kernels' counts, by kernel and direction, while
    open (recordings nest; each sees every kernel call inside it)."""
    got: Dict[str, int] = {}
    _recorders.append(got)
    try:
        yield got
    finally:
        _recorders.remove(got)


def record(name: str, flops: int) -> None:
    """Add a kernel call's count to every open recording."""
    for got in _recorders:
        got[name] = got.get(name, 0) + int(flops)
