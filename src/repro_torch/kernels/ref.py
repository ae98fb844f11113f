"""Plain PyTorch versions of the port's kernels (the CPU path and the
card-side oracle in ``chip_smoke.py``)."""
from __future__ import annotations

import math

import torch

from repro_torch.core.kv_page_manager import gather_kv

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        valid_lens: torch.Tensor, *, window: int = 0
                        ) -> torch.Tensor:
    """Decode attention over paged KV.

    q: (B, 1, H, D) one query token per sequence
    k_pages/v_pages: (N, page, K, D) physical pools
    block_table: (B, max_pages) int32 physical page ids (-1 = unmapped)
    valid_lens: (B,) number of attendable tokens (incl. the new one)
    window: if > 0, only the last `window` tokens are attendable.
    Returns (B, 1, H, D).

    Query head ``h`` reads kv head ``h // G`` (order (kh, g)).  Products
    are taken in float32, as the JAX package's
    ``preferred_element_type=float32``; the weights are cast to the value
    dtype before the PV product.  A row with no attendable token returns
    0, as the Pallas kernel does (``jnp.maximum(l, 1e-30)``) — the JAX
    ``ref.paged_attention_ref`` returns the mean of page 0's V there.
    """
    b, s1, h, d = q.shape
    n, page, kh, _ = k_pages.shape
    g = h // kh
    maxp = block_table.shape[1]
    ks, vs = gather_kv(k_pages, v_pages, block_table)

    qg = q.reshape(b, s1, kh, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), ks.float())
    scores = scores * (1.0 / math.sqrt(d))
    kpos = torch.arange(maxp * page, device=q.device)
    lens = valid_lens.long()[:, None]
    mask = kpos[None, :] < lens
    if window > 0:
        mask &= kpos[None, :] >= lens - window
    mask &= (block_table >= 0).repeat_interleave(page, dim=1)
    mask = mask[:, None, None, None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~mask, 0.0)
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(vs.dtype).float(),
                       vs.float())
    return out.reshape(b, s1, h, d).to(q.dtype)
