"""Plain PyTorch versions of the port's kernels (the CPU path and the
card-side oracle in ``chip_smoke.py``): paged decode attention, and the
flash attention forward and backward of the training path."""
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


#: KV block of the plain flash attention (the Pallas kernel's default bk)
FLASH_BLOCK = 512


def _flash_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                window: int) -> torch.Tensor:
    """(Sq, Sk) bool: key ``kpos`` is attendable from query ``qpos``."""
    valid = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                       device=qpos.device)
    if causal:
        valid &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        valid &= kpos[None, :] > qpos[:, None] - window
    return valid


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """Blockwise online-softmax GQA self-attention, the arithmetic of the
    Pallas kernel ``repro.kernels.flash_attention._kernel``.

    q: (B, S, H, D); k/v: (B, S, KH, D) -> (B, S, H, D) in q's dtype.
    Query head ``h`` reads kv head ``h // G``.  Over KV blocks of
    :data:`FLASH_BLOCK` keys: float32 scores, running max ``m``, sum
    ``l`` and accumulator; the probabilities are cast to V's dtype
    before the PV product; a row with no attendable key gives 0.
    Differentiable by autograd.  With ``return_lse`` it also returns the
    (B, H, S) float32 log-sum-exp ``m + log(l)`` the backward reads.
    """
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kh, g, d).float()
    m = torch.full((b, kh, g, s), NEG_INF, device=q.device)
    l = torch.zeros((b, kh, g, s), device=q.device)
    acc = torch.zeros((b, kh, g, s, d), device=q.device)
    qpos = torch.arange(s, device=q.device)
    for j0 in range(0, s, FLASH_BLOCK):
        kj = k[:, j0:j0 + FLASH_BLOCK]
        vj = v[:, j0:j0 + FLASH_BLOCK]
        kpos = torch.arange(j0, j0 + kj.shape[1], device=q.device)
        valid = _flash_mask(qpos, kpos, causal, window)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kj.float()) * scale
        sc = sc.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.where(m > NEG_INF / 2, torch.exp(m - m_new),
                            torch.zeros_like(m))
        p = torch.exp(sc - m_new[..., None]).masked_fill(~valid, 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(),
                          vj.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    lc = l.clamp_min(1e-30)
    out = (acc / lc[..., None]).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    out = out.to(q.dtype)
    if return_lse:
        return out, (m + torch.log(lc)).reshape(b, h, s)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention_ref` from its output ``o``
    and log-sum-exp ``lse`` (B, H, S), for the cotangent ``do``.

    The arithmetic of the backward kernel: ``delta = rowsum(dO * O)``,
    then per KV block ``P = exp(S - lse)``, ``dV += P^T dO`` with P cast
    to V's dtype (as the forward's PV product), ``dP = dO V^T``,
    ``dS = P (dP - delta)``, ``dQ += dS K / sqrt(D)``, ``dK += dS^T Q /
    sqrt(D)``; dK and dV summed over the G query heads of each kv head.
    All in float32; results in the inputs' dtypes.
    """
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kh, g, d).float()
    dog = do.reshape(b, s, kh, g, d).float()
    delta = (dog * o.reshape(b, s, kh, g, d).float()).sum(-1)   # (b,s,kh,g)
    delta = delta.permute(0, 2, 3, 1)                           # (b,kh,g,s)
    lse = lse.reshape(b, kh, g, s)
    qpos = torch.arange(s, device=q.device)
    dq = torch.zeros((b, kh, g, s, d), device=q.device)
    dks, dvs = [], []
    for j0 in range(0, s, FLASH_BLOCK):
        kj = k[:, j0:j0 + FLASH_BLOCK].float()
        vj = v[:, j0:j0 + FLASH_BLOCK]
        kpos = torch.arange(j0, j0 + kj.shape[1], device=q.device)
        valid = _flash_mask(qpos, kpos, causal, window)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kj) * scale
        p = torch.exp(sc - lse[..., None]).masked_fill(~valid, 0.0)
        dvs.append(torch.einsum("bkgst,bskgd->btkd", p.to(v.dtype).float(),
                                dog))
        dp = torch.einsum("bskgd,btkd->bkgst", dog, vj.float())
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bkgst,btkd->bkgsd", ds, kj) * scale
        dks.append(torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))
