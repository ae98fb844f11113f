"""Plain PyTorch versions of the port's kernels (the CPU path and the
card-side oracle in ``chip_smoke.py``): paged decode attention, the
flash attention forward and backward of the training path, and the
simulator's LRU scan and timing epilogue."""
from __future__ import annotations

import math

import torch

from repro_torch.core.kv_page_manager import gather_kv

NEG_INF = -1e30


def _paged_mask(block_table: torch.Tensor, valid_lens: torch.Tensor,
                page: int, window: int) -> torch.Tensor:
    """(B, max_pages * page) bool: the token is attendable (mapped page,
    position < length, inside the window)."""
    kpos = torch.arange(block_table.shape[1] * page,
                        device=block_table.device)
    lens = valid_lens.long()[:, None]
    mask = kpos[None, :] < lens
    if window > 0:
        mask &= kpos[None, :] >= lens - window
    return mask & (block_table >= 0).repeat_interleave(page, dim=1)


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
    mask = _paged_mask(block_table, valid_lens, page, window)
    mask = mask[:, None, None, None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~mask, 0.0)
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(vs.dtype).float(),
                       vs.float())
    return out.reshape(b, s1, h, d).to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_table: torch.Tensor,
                              valid_lens: torch.Tensor, *, window: int = 0,
                              pages_per_split: int) -> torch.Tensor:
    """:func:`paged_attention_ref` computed the way the CUDA kernel
    computes it (split-K over pages, flash-decoding); used by the tests.

    The table's slots are cut into splits of ``pages_per_split``
    consecutive slots.  Each split gives float32 partials for every query
    head: its max ``m_i`` over its attendable tokens (-inf when it has
    none), ``l_i = sum exp(s - m_i)`` and ``acc_i = P V`` with P rounded
    to the value dtype against ``m_i``.  The splits are then merged in
    order: ``m = max m_i``, ``out = sum e^(m_i - m) acc_i / max(sum
    e^(m_i - m) l_i, 1e-30)``, skipping empty splits, so a row with no
    attendable token gives 0.
    """
    b, s1, h, d = q.shape
    n, page, kh, _ = k_pages.shape
    g = h // kh
    maxp = block_table.shape[1]
    ks, vs = gather_kv(k_pages, v_pages, block_table)
    mask = _paged_mask(block_table, valid_lens, page, window)
    chunk = pages_per_split * page
    splits = -(-maxp // pages_per_split)
    pad = splits * chunk - maxp * page
    ks = torch.nn.functional.pad(ks.float(), (0, 0, 0, 0, 0, pad))
    vs = torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, pad))
    mask = torch.nn.functional.pad(mask, (0, pad))
    ks = ks.reshape(b, splits, chunk, kh, d)
    vs = vs.reshape(b, splits, chunk, kh, d)
    mask = mask.reshape(b, 1, 1, splits, chunk)             # (b,k,g,n,t)

    qg = q.reshape(b, kh, g, d).float()
    scores = torch.einsum("bkgd,bntkd->bkgnt", qg, ks) * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(~mask, NEG_INF)
    m_i = scores.amax(dim=-1)                                # (b,k,g,n)
    p = torch.exp(scores - m_i[..., None]).masked_fill(~mask, 0.0)
    l_i = p.sum(dim=-1)
    acc_i = torch.einsum("bkgnt,bntkd->bkgnd", p.to(vs.dtype).float(),
                         vs.float())
    full = mask.any(dim=-1).expand_as(m_i)                   # split not empty
    m = torch.where(full, m_i, torch.full_like(m_i, -math.inf)).amax(-1)
    num = torch.zeros((b, kh, g, d), device=q.device)
    den = torch.zeros((b, kh, g), device=q.device)
    for i in range(splits):                                  # fixed order
        w = torch.where(full[..., i], torch.exp(m_i[..., i] - m),
                        torch.zeros_like(m))
        num = num + w[..., None] * acc_i[..., i, :]
        den = den + w * l_i[..., i]
    out = num / den.clamp_min(1e-30)[..., None]
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


#: keys of a K / V tile of the CUDA float32 forward (``FWD_STEP``), and of
#: each P V product it folds into its float32 sum
FLASH_FWD_STEP = 16
#: the bits of a float32 that a TF32 operand keeps (sign, exponent, 10 of
#: the 23 mantissa bits); as int32
_TF32_MASK = -0x2000


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32, as the tensor cores read a float32 register."""
    return (x.contiguous().view(torch.int32) & _TF32_MASK).view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                  x3: bool) -> torch.Tensor:
    """einsum ``eq`` of float32 a and b with TF32 operands: in 3xTF32
    (x3) each is split into hi = tf32(x) and lo = tf32(x - hi) and
    lo*hi + hi*lo + hi*hi are summed; else hi*hi alone (1xTF32)."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if x3:
        out = (torch.einsum(eq, _tf32(a - ah), bh)
               + torch.einsum(eq, ah, _tf32(b - bh))) + out
    return out


def flash_attention_tf32x3_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: int = 0, x3: bool = True,
                               return_lse: bool = False):
    """:func:`flash_attention_ref` in float32 with the CUDA float32
    forward's rounding steps; used by the tests.

    It models the kernel's operand split, softmax units and fold
    granularity, not its exact arithmetic: keys go in tiles of
    :data:`FLASH_FWD_STEP`; per tile S = Q K^T is scaled into log2
    units, the running max m and P = exp2(S - m) are taken there, ``l``
    and ``acc`` are rescaled, and the tile's P V is folded into ``acc``
    by one float32 add.  Both products take TF32 operands split into
    truncated halves (3xTF32; ``x3=False`` keeps only hi*hi, plain
    TF32).  The order of the sums inside a product is einsum's, not the
    tensor cores'.
    """
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale2 = 1.0 / math.sqrt(d) * math.log2(math.e)
    qg = q.reshape(b, s, kh, g, d).float()
    m = torch.full((b, kh, g, s), NEG_INF, device=q.device)
    l = torch.zeros((b, kh, g, s), device=q.device)
    acc = torch.zeros((b, kh, g, s, d), device=q.device)
    qpos = torch.arange(s, device=q.device)
    for j0 in range(0, s, FLASH_FWD_STEP):
        kj = k[:, j0:j0 + FLASH_FWD_STEP].float()
        vj = v[:, j0:j0 + FLASH_FWD_STEP].float()
        kpos = torch.arange(j0, j0 + kj.shape[1], device=q.device)
        valid = _flash_mask(qpos, kpos, causal, window)
        sc = _tf32_product("bskgd,btkd->bkgst", qg, kj, x3) * scale2
        sc = sc.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.where(m > NEG_INF / 2, torch.exp2(m - m_new),
                            torch.zeros_like(m))
        p = torch.exp2(sc - m_new[..., None]).masked_fill(~valid, 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _tf32_product("bkgst,btkd->bkgsd",
                                                     p, vj, x3)
        m = m_new
    lc = l.clamp_min(1e-30)
    out = (acc / lc[..., None]).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    if return_lse:
        mn = torch.where(m > NEG_INF / 2, m * math.log(2.0), m)
        return out, (mn + torch.log(lc)).reshape(b, h, s)
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


# ---------------------------------------------------------------------------
# the simulator's LRU hit-extraction scan
# ---------------------------------------------------------------------------
#: the scan's LRU tables, in the kernel's order: "l2" and "l3" exist on
#: machines with a cache hierarchy below L1, "ctlb" on machines with a
#: cache-as-TLB; each is (lanes, mechanisms, sets, ways) tags + stamps
SCAN_TABLES = ("l1tlb", "l2tlb", "pwc", "l1", "l2", "l3", "ctlb")
#: bits of the per-(lane, mechanism) flag word the scan and the epilogue
#: read (colocate and parallel: the epilogue only)
FLAG_IDEAL, FLAG_HUGE, FLAG_BYPASS, FLAG_SEGMENT, FLAG_CACHE_TLB = (
    1, 2, 4, 8, 16)
FLAG_PWC_SHIFT = 5          # bits 5..8: a PWC in front of walk level 0..3
FLAG_COLOCATE, FLAG_PARALLEL = 1 << 9, 1 << 10
FLAG_N_PTE_SHIFT = 12       # bits 12..14: PTE accesses of a walk
SCAN_MAX_PTE = 4
SCAN_HUGE_SHIFT = 9         # 2MB pages: 512 x 4KB
_INT32_MIN = -2 ** 31


def scan_layout(tables) -> tuple:
    """(hierarchy table names, has a cache-as-TLB, stamp slots a step) of
    a scan over ``tables``.  The packed hit bits of a step are: 0 L1
    DTLB, 1 L2 TLB, 2..5 the PWC of walk level 0..3, 6 + 5h .. 10 + 5h
    hierarchy level h for [pte0..pte3, data], then the cache-as-TLB,
    then (banked memory) the five row-buffer hits (:func:`bank_bit`)."""
    hier = ("l1", "l2", "l3") if "l2" in tables else ("l1",)
    has_ctlb = "ctlb" in tables
    return hier, has_ctlb, 2 + SCAN_MAX_PTE + 5 * len(hier) + int(has_ctlb)


def bank_bit(n_hier: int, has_ctlb: bool) -> int:
    """The first of the five row-buffer-hit bits (pte0..pte3, data) a
    banked machine appends after every other hit bit: at most 6 + 15 + 1 +
    5 = 27 bits."""
    return 6 + 5 * n_hier + int(has_ctlb)


def lru_scan_ref(vpn: torch.Tensor, off: torch.Tensor, is4k: torch.Tensor,
                 valid: torch.Tensor, pte: torch.Tensor, flags: torch.Tensor,
                 stamp: torch.Tensor, tables: dict,
                 bank_row: torch.Tensor | None = None,
                 lines_per_row: int = 0) -> torch.Tensor:
    """The serial LRU scan of one chunk, as an eager step loop vectorized
    over (lane, mechanism).

    vpn, off: (T, L) int32; is4k, valid: (T, L) bool; pte: (T, L, M, 4)
    int32 walk lines; flags: (L, M) int32 (``FLAG_*``); stamp: (L, M)
    int32; tables: name -> (tags, lru), each (L, M, sets, ways) int32.
    Returns the packed hit bits (T, L, M) int32; ``tables`` and ``stamp``
    are updated in place.

    Each lookup is a set-associative LRU hit plus fill: ``set = key %
    sets``, ``tag = key / sets + 1`` (PWC: set = walk level, tag = line +
    1); a matching way wins, else the first way of least stamp; a disabled
    site neither writes nor hits; the stamp written is ``stamp + slot``,
    and ``stamp`` advances by the slots of a step on every step, padding
    included.

    Banked memory: ``bank_row`` (L, M, banks) int32 holds each bank's open
    row (-1: closed), updated in place, and ``lines_per_row`` the 64B
    lines of a row.  A site reaches memory when it is a PTE site that
    walks, is within the walk's depth, missed its PWC level and bypasses
    the caches, or when it missed every hierarchy level; the five sites
    then touch their bank in program order (pte0..pte3, data): ``bank =
    line / lines_per_row % banks``, ``row = line / (lines_per_row *
    banks)`` (truncating, as the JAX scan; line ids are non-negative),
    the hit bit is ``open row == row``, and the bank keeps ``row`` open.
    """
    t_len, n_lanes = vpn.shape
    m = stamp.shape[1]
    hier, has_ctlb, n_slots = scan_layout(tables)
    ctlb_slot = 2 + SCAN_MAX_PTE + 5 * len(hier)

    def flag(bit):
        return (flags & bit) != 0

    ideal, huge, bypass = flag(FLAG_IDEAL), flag(FLAG_HUGE), flag(FLAG_BYPASS)
    segment, cache_tlb = flag(FLAG_SEGMENT), flag(FLAG_CACHE_TLB)
    n_pte = (flags >> FLAG_N_PTE_SHIFT) & 7

    # everything that does not depend on the tables, for the whole chunk
    is4k3, valid3, vpn3 = is4k[:, :, None], valid[:, :, None], vpn[:, :, None]
    tlb_key = torch.where(huge & ~is4k3,
                          (vpn3 >> SCAN_HUGE_SHIFT) | (1 << 26), vpn3)
    en0 = valid3 & ~ideal & ~(segment & ~is4k3)
    eff_n = torch.where(huge & is4k3, SCAN_MAX_PTE, n_pte)
    pwc_ok = [(lvl < eff_n) & flag(1 << (FLAG_PWC_SHIFT + lvl))
              for lvl in range(SCAN_MAX_PTE)]
    pte_ok = [(lvl < eff_n) & ~bypass for lvl in range(SCAN_MAX_PTE)]
    valid_lm = valid3.expand(t_len, n_lanes, m)
    data = (vpn * 64 + off)[:, :, None].expand(t_len, n_lanes, m)
    lines = [pte[..., i] for i in range(SCAN_MAX_PTE)] + [data]

    # tables flattened to rows, with one scratch row at the end that
    # takes the writes of disabled sites
    chain = torch.arange(n_lanes * m, device=vpn.device).view(n_lanes, m)
    flat = {}
    for name, (tags, lru) in tables.items():
        ways = tags.shape[-1]
        pad = tags.new_zeros(1, ways)
        flat[name] = (torch.cat([tags.reshape(-1, ways), pad]),
                      torch.cat([lru.reshape(-1, ways), pad]),
                      tags.shape[2], ways, tags.numel() // ways)

    def site(name, key):
        sets = flat[name][2]
        return chain * sets + (key % sets).long(), key // sets + 1

    tlb_sites = {n: site(n, tlb_key)
                 for n in ("l1tlb", "l2tlb", "ctlb") if n in flat}
    opened = None
    if bank_row is not None:
        n_banks = bank_row.shape[-1]
        opened = bank_row.clone()
        byp_ok = [(lvl < eff_n) & bypass for lvl in range(SCAN_MAX_PTE)]
        div = lambda a, d: torch.div(a, d, rounding_mode="trunc")  # noqa: E731
        banks = [torch.fmod(div(line, lines_per_row), n_banks).long()
                 for line in lines]
        open_rows = [div(line, lines_per_row * n_banks) for line in lines]
    pwc_rows = [chain * SCAN_MAX_PTE + lvl for lvl in range(SCAN_MAX_PTE)]
    hier_sites = {n: [site(n, line) for line in lines] for n in hier}

    def access(name, rows, tag, en, st):
        ft, fl, _, ways, scratch = flat[name]
        r = rows.reshape(-1)
        rt = ft.index_select(0, r).view(n_lanes, m, ways)
        match = rt == tag[..., None]
        hit = match.any(-1) & en
        way = torch.where(
            match, _INT32_MIN,
            fl.index_select(0, r).view(n_lanes, m, ways)).argmin(-1)
        idx = (torch.where(en.reshape(-1), r, scratch), way.reshape(-1))
        ft.index_put_(idx, tag.reshape(-1))
        fl.index_put_(idx, st.reshape(-1))
        return hit

    steps = []
    s = stamp.clone()
    for t in range(t_len):
        rows, tag = tlb_sites["l1tlb"]
        h_l1tlb = access("l1tlb", rows[t], tag[t], en0[t], s)
        en1 = en0[t] & ~h_l1tlb
        rows, tag = tlb_sites["l2tlb"]
        h_l2tlb = access("l2tlb", rows[t], tag[t], en1, s + 1)
        walk = en1 & ~h_l2tlb
        if has_ctlb:
            rows, tag = tlb_sites["ctlb"]
            h_ctlb = access("ctlb", rows[t], tag[t], walk & cache_tlb,
                            s + ctlb_slot)
            walk = walk & ~h_ctlb
        bits = [h_l1tlb, h_l2tlb]
        for lvl in range(SCAN_MAX_PTE):
            h = access("pwc", pwc_rows[lvl], lines[lvl][t] + 1,
                       walk & pwc_ok[lvl][t], s + 2 + lvl)
            bits.append(h)
        ens = [walk & pte_ok[lvl][t] & ~bits[2 + lvl]
               for lvl in range(SCAN_MAX_PTE)] + [valid_lm[t]]
        for h_i, name in enumerate(hier):
            for i, (rows, tag) in enumerate(hier_sites[name]):
                h = access(name, rows[t], tag[t], ens[i],
                           s + 2 + SCAN_MAX_PTE + 5 * h_i + i)
                ens[i] = ens[i] & ~h
                bits.append(h)
        if has_ctlb:
            bits.append(h_ctlb)
        if opened is not None:
            mem_ens = [(walk & byp_ok[lvl][t] & ~bits[2 + lvl]) | ens[lvl]
                       for lvl in range(SCAN_MAX_PTE)] + [ens[SCAN_MAX_PTE]]
            for i in range(5):
                bk, rw = banks[i][t][..., None], open_rows[i][t]
                cur = opened.gather(-1, bk)[..., 0]
                bits.append((cur == rw) & mem_ens[i])
                opened.scatter_(-1, bk, torch.where(mem_ens[i], rw,
                                                    cur)[..., None])
        steps.append(torch.stack(bits, -1))
        s = s + n_slots

    for name, (tags, lru) in tables.items():
        ft, fl = flat[name][:2]
        tags.copy_(ft[:-1].view_as(tags))
        lru.copy_(fl[:-1].view_as(lru))
    stamp.copy_(s)
    if opened is not None:
        bank_row.copy_(opened)
    hits = torch.stack(steps).to(torch.int32)         # (T, L, M, bits)
    weights = 1 << torch.arange(hits.shape[-1], dtype=torch.int32,
                                device=vpn.device)
    return (hits * weights).sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the simulator's timing epilogue
# ---------------------------------------------------------------------------
#: the epilogue's counters, in the kernel's output order
COUNTERS = ("trans", "walks", "walk_cyc", "l1tlb_miss", "pte_acc",
            "pte_l1_hit", "pte_mem", "data_l1_miss", "data_mem")
#: the per-lane data parameters the epilogue reads, in the column order of
#: the kernel's (lanes, K) float32 parameter array
EPILOGUE_PARAMS = ("mem_lat", "l1_lat", "l2_lat", "l3_lat", "l2tlb_lat",
                   "pwc_lat", "promo", "ech_rehash", "ctlb_lat", "stack_pen",
                   "row_save")


def sim_epilogue_ref(packed: torch.Tensor, work: torch.Tensor,
                     is4k: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
                     mt: dict, dp: dict, n_hier: int, has_ctlb: bool,
                     lines: torch.Tensor | None = None,
                     lines_per_row: int = 0):
    """Vectorized timing over the whole chunk.

    packed: (T, M, L) hit bits; work: (T, L) float32; is4k, valid: (T, L)
    bool; q: (M, L) queue delay, constant within the chunk; mt: lane
    mechanism tables ((L, M) leaves); dp: lane data params ((L,) leaves).
    Re-derives the gates the scan used from the hit bits and returns the
    (M, L) counter deltas, clock delta and memory accesses.

    Banked memory: ``lines`` (T, M, L, 5) int32 holds the five access
    sites' line ids (pte0..pte3, data), q is (M, L, banks), and a site's
    memory cost is the closed-row latency, less ``row_save`` where the
    scan's row-buffer bit is set, plus its own bank's queue delay (bank =
    ``line // lines_per_row % banks``); the memory accesses come back per
    bank, (M, L, banks).
    """
    def bit(i):
        return ((packed >> i) & 1).bool()

    def mb(a):          # lane mech table (L, M) -> (1, M, L)
        return a.T[None]

    def d3(v):          # lane data param -> broadcast over (T, M, L)
        return v[None, None, :]

    def d4(v):          # lane data param -> broadcast over (T, M, L, 5)
        return v[None, None, :, None]

    ctlb_bit = 6 + 5 * n_hier
    validb = valid[:, None, :]                           # (T, 1, L)
    is4kb = is4k[:, None, :]
    hugeb, bypb = mb(mt["huge"]), mb(mt["bypass"])
    hier_lat = [dp["l1_lat"], dp["l2_lat"], dp["l3_lat"]][:n_hier]
    # multi-stack remote-hop penalty per memory access: co-locating
    # mechanisms dodge ~90% of it; exactly +0.0 on one stack
    pen = d3(dp["stack_pen"]) * torch.where(mb(mt["colocate"]), 0.1, 1.0)
    if lines is not None:
        # closed-row latency, less what an open-row hit skips, plus the
        # access's own bank's queue delay
        first = bank_bit(n_hier, has_ctlb)
        rowhit = torch.stack([bit(first + i) for i in range(5)], -1)
        n_banks = q.shape[-1]
        bank5 = ((lines // lines_per_row) % n_banks).long()  # (T, M, L, 5)
        q_acc = q[None].expand(packed.shape + (n_banks,)).gather(-1, bank5)
        mem_cost = (d4(dp["mem_lat"]) - rowhit * d4(dp["row_save"])
                    + q_acc + pen[..., None])
    else:
        mem_cost = d4(dp["mem_lat"]) + q[None, ..., None] + pen[..., None]

    h_l1tlb, h_l2tlb = bit(0), bit(1)
    en0 = validb & ~mb(mt["ideal"]) & ~(mb(mt["segment"]) & ~is4kb)
    walk = en0 & ~h_l1tlb & ~h_l2tlb                    # (T, M, L)
    if has_ctlb:
        ctlb_probe = walk & mb(mt["cache_tlb"])
        walk = walk & ~bit(ctlb_bit)
    eff_n = torch.where(hugeb & is4kb, SCAN_MAX_PTE, mb(mt["n_pte"]))

    # hierarchy latency per line (pte0..3, data): chain the per-level hit
    # bits top-down; a line that misses everywhere pays memory + q
    shape5 = packed.shape + (5,)
    lat = torch.zeros(shape5, dtype=torch.float32, device=packed.device)
    reached = torch.ones(shape5, dtype=torch.bool, device=packed.device)
    went_mem = reached.clone()
    for h_i in range(n_hier):
        h = torch.stack([bit(6 + 5 * h_i + i) for i in range(5)], -1)
        lat = lat + torch.where(reached, d4(hier_lat[h_i]), 0.0)
        went_mem = went_mem & ~h
        reached = reached & ~h
    lat = lat + torch.where(reached, mem_cost, 0.0)

    # per-PTE-level walk latency: a PWC hit beats everything; a bypassing
    # mechanism goes straight to memory; the others pay the chain
    pwc_hit = torch.stack([bit(2 + lvl) for lvl in range(SCAN_MAX_PTE)], -1)
    levels = torch.arange(SCAN_MAX_PTE, device=packed.device)
    pte_en = walk[..., None] & (levels < eff_n[..., None])
    need_mem = pte_en & ~pwc_hit
    pte_lat = torch.where(bypb[..., None], mem_cost[..., :SCAN_MAX_PTE],
                          lat[..., :SCAN_MAX_PTE])
    pte_lat = torch.where(pwc_hit, d4(dp["pwc_lat"]), pte_lat)
    pte_lat = torch.where(pte_en, pte_lat, 0.0)

    # parallel (ECH) walks complete when the hitting probe returns: one
    # access latency plus issue overhead and the multi-core rehash churn
    walk_cyc = torch.where(mb(mt["parallel"]),
                           pte_lat.amax(-1) + 2.0 + d3(dp["ech_rehash"]),
                           pte_lat.sum(-1))

    trans = torch.where(walk, walk_cyc, 0.0)
    if has_ctlb:
        # the cache-as-TLB probe is serial after the L2-TLB miss: paid on
        # hit and miss; a hit replaces the walk
        trans = trans + torch.where(ctlb_probe, d3(dp["ctlb_lat"]), 0.0)
    trans = torch.where(en0 & ~h_l1tlb, d3(dp["l2tlb_lat"]) + trans, 0.0)
    trans = trans + torch.where(hugeb & validb, d3(dp["promo"]), 0.0)

    pte_l1_hit = torch.stack([bit(6 + i) for i in range(SCAN_MAX_PTE)], -1)
    pte_mem = need_mem & (bypb[..., None] | went_mem[..., :SCAN_MAX_PTE])
    data_mem = validb & went_mem[..., SCAN_MAX_PTE]
    dlat = torch.where(validb, lat[..., SCAN_MAX_PTE], 0.0)

    step_cyc = torch.where(
        validb,
        work[:, None, :] + 1.0 + trans + (dlat - d3(dp["l1_lat"])),
        0.0)

    def count(a, dims=0):
        return a.to(torch.float32).sum(dim=dims)

    cnt = {
        "trans": trans.sum(dim=0),
        "walks": count(walk),
        "walk_cyc": torch.where(walk, walk_cyc, 0.0).sum(dim=0),
        "l1tlb_miss": count(en0 & ~h_l1tlb),
        "pte_acc": count(need_mem, (0, -1)),
        "pte_l1_hit": count(pte_l1_hit, (0, -1)),
        "pte_mem": count(pte_mem, (0, -1)),
        "data_l1_miss": count(validb & ~bit(6 + SCAN_MAX_PTE)),
        "data_mem": count(data_mem),
    }
    if lines is not None:
        # per-bank demand: each access that reached memory, on its bank
        acc5 = torch.cat([pte_mem, data_mem[..., None]], -1)
        m, n_lanes = packed.shape[1:]
        flat = lambda a: a.permute(1, 2, 0, 3).reshape(m, n_lanes, -1)  # noqa: E731
        mem_n = torch.zeros((m, n_lanes, n_banks), dtype=torch.float32,
                            device=packed.device).scatter_add_(
            -1, flat(bank5), flat(acc5).to(torch.float32))
    else:
        mem_n = count(pte_mem, (0, -1)) + count(data_mem)
    return cnt, step_cyc.sum(dim=0), mem_n
