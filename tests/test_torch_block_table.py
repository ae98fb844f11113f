"""The port's translation tables, page manager and translation cache
against the JAX package's (integer outputs match exactly)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_table as JBT
from repro.core import kv_page_manager as JKVM
from repro.core.translation_cache import TranslationCache as JCache
from repro_torch.core import block_table as BT
from repro_torch.core import kv_page_manager as KVM
from repro_torch.core.translation_cache import TranslationCache


def _flat(b=4, maxp=32, seed=0):
    rng = np.random.default_rng(seed)
    flat = np.full((b, maxp), -1, np.int32)
    for i in range(b):
        n = rng.integers(1, maxp + 1)
        flat[i, :n] = rng.permutation(b * maxp)[:n]
    flat[0, 2] = -1                                  # a hole mid-row
    return flat


def _eq(t: torch.Tensor, j) -> bool:
    a, b = t.numpy(), np.asarray(j)
    return a.dtype == b.dtype and a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("leaf", [4, 8, 16])
@pytest.mark.parametrize("seed", [0, 3])
def test_radix_from_flat_and_translate_all_match(leaf, seed):
    flat = _flat(seed=seed)
    jr = JBT.radix_from_flat(jnp.asarray(flat), leaf_size=leaf)
    tr = BT.radix_from_flat(torch.tensor(flat), leaf_size=leaf)
    assert _eq(tr.directory, jr.directory) and _eq(tr.leaves, jr.leaves)
    assert tr.leaf_size == jr.leaf_size
    assert _eq(BT.translate_all(tr, BT.RADIX),
               JBT.translate_all(jr, JBT.RADIX))
    assert _eq(BT.flatten_radix(tr), flat)
    assert _eq(BT.translate_all(torch.tensor(flat), BT.FLAT), flat)
    assert (BT.table_bytes(tr, BT.RADIX) == JBT.table_bytes(jr, JBT.RADIX))
    assert (BT.table_bytes(torch.tensor(flat), BT.FLAT)
            == JBT.table_bytes(jnp.asarray(flat), JBT.FLAT))


def test_radix_leaf_must_divide_max_pages():
    with pytest.raises(ValueError):
        BT.radix_from_flat(torch.tensor(_flat(maxp=12)), leaf_size=8)


@pytest.mark.parametrize("mode", [BT.FLAT, BT.RADIX])
def test_translate_one_matches(mode):
    flat = _flat(seed=5)
    seq, page = np.array([0, 1, 2, 3, 0]), np.array([0, 3, 7, 1, 2])
    jt = jnp.asarray(flat) if mode == BT.FLAT else JBT.radix_from_flat(
        jnp.asarray(flat), leaf_size=8)
    tt = torch.tensor(flat) if mode == BT.FLAT else BT.radix_from_flat(
        torch.tensor(flat), leaf_size=8)
    want = JBT.translate_one(jt, jnp.asarray(seq), jnp.asarray(page), mode)
    got = BT.translate_one(tt, torch.tensor(seq), torch.tensor(page), mode)
    assert _eq(got, want)


def test_occupancy_matches():
    flat = np.arange(16, dtype=np.int32).reshape(2, 8)
    lens = np.array([32, 8], np.int32)
    want = JBT.occupancy(jnp.asarray(flat), jnp.asarray(lens), page_size=4)
    got = BT.occupancy(torch.tensor(flat), torch.tensor(lens), page_size=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lifecycle(mod, **kw):
    """One scripted allocation history; returns every observable."""
    kvm = mod.KVPageManager(num_pages=24, page_size=4, max_seqs=4,
                            max_len=32, **kw)
    out = []
    kvm.add_sequence(7, prompt_len=10)
    kvm.add_sequence(9, prompt_len=3)
    kvm.add_sequence(3, prompt_len=1)
    for _ in range(6):
        kvm.append_token(9)
    out.append(kvm.preferred_mode())
    out.append(kvm.occupancy())
    flat, mode = kvm.build_table([7, 9, 3])
    out += [np.asarray(flat), mode]
    radix = kvm.radix_table([9, 3])
    out += [np.asarray(radix.directory), np.asarray(radix.leaves)]
    kvm.free_sequence(7)
    out.append(kvm.pool.free_pages)
    kvm.add_sequence(5, prompt_len=6)            # reuses 7's freed pages
    out.append(list(kvm.pages[5]))
    kvm.free_sequence(9)
    out += [kvm.pool.free_pages, dict(kvm.stats),
            np.asarray(kvm.lengths_array([3])),
            np.asarray(kvm.flat_table([3]))]
    return out


def test_page_manager_lifecycle_matches():
    want = _lifecycle(JKVM)
    got = _lifecycle(KVM, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        else:
            assert g == w


def test_page_pool_matches():
    j, t = JKVM.PagePool(8), KVM.PagePool(8)
    for pool in (j, t):
        pool.allocate(3)
    assert j.allocate(2) == t.allocate(2)
    j.release([4, 0, 1]), t.release([4, 0, 1])
    j.release([]), t.release([])
    assert j.free_pages == t.free_pages
    assert j.allocate(4) == t.allocate(4)        # same free-list order
    for pool in (j, t):
        with pytest.raises(MemoryError):
            pool.allocate(8)
        with pytest.raises(ValueError, match="double free"):
            pool.release([7])
        with pytest.raises(ValueError, match="double free"):
            pool.release([2, 2])


def test_append_and_gather_kv_match():
    rng = np.random.default_rng(2)
    kp = rng.standard_normal((6, 4, 2, 8), np.float32)
    vp = rng.standard_normal((6, 4, 2, 8), np.float32)
    k_new = rng.standard_normal((3, 2, 8), np.float32)
    v_new = rng.standard_normal((3, 2, 8), np.float32)
    phys, slot = np.array([5, 0, 2], np.int32), np.array([3, 0, 1], np.int32)
    jk, jv = JKVM.append_kv(jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(k_new), jnp.asarray(v_new),
                            jnp.asarray(phys), jnp.asarray(slot))
    tk, tv = torch.tensor(kp), torch.tensor(vp)
    rk, rv = KVM.append_kv(tk, tv, torch.tensor(k_new), torch.tensor(v_new),
                           torch.tensor(phys), torch.tensor(slot))
    assert rk is tk and rv is tv                     # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    table = np.array([[5, 0, -1], [2, 2, 1]], np.int32)
    jg = JKVM.gather_kv(jk, jv, jnp.asarray(table))
    tg = KVM.gather_kv(tk, tv, torch.tensor(table))
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_translation_cache_matches():
    """The copied LRU gives the same hits, misses and versions."""
    ops = [("insert", 1), ("lookup", 1), ("bump", 1), ("lookup", 1),
           ("insert", 2), ("insert", 3), ("insert", 4), ("lookup", 2),
           ("invalidate", 3), ("lookup", 3), ("invalidate", 99),
           ("insert", 3), ("lookup", 3), ("lookup", 1)]
    trace = []
    for cache in (JCache(capacity=3), TranslationCache(capacity=3)):
        seen = []
        for op, sid in ops:
            if op == "insert":
                cache.insert(sid, None, np.full(4, sid, np.int32))
            elif op == "lookup":
                row = cache.lookup(sid)
                seen.append(None if row is None else row.tolist())
            else:
                getattr(cache, op)(sid)
            seen.append(cache.version(sid))
        trace.append((seen, cache.hits, cache.misses, cache.hit_rate))
    assert trace[0] == trace[1]


# ---------------------------------------------------------------------------
# the refcounted pool and prefix-shared sequences
# ---------------------------------------------------------------------------
def test_refcounted_pool_matches():
    """share / release / the *_array variants (repeated pages in one
    release) keep the same refcounts and free-list order as the JAX
    pool."""
    trace = []
    for mod in (JKVM, KVM):
        pool, seen = mod.PagePool(12), []
        a = pool.allocate(3)
        b = pool.allocate_array(4)
        pool.share(a[:2])
        pool.share_array(np.array([b[0], b[0], b[1]]))
        seen.append([pool.refcount(p) for p in range(12)])
        pool.release_array(np.array([b[0], b[0], a[0]]))   # repeats
        seen.append([pool.refcount(p) for p in range(12)])
        pool.release(a)
        pool.release_array(b)
        seen.append([pool.refcount(p) for p in range(12)])
        seen.append(pool.free_pages)
        seen.append(pool.allocate_array(6).tolist())
        seen.append(pool.allocate(2))
        assert pool.allocate_array(0).shape == (0,)
        with pytest.raises(MemoryError):
            pool.allocate_array(12)
        with pytest.raises(ValueError, match="double free"):
            pool.release_array(np.array([11, 11]))
        trace.append(seen)
    assert trace[0] == trace[1]


def _shared_lifecycle(mod, **kw):
    kvm = mod.KVPageManager(num_pages=10, page_size=4, max_seqs=4,
                            max_len=32, **kw)
    out = []
    kvm.add_sequence(1, prompt_len=12)                  # 3 pages
    kvm.add_sequence(2, prompt_len=10, shared_pages=kvm.pages[1][:2])
    out.append([kvm.pool.refcount(p) for p in range(10)])
    with pytest.raises(MemoryError):                     # unwinds shares
        kvm.add_sequence(3, prompt_len=40, shared_pages=kvm.pages[1][:2])
    out.append([kvm.pool.refcount(p) for p in range(10)])
    kvm.free_sequence(1)                                 # a sharer evicted
    out.append([kvm.pool.refcount(p) for p in range(10)])
    out.append(list(kvm.pages[2]))
    out.append(kvm.pool.free_pages)
    kvm.free_sequence(2)
    out += [kvm.pool.free_pages, dict(kvm.stats)]
    return out


def test_shared_pages_survive_a_sharers_eviction():
    want = _shared_lifecycle(JKVM)
    got = _shared_lifecycle(KVM, device="cpu")
    assert got == want
    # sharer 2 still maps the two shared pages after 1 is freed
    assert got[2][got[3][0]] == 1 and got[2][got[3][1]] == 1
    assert got[5] == 10


# ---------------------------------------------------------------------------
# PTE line counters and the costed translations, against the JAX package
# and against the cost meter's numpy twins
# ---------------------------------------------------------------------------
def _costed_rows(seed: int, b: int = 6, maxp: int = 32, leaf: int = 8):
    """Ragged rows with holes, a leaf shared by three rows (a common
    prefix), and a physically contiguous run (a one-line segment)."""
    flat = _flat(b, maxp, seed)
    flat[1, :leaf] = flat[0, :leaf]
    flat[2, :leaf] = flat[0, :leaf]
    flat[3, :20] = np.arange(1000, 1020)
    flat[4, :] = -1
    flat[4, 3] = 7                                   # one lonely page
    return flat


def _dup_radix(mod, seed: int):
    """A radix table whose directories name one leaf twice (prefix
    sharing inside a sequence) and leave holes."""
    rng = np.random.default_rng(seed)
    leaves = rng.integers(-1, 64, (5, 8)).astype(np.int32)
    directory = np.array([[0, 0, 1, -1], [2, 3, 2, 2], [-1, -1, 4, 0]],
                         np.int32)
    conv = torch.tensor if mod is BT else jnp.asarray
    return mod.RadixTable(directory=conv(directory), leaves=conv(leaves))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("leaf", [4, 8, 16])
def test_pte_line_counters_match_jax_and_twins(seed, leaf):
    from repro_torch.sim import cost_model as CM
    flat = _costed_rows(seed)
    t, j = torch.tensor(flat), jnp.asarray(flat)
    twin_flat, twin_radix = CM._np_row_lines(flat, leaf)
    _, twin_shared = CM._np_row_lines_shared(flat, leaf)
    tr, jr = BT.radix_from_flat(t, leaf), JBT.radix_from_flat(j, leaf)
    cases = [
        (BT.count_pte_lines(t, BT.FLAT), JBT.count_pte_lines(j, JBT.FLAT),
         twin_flat),
        (BT.count_pte_lines(tr, BT.RADIX),
         JBT.count_pte_lines(jr, JBT.RADIX), twin_radix),
        (BT.count_pte_lines(t, BT.SEGMENT),
         JBT.count_pte_lines(j, JBT.SEGMENT), CM._np_seg_lines(flat)),
        (BT.count_pte_lines(t, BT.INVERTED),
         JBT.count_pte_lines(j, JBT.INVERTED), CM._np_inv_lines(flat)),
        (BT.count_pte_lines_shared(t, leaf),
         JBT.count_pte_lines_shared(j, leaf), twin_shared),
        (BT.count_segment_lines(t), JBT.count_segment_lines(j),
         CM._np_seg_lines(flat)),
        (BT.count_inverted_lines(t), JBT.count_inverted_lines(j),
         CM._np_inv_lines(flat)),
    ]
    for got, want, twin in cases:
        assert _eq(got, want)
        np.testing.assert_array_equal(got.numpy(), twin)
    # the shared leaf is charged once, to row 0
    assert (BT.count_pte_lines_shared(t, leaf)
            <= BT.count_pte_lines(tr, BT.RADIX)).all()
    assert (BT.count_pte_lines(t, BT.FLAT)
            <= BT.count_pte_lines(tr, BT.RADIX)).all()
    with pytest.raises(ValueError):
        BT.count_pte_lines(t, "nope")
    with pytest.raises(ValueError):
        BT.count_pte_lines_shared(t, 5)


@pytest.mark.parametrize("seed", [0, 3])
def test_radix_lines_count_a_repeated_leaf_once(seed):
    got = BT.count_pte_lines(_dup_radix(BT, seed), BT.RADIX)
    want = JBT.count_pte_lines(_dup_radix(JBT, seed), JBT.RADIX)
    assert _eq(got, want)


@pytest.mark.parametrize("mode", [BT.FLAT, BT.RADIX])
@pytest.mark.parametrize("seed", [0, 4])
def test_costed_translations_match_jax(mode, seed):
    flat = _costed_rows(seed)
    tab, jtab = torch.tensor(flat), jnp.asarray(flat)
    if mode == BT.RADIX:
        tab, jtab = BT.radix_from_flat(tab, 8), JBT.radix_from_flat(jtab, 8)
    for got, want in zip(BT.translate_all_costed(tab, mode),
                         JBT.translate_all_costed(jtab, mode)):
        assert _eq(got, want)
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, flat.shape[0], 9)
    page = rng.integers(0, flat.shape[1], 9)
    got = BT.translate_one_costed(tab, torch.tensor(seq), torch.tensor(page),
                                  mode)
    want = JBT.translate_one_costed(jtab, jnp.asarray(seq),
                                    jnp.asarray(page), mode)
    assert _eq(got[0], want[0]) and _eq(got[1], want[1])
    assert BT.SEGMENT == JBT.SEGMENT and BT.INVERTED == JBT.INVERTED
