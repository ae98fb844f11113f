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
