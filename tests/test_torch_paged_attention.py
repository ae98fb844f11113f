"""The port's paged decode attention (repro_torch.kernels) against the JAX
package's Pallas kernel (interpret mode) and its jnp oracle.

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU the port runs the kernel's plain PyTorch version; the CUDA kernel
itself is checked against it on the card by chip_smoke.py.
Tolerances are those of tests/test_kernels.py: f32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.core import block_table as BT
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as PA

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _paged_inputs(b, h, kh, d, page, maxp, seed=0, holes=(), lens=None):
    """numpy q, pools, table (-1 = unmapped) and lengths (>= 1 token)."""
    rng = np.random.default_rng(seed)
    n = b * maxp + 2
    q = rng.standard_normal((b, 1, h, d), np.float32)
    kp = rng.standard_normal((n, page, kh, d), np.float32)
    vp = rng.standard_normal((n, page, kh, d), np.float32)
    tab = np.full((b, maxp), -1, np.int32)
    lengths = np.zeros((b,), np.int32)
    perm = rng.permutation(n)
    k = 0
    for i in range(b):
        lengths[i] = (rng.integers(1, maxp * page + 1) if lens is None
                      else lens[i])
        used = -(-int(lengths[i]) // page)
        tab[i, :used] = perm[k:k + used]
        k += used
    for i, p in holes:
        tab[i, p] = -1
    return q, kp, vp, tab, lengths


def _both(inputs, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    q, kp, vp, tab, lens = inputs
    jx = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
          jnp.asarray(tab), jnp.asarray(lens))
    tx = (torch.tensor(q).to(tdt), torch.tensor(kp).to(tdt),
          torch.tensor(vp).to(tdt), torch.tensor(tab), torch.tensor(lens))
    return jx, tx


def _assert_close(got_t, want_j, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               rtol=tol, atol=tol)


SHAPES = [
    (2, 8, 2, 64, 16, 8),       # GQA, G = 4
    (1, 4, 1, 128, 32, 4),      # MQA
    (3, 4, 4, 32, 8, 16),       # MHA
    (4, 16, 8, 128, 16, 8),     # internlm2-1.8b heads, G = 2
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,d,page,maxp", SHAPES)
def test_plain_matches_pallas_interpret(b, h, kh, d, page, maxp, dtype):
    jx, tx = _both(_paged_inputs(b, h, kh, d, page, maxp), dtype)
    want = paged_attention_pallas(*jx, interpret=True)
    _assert_close(ref.paged_attention_ref(*tx), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,d,page,maxp", SHAPES)
def test_plain_matches_jax_ref(b, h, kh, d, page, maxp, dtype):
    jx, tx = _both(_paged_inputs(b, h, kh, d, page, maxp, seed=1), dtype)
    want = jref.paged_attention_ref(*jx)
    _assert_close(ref.paged_attention_ref(*tx), want, dtype)


@pytest.mark.parametrize("window", [8, 40])
def test_windowed(window):
    jx, tx = _both(_paged_inputs(2, 4, 2, 64, 16, 6, seed=3), "float32")
    want = paged_attention_pallas(*jx, window=window, interpret=True)
    _assert_close(ref.paged_attention_ref(*tx, window=window), want,
                  "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unmapped_holes(dtype):
    """-1 entries inside the attended range are masked, as in Pallas."""
    inputs = _paged_inputs(3, 8, 2, 32, 8, 6, seed=4, lens=[48, 40, 33],
                           holes=((0, 1), (1, 0), (2, 4)))
    jx, tx = _both(inputs, dtype)
    want = paged_attention_pallas(*jx, interpret=True)
    _assert_close(ref.paged_attention_ref(*tx), want, dtype)


def test_fully_masked_row_returns_zero():
    """A row with no attendable token gives 0, the Pallas kernel's
    semantics (the JAX jnp oracle gives the mean of page 0's V)."""
    inputs = _paged_inputs(2, 4, 2, 16, 8, 4, seed=5, lens=[0, 20])
    jx, tx = _both(inputs, "float32")
    want = np.asarray(paged_attention_pallas(*jx, interpret=True))
    got = ref.paged_attention_ref(*tx).numpy()
    assert (want[0] == 0).all() and (got[0] == 0).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_physical_placement_invariance():
    """NDPage core invariant: output independent of WHERE pages live."""
    q, kp, vp, tab, lens = _paged_inputs(2, 4, 2, 64, 8, 4, seed=7)
    t = lambda a: torch.tensor(a)  # noqa: E731
    out1 = ref.paged_attention_ref(t(q), t(kp), t(vp), t(tab), t(lens))
    perm = np.random.default_rng(1).permutation(kp.shape[0])
    inv = np.argsort(perm)
    tab2 = np.where(tab >= 0, inv[np.maximum(tab, 0)], -1).astype(np.int32)
    out2 = ref.paged_attention_ref(t(q), t(kp[perm]), t(vp[perm]),
                                   t(tab2), t(lens))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)


def test_ops_dispatch_cpu_takes_plain_version_and_launches_nothing():
    _, tx = _both(_paged_inputs(1, 2, 1, 32, 8, 2), "float32")
    before = PA.launches
    a = ops.paged_attention(*tx)
    assert torch.equal(a, ref.paged_attention_ref(*tx))
    assert PA.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises."""
    _, tx = _both(_paged_inputs(1, 2, 1, 32, 8, 2), "float32")
    before = PA.launches
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention_cuda(*tx)
    assert PA.launches == before


#: split-K cases: (name, pages_per_split, inputs kwargs, window, radix).
#: maxp is 8 throughout, so 8 and 16 are one split holding every page
SPLIT_CASES = [
    ("pps1", 1, dict(seed=20), 0, False),
    ("pps2", 2, dict(seed=21), 0, False),
    ("pps4", 4, dict(seed=22), 0, False),
    ("pps8_all_pages", 8, dict(seed=23), 0, False),
    ("pps16_past_maxp", 16, dict(seed=24), 0, False),
    ("holes", 2, dict(seed=25, lens=[64, 50, 33],
                      holes=((0, 1), (0, 2), (1, 0), (2, 4))), 0, False),
    ("hole_fills_a_split", 2, dict(seed=26, lens=[64, 64, 20],
                                   holes=((0, 2), (0, 3))), 0, False),
    ("window", 2, dict(seed=27, lens=[64, 37, 9]), 12, False),
    ("window_one_split", 1, dict(seed=28, lens=[64, 61, 50]), 5, False),
    ("radix", 2, dict(seed=29), 0, True),
    ("one_split_not_empty", 1, dict(seed=30, lens=[3, 8, 1]), 0, False),
    ("fully_masked_row", 2, dict(seed=31, lens=[0, 40, 17]), 0, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,pps,inputs,window,radix", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_k_matches_pallas_and_plain(name, pps, inputs, window, radix,
                                          dtype):
    """The CUDA kernel's split-K algorithm (per-split partials with P
    rounded against the split's max, then the fixed-order combine) in its
    plain form, against the Pallas kernel (interpret mode) and the
    one-pass plain version, at the file's tolerances."""
    b = 3
    jx, tx = _both(_paged_inputs(b, 8, 2, 32, 8, 8, **inputs), dtype)
    want = paged_attention_pallas(*jx, window=window, interpret=True)
    q, kp, vp, tab, lens = tx
    if radix:
        flat = tab
        tab = BT.translate_all(
            BT.radix_from_flat(flat, BT.leaf_size_for(flat.shape[1])),
            BT.RADIX)
        assert torch.equal(tab, flat)
    got = ref.paged_attention_split_ref(q, kp, vp, tab, lens, window=window,
                                        pages_per_split=pps)
    _assert_close(got, want, dtype)
    plain = ref.paged_attention_ref(q, kp, vp, tab, lens, window=window)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=tol, atol=tol)
    empty = (lens == 0).nonzero().flatten().tolist()
    for i in empty:
        assert (got[i] == 0).all()
    if name == "fully_masked_row":
        assert empty == [0]


@pytest.mark.parametrize("b,kh,maxp,plan", [
    (4, 8, 32, (2, 16, 512)),     # the serve shape: 4 pages give 256 blocks
    (8, 8, 64, (4, 16, 1024)),    # B 8: 4 pages already give 1,024
    (1, 1, 8, (1, 8, 8)),         # a tiny call halves down to 1 page
    (64, 8, 4, (4, 1, 512)),      # one split holds the whole table
])
def test_split_plan_from_shapes(b, kh, maxp, plan):
    """The split size depends on the table width and B * KH only."""
    assert PA.split_plan(b, kh, maxp) == plan
