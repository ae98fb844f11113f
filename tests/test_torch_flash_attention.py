"""The port's flash attention (plain version, the CPU path) against the
JAX package: the Pallas kernel in interpret mode, its jnp oracle
``ref.flash_attention_ref`` and the model path's ``blockwise_attention``;
gradients against ``jax.vjp`` of ``blockwise_attention``.

Inputs are drawn with numpy from a seed and handed to both sides.
Tolerances (atol = rtol): forward 2e-5 in float32 and 2e-2 in bf16, the
JAX package's kernel tests' own (``tests/test_kernels.py``).  Gradients
in float32 5e-5: each gradient element sums S products over the keys
or queries in another order than XLA's (errors seen up to 4e-6 on
values up to 8.5).  bf16 gradients are held to the bf16 2e-2: JAX's
autodiff rounds to bf16 at other places than the port's backward (which
works in float32 from the saved log-sum-exp), so they differ by up to
one bf16 rounding step of the result (3.1e-2 seen on values of 4-8.5).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models.attention import blockwise_attention
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A

FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}

# tests/test_kernels.py's shapes: (b, s, h, kh, d, bq, bk)
SHAPES = [
    (2, 128, 4, 2, 64, 64, 64),      # GQA
    (1, 256, 8, 8, 32, 64, 128),     # MHA
    (2, 128, 4, 1, 128, 32, 32),     # MQA
]
MASKS = [(True, 16), (False, 0)]


def _inputs(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, s, kh, d), np.float32),
            rng.standard_normal((b, s, kh, d), np.float32),
            rng.standard_normal((b, s, h, d), np.float32))


def _torch(arrays, dtype):
    return [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,bq,bk", SHAPES)
def test_forward_matches_pallas_and_oracle(b, s, h, kh, d, bq, bk, dtype):
    arrays = _inputs(b, s, h, kh, d, seed=0)[:3]
    q, k, v = _torch(arrays, dtype)
    jq, jk, jv = _jax(arrays, dtype)
    got = ref.flash_attention_ref(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, bq=bq, bk=bk,
                                    interpret=True)
    _close(got, pallas, FWD_TOL[dtype])
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=True),
           FWD_TOL[dtype])


@pytest.mark.parametrize("causal,window", MASKS)
def test_masks_match_pallas(causal, window):
    q, k, v = _torch(_inputs(1, 128, 2, 2, 64, seed=1)[:3], "float32")
    jq, jk, jv = _jax(_inputs(1, 128, 2, 2, 64, seed=1)[:3], "float32")
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  bq=32, bk=32, interpret=True)
    _close(got, want, FWD_TOL["float32"])


def test_matches_blockwise_across_kv_blocks():
    """S = 1024 spans two of the plain version's 512-key blocks."""
    arrays = _inputs(1, 1024, 4, 2, 32, seed=2)[:3]
    got = ref.flash_attention_ref(*_torch(arrays, "float32"), causal=True,
                                  window=300)
    want = blockwise_attention(*_jax(arrays, "float32"), causal=True,
                               window=300, q_chunk=256, kv_chunk=256)
    _close(got, want, FWD_TOL["float32"])


def test_blockwise_window_case():
    """tests/test_kernels.py's blockwise case (window 50)."""
    arrays = _inputs(2, 256, 4, 2, 32, seed=3)[:3]
    got = ref.flash_attention_ref(*_torch(arrays, "float32"), causal=True,
                                  window=50)
    want = blockwise_attention(*_jax(arrays, "float32"), causal=True,
                               window=50, q_chunk=64, kv_chunk=64)
    _close(got, want, FWD_TOL["float32"])


def _jax_grads(arrays, dtype, causal, window):
    jq, jk, jv, jdo = _jax(arrays, dtype)
    _, vjp = jax.vjp(lambda q, k, v: blockwise_attention(
        q, k, v, causal=causal, window=window, q_chunk=64, kv_chunk=64),
        jq, jk, jv)
    return vjp(jdo)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (2, 128, 4, 2, 64, True, 0),      # GQA
    (1, 256, 8, 8, 32, True, 0),      # MHA
    (2, 128, 4, 1, 128, True, 0),     # MQA
    (1, 128, 2, 2, 64, True, 16),     # sliding window
    (1, 128, 2, 2, 64, False, 0),     # non-causal
])
def test_gradients_match_jax(b, s, h, kh, d, causal, window, dtype):
    arrays = _inputs(b, s, h, kh, d, seed=4)
    want = _jax_grads(arrays, dtype, causal, window)
    q, k, v, do = _torch(arrays, dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = ref.flash_attention_ref(*leaves, causal=causal,
                                       window=window, return_lse=True)
    out.backward(do)
    bwd = ref.flash_attention_bwd_ref(q, k, v, out.detach(), lse.detach(),
                                      do, causal=causal, window=window)
    tol = GRAD_TOL[dtype]
    for name, leaf, kernel_ref, w in zip("qkv", leaves, bwd, want):
        assert kernel_ref.dtype == leaf.dtype
        _close(leaf.grad, w, tol)
        _close(kernel_ref, w, tol)


@pytest.mark.parametrize("s,causal,window", [
    (64, True, 0), (64, True, 16), (64, False, 0),     # full_attention
    (3072, True, 0),                                   # the flash branch
])
def test_self_attention_matches_jax(s, causal, window):
    """Both branches of self_attention (threshold 2048 tokens) against
    the JAX package's, float32."""
    arrays = _inputs(1, s, 4, 2, 16, seed=8)[:3]
    got = A.self_attention(*_torch(arrays, "float32"), causal=causal,
                           window=window)
    want = jattn.self_attention(*_jax(arrays, "float32"), causal=causal,
                                window=window)
    _close(got, want, FWD_TOL["float32"])


# (b, s, h, kh, d, causal, window, Pallas block): float32 shapes for the
# CUDA float32 forward's arithmetic (its 16-key tiles, 3xTF32 products,
# P V folded 16 keys at a time)
TF32X3_CASES = [
    (2, 128, 4, 2, 64, True, 0, 64),      # GQA
    (2, 128, 4, 1, 128, True, 0, 32),     # MQA
    (1, 128, 2, 2, 64, True, 16, 32),     # sliding window
    (1, 100, 4, 2, 32, False, 0, 100),    # ragged S (a 4-key last tile)
    (2, 96, 6, 3, 36, True, 20, 32),      # head_dim 36
]


@pytest.mark.parametrize("b,s,h,kh,d,causal,window,blk", TF32X3_CASES,
                         ids=["gqa", "mqa", "window", "ragged", "d36"])
def test_tf32x3_ref_matches_pallas(b, s, h, kh, d, causal, window, blk):
    """The kernel's arithmetic holds the card's 2e-5 against the Pallas
    kernel (output) and the plain version (log-sum-exp)."""
    arrays = _inputs(b, s, h, kh, d, seed=9)[:3]
    q, k, v = _torch(arrays, "float32")
    got, lse = ref.flash_attention_tf32x3_ref(q, k, v, causal=causal,
                                              window=window, return_lse=True)
    assert got.shape == q.shape and lse.shape == (b, h, s)
    want = flash_attention_pallas(*_jax(arrays, "float32"), causal=causal,
                                  window=window, bq=blk, bk=blk,
                                  interpret=True)
    _close(got, want, FWD_TOL["float32"])
    _, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, return_lse=True)
    _close(lse, want_lse, FWD_TOL["float32"])


def test_tf32_alone_misses_the_tolerance():
    """1xTF32 (the hi halves alone) is off by far more than 2e-5, so the
    check above tells 3xTF32 from it."""
    arrays = _inputs(2, 128, 4, 2, 64, seed=9)[:3]
    q, k, v = _torch(arrays, "float32")
    want = _f32(flash_attention_pallas(*_jax(arrays, "float32"), causal=True,
                                       bq=64, bk=64, interpret=True))
    one = _f32(ref.flash_attention_tf32x3_ref(q, k, v, causal=True, x3=False))
    three = _f32(ref.flash_attention_tf32x3_ref(q, k, v, causal=True))
    tol = FWD_TOL["float32"]
    assert not np.allclose(one, want, rtol=tol, atol=tol)
    assert np.abs(one - want).max() > 10 * np.abs(three - want).max()


def test_bwd_ref_lse_is_logsumexp():
    q, k, v = _torch(_inputs(1, 64, 2, 1, 16, seed=5)[:3], "float32")
    _, lse = ref.flash_attention_ref(q, k, v, causal=True, return_lse=True)
    sc = torch.einsum("bshd,btd->bhst", q, k[:, :, 0]) / 4.0
    mask = torch.ones(64, 64, dtype=torch.bool).tril()
    want = torch.logsumexp(sc.masked_fill(~mask, -torch.inf), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ops_dispatch_cpu_is_differentiable_plain_version():
    arrays = _inputs(1, 64, 4, 2, 16, seed=6)
    q, k, v, do = _torch(arrays, "float32")
    q.requires_grad_(True)
    out = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_array_equal(
        out.detach().numpy(),
        ref.flash_attention_ref(q.detach(), k, v, causal=True).numpy())
    out.backward(do)
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("dtype,d", [("float32", 16), ("bfloat16", 64),
                                     ("bfloat16", 256), ("bfloat16", 192)],
                         ids=["simt", "sm90", "d256", "d192"])
def test_cuda_wrapper_rejects_cpu_tensors(dtype, d):
    q, k, v, do = _torch(_inputs(1, 64, 4, 2, d, seed=7), dtype)
    counters = ("launches_fwd", "launches_bwd", "launches_sm90_fwd",
                "launches_sm90_bwd", "launches_d256_fwd",
                "launches_d256_bwd", "launches_d192_fwd",
                "launches_d192_bwd")
    before = [getattr(FA, c) for c in counters]
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd_cuda(q, k, v, q, torch.zeros(1, 4, 64), do)
    with pytest.raises(ValueError, match="CUDA"):
        FA.FlashAttention.apply(q, k, v, True, 0)
    assert [getattr(FA, c) for c in counters] == before


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 16, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 96, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 256, "d256"), (torch.bfloat16, 96, ValueError),
    (torch.bfloat16, 192, "d192"), (torch.float32, 256, "simt"),
    (torch.float16, 128, ValueError), (torch.float16, 256, ValueError),
    (torch.float32, 192, "simt"), (torch.bfloat16, 320, ValueError),
    (torch.float32, 200, "simt"), (torch.float32, 264, ValueError),
])
def test_route(dtype, d, route):
    """bf16 with head_dim 64 / 128 takes the sm90 wgmma kernels, bf16 at
    256 and 192 the d256 template's wgmma ones (d192: deepseek-v2's MLA
    head), float32 at every head_dim up to 256 the 3xTF32 mma.sync ones
    (gemma3-1b's 256, deepseek-v2's 192, and a padded 200); nothing else
    has a kernel (bf16 at other head dims, any dtype above 256)."""
    if route is ValueError:
        with pytest.raises(ValueError, match="no flash_attention kernel"):
            FA._route(dtype, d)
    else:
        assert FA._route(dtype, d) == route


# gemma3-1b's attention at small S: head_dim 256, 4 query heads on 1 KV
# head, causal with and without a window (its local and global layers)
D256_CASES = [(1, 128, 4, 1, 256, True, 16), (2, 64, 4, 1, 256, True, 0),
              (1, 96, 2, 1, 256, False, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", D256_CASES,
                         ids=["window", "global", "noncausal"])
def test_head_dim_256_matches_pallas(b, s, h, kh, d, causal, window, dtype):
    """The plain version (the d256 kernel's oracle on the card) takes
    head_dim 256, with the window, against the Pallas kernel."""
    arrays = _inputs(b, s, h, kh, d, seed=11)[:3]
    got, lse = ref.flash_attention_ref(*_torch(arrays, dtype), causal=causal,
                                       window=window, return_lse=True)
    assert got.shape == (b, s, h, d) and lse.shape == (b, h, s)
    want = flash_attention_pallas(*_jax(arrays, dtype), causal=causal,
                                  window=window, bq=32, bk=32,
                                  interpret=True)
    _close(got, want, FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_gradients_match_jax(dtype):
    """The backward's plain version at head_dim 256 with the window
    against jax.vjp of blockwise_attention."""
    b, s, h, kh, d, causal, window = D256_CASES[0]
    arrays = _inputs(b, s, h, kh, d, seed=12)
    want = _jax_grads(arrays, dtype, causal, window)
    q, k, v, do = _torch(arrays, dtype)
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL[dtype])


# deepseek-v2's MLA attention at small S: head_dim 192 (128 + 64), as
# many key heads as query heads, causal; and the kernel's other masks
D192_CASES = [(1, 128, 4, 4, 192, True, 0), (1, 96, 4, 2, 192, True, 16),
              (2, 64, 2, 2, 192, False, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", D192_CASES,
                         ids=["mla", "window", "noncausal"])
def test_head_dim_192_matches_pallas(b, s, h, kh, d, causal, window, dtype):
    """The plain version (the d192 kernel's oracle on the card) takes
    head_dim 192 against the Pallas kernel in interpret mode, with the
    MLA layout's zero-padded v columns (v is 128 wide there)."""
    q, k, v = _inputs(b, s, h, kh, d, seed=13)[:3]
    v[..., 128:] = 0.0
    arrays = (q, k, v)
    got, lse = ref.flash_attention_ref(*_torch(arrays, dtype), causal=causal,
                                       window=window, return_lse=True)
    assert got.shape == (b, s, h, d) and lse.shape == (b, h, s)
    want = flash_attention_pallas(*_jax(arrays, dtype), causal=causal,
                                  window=window, bq=32, bk=32,
                                  interpret=True)
    _close(got, want, FWD_TOL[dtype])
    assert float(got[..., 128:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_192_gradients_match_jax(dtype):
    """The backward's plain version at head_dim 192 against jax.vjp of
    blockwise_attention."""
    b, s, h, kh, d, causal, window = D192_CASES[0]
    arrays = _inputs(b, s, h, kh, d, seed=14)
    want = _jax_grads(arrays, dtype, causal, window)
    q, k, v, do = _torch(arrays, dtype)
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL[dtype])


def _chip_smoke():
    """The repository's chip_smoke.py as a module (importing it needs no
    card: its checks run in main())."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("causal,window", [
    (True, 0), (True, 7), (False, 0), (False, 7), (True, 100)])
def test_chip_smoke_pairs_and_bound_match_brute_force(causal, window):
    cs = _chip_smoke()
    b, s, h, kh, d = 2, 50, 4, 2, 16
    case = dict(q=torch.zeros(b, s, h, d, dtype=torch.bfloat16),
                k=torch.zeros(b, s, kh, d, dtype=torch.bfloat16),
                causal=causal, window=window)
    qp, kp = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    mask = np.ones((s, s), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    pairs = int(mask.sum())
    assert cs.attended_pairs(case) == pairs
    q_bytes, kv_bytes, lse_bytes = b * s * h * d * 2, b * s * kh * d * 2, \
        b * h * s * 4
    for backward, ops, nbytes in (
            (False, 4, 2 * q_bytes + 2 * kv_bytes + lse_bytes),
            (True, 10, 4 * q_bytes + 4 * kv_bytes + lse_bytes)):
        t_ops = ops * d * b * h * pairs / cs.PEAK_FLOPS[torch.bfloat16]
        t_bytes = nbytes / cs.HBM_BYTES_PER_S
        ms, by = cs.flash_bound(case, backward)
        assert ms == pytest.approx(max(t_ops, t_bytes) * 1e3, rel=1e-12)
        assert by == ("bytes" if t_bytes >= t_ops else "operations")
        assert cs.kernel_flops(case, backward) == \
            (14 if backward else 4) * d * b * h * pairs


# the d256 / d192 backward's dK/dV split plan: (b, s, h, kh, d, causal,
# window) -> splits, at gemma3's and deepseek-v2's training shapes and every
# phase-6 d256 and d192 case of chip_smoke.py.  gemma3's global layer: 128
# key-tile blocks, the first walking 4 x 64 = 256 steps against an SM's
# share of 126, so 2 ways; its window-512 layers walk at most 4 x 10 steps
# each, so none; deepseek-v2 (G = 1, 8,192 blocks): none; h 8 / kh 2 with
# a window: G = 4 heads over 3 splits, chunks crossing heads
D256_PLANS = {
    "gemma3_global": ((2, 4096, 4, 1, 256, True, 0), 2),
    "gemma3_local": ((2, 4096, 4, 1, 256, True, 512), 1),
    "deepseek": ((1, 4096, 128, 128, 192, True, 0), 1),
    "d256_ragged": ((1, 1000, 8, 2, 256, True, 100), 3),
    "d256_mqa": ((1, 2048, 8, 1, 256, True, 0), 4),
    "d256_g3": ((1, 1000, 6, 2, 256, True, 100), 3),
    "d256_noncausal": ((1, 777, 4, 1, 256, False, 0), 4),
    "d192_s4096": ((1, 4096, 16, 16, 192, True, 0), 1),
    "d192_noncausal": ((1, 777, 16, 16, 192, False, 0), 1),
    "d192_ragged": ((1, 1000, 8, 2, 192, True, 100), 3),
}


# the float32 backward's dK/dV split plan above head_dim 128 (its 64-key
# tiles and 64-query units: d256_bwd_plan's rule), at 8c's calls
# (gemma3's global layer 2 ways at 2 sequences and 3 at 8c's one, its
# window-512 layers and deepseek-v2 none), every phase-6 float32 case
# above 128 of chip_smoke.py (G = 3 over 4 splits: chunks crossing
# heads), and at head_dim 128, where two dK/dV blocks share an SM and the
# plan never splits
SIMT_PLANS = {
    "gemma3_global": ((2, 4096, 4, 1, 256, True, 0), 2),
    "gemma3_local": ((2, 4096, 4, 1, 256, True, 512), 1),
    "gemma3_global_b1": ((1, 4096, 4, 1, 256, True, 0), 3),
    "deepseek": ((1, 4096, 128, 128, 192, True, 0), 1),
    "d192_noncausal": ((1, 777, 16, 16, 192, False, 0), 1),
    "d256_ragged": ((1, 1000, 8, 2, 256, True, 100), 3),
    "d200": ((2, 777, 6, 3, 200, True, 100), 1),
    "d192_g3_split": ((1, 1000, 6, 2, 192, True, 0), 4),
    "d128_global": ((2, 4096, 4, 1, 128, True, 0), 1),
}


def _tile_steps(s, g, causal, window, tile=64):
    """(query head, query tile) steps of each key tile, from the mask: a
    query tile counts if some query in it attends some key of the tile,
    i.e. the differences q - k over the two tiles meet the allowed ones
    (0 .. window - 1 under both masks; >= 0 causal; <= window - 1)."""
    out = []
    for k0 in range(0, s, tile):
        k1 = min(s, k0 + tile) - 1
        n = 0
        for q0 in range(0, s, tile):
            q1 = min(s, q0 + tile) - 1
            lo, hi = q0 - k1, q1 - k0
            if causal:
                lo = max(lo, 0)
            if window > 0:
                hi = min(hi, window - 1)
            n += lo <= hi
        out.append(g * n)
    return out


@pytest.mark.parametrize("name", list(D256_PLANS))
def test_d256_bwd_plan(name):
    """The split count, the stats and partial dK/dV scratch shapes; no
    partials where no block walks more than twice an SM's share of the
    steps (deepseek-v2, gemma3's windowed layers)."""
    (b, s, h, kh, d, causal, window), splits = D256_PLANS[name]
    plan = FA.d256_bwd_plan(b, s, h, kh, d, causal=causal, window=window)
    assert plan["splits"] == splits
    assert plan["stats"] == (2, b, h, -(-s // 128) * 128)
    if splits == 1:
        assert plan["partials"] is None
    else:
        assert plan["partials"] == (2, splits, b, s, kh, d)
    steps = _tile_steps(s, h // kh, causal, window)
    share = b * kh * sum(steps) / FA.H100_SMS
    want = 1
    while want < FA.D256_MAX_SPLITS and max(steps) > 2 * share * want:
        want += 1
    assert splits == want


def test_d256_bwd_plan_covers_chip_smoke_cases():
    """Every d256 / d192 case phase 6 runs has its plan held above, one
    of them with a split that does not divide G."""
    cs = _chip_smoke()
    cases = {**cs.D256_CASES, **cs.D192_CASES,
             "deepseek": cs.DEEPSEEK_ATTN}
    for name, c in cases.items():
        assert D256_PLANS[name][0] == tuple(
            c[k] for k in ("b", "s", "h", "kh", "d", "causal", "window"))
    assert any(sp > 1 and (sh[2] // sh[3]) % sp
               for sh, sp in D256_PLANS.values())


@pytest.mark.parametrize("name", list(SIMT_PLANS))
def test_simt_bwd_plan(name):
    """The float32 backward's split count and its delta (``stats``) and
    partial dK/dV scratch shapes; above head_dim 128 the d256 rule at its 64-row tiles,
    at 128 and below never a split."""
    (b, s, h, kh, d, causal, window), splits = SIMT_PLANS[name]
    plan = FA.simt_bwd_plan(b, s, h, kh, d, causal=causal, window=window)
    assert plan["splits"] == splits
    assert plan["stats"] == (b, h, s)
    if splits == 1:
        assert plan["partials"] is None
    else:
        assert plan["partials"] == (2, splits, b, s, kh, d)
    if d > FA.SIMT_SPLIT_MIN_HEAD_DIM:
        steps = _tile_steps(s, h // kh, causal, window, FA.SIMT_BWD_TILE)
        share = b * kh * sum(steps) / FA.H100_SMS
        want = 1
        while want < FA.D256_MAX_SPLITS and max(steps) > 2 * share * want:
            want += 1
        assert splits == want


def test_simt_bwd_plan_covers_chip_smoke_cases():
    """Every float32 case above head_dim 128 that phase 6 runs has its
    plan held above, one of them with a split that does not divide G."""
    cs = _chip_smoke()
    cases = {**cs.SIMT_WIDE_HELD, "gemma3_global": cs.GEMMA_ATTN,
             "deepseek": cs.DEEPSEEK_ATTN}
    for name, c in cases.items():
        assert SIMT_PLANS[name][0] == tuple(
            c[k] for k in ("b", "s", "h", "kh", "d", "causal", "window"))
    assert any(sp > 1 and (sh[2] // sh[3]) % sp
               for sh, sp in SIMT_PLANS.values())


#: (b, s, h, d, causal, window) -> the query rows of a float32 forward
#: block: 64 (4 warps) up to head_dim 192; above, 128 (8 pairs of warps)
#: but where a causal mask leaves fewer 128-row blocks than SMs (gemma3-1b's
#: global layer at 8c's one sequence: the longest block would set the
#: time), and on phase 6's short ragged cases
SIMT_FWD_PLANS = {
    "gemma3_global": ((2, 4096, 4, 256, True, 0), 128),
    "gemma3_global_b1": ((1, 4096, 4, 256, True, 0), 64),
    "gemma3_local": ((2, 4096, 4, 256, True, 512), 128),
    "gemma3_local_b1": ((1, 4096, 4, 256, True, 512), 128),
    "d256_noncausal_b1": ((1, 4096, 4, 256, False, 0), 128),
    "d256_ragged": ((1, 1000, 8, 256, True, 100), 64),
    "d200": ((2, 777, 6, 200, True, 100), 64),
    "deepseek": ((1, 4096, 128, 192, True, 0), 64),
    "d128_global": ((2, 4096, 4, 128, True, 0), 64),
}


@pytest.mark.parametrize("name", list(SIMT_FWD_PLANS))
def test_simt_fwd_plan(name):
    (b, s, h, d, causal, window), rows = SIMT_FWD_PLANS[name]
    assert FA.simt_fwd_plan(b, s, h, d, causal=causal,
                            window=window) == rows


def test_simt_fwd_plan_runs_both_tilings_in_chip_smoke():
    """Phase 6's float32 cases above head_dim 192 hold the forward on
    128-row and on 64-row blocks, and phase 8c's gemma3-1b global call
    (one sequence: 64-row blocks) is among them and timed as a row of
    the kernels line, windowed too (128-row blocks)."""
    cs = _chip_smoke()
    rows = {FA.simt_fwd_plan(*(c[k] for k in ("b", "s", "h", "d")),
                             causal=c["causal"], window=c["window"])
            for c in cs.SIMT_WIDE_HELD.values() if c["d"] > 192}
    assert rows == {64, 128}
    call = cs.GEMMA_F32_ATTN
    assert call["b"] == 1 and call["s"] == cs.WIDE_TRAIN_TOKENS
    assert call in cs.SIMT_WIDE_HELD.values()
    assert cs.SIMT_WIDE_CASES["simt_d256_b1"][1:] == (call, "simt_d256")
    plan = [FA.simt_fwd_plan(*(call[k] for k in ("b", "s", "h", "d")),
                             causal=True, window=w) for w in (0, 512)]
    assert plan == [64, 128]


def test_simt_partials_of_gemma3_take_32_mib():
    """The float32 backward's partials at gemma3's global layer take what the
    d256 route's do."""
    plan = FA.simt_bwd_plan(2, 4096, 4, 1, 256)
    assert 4 * int(np.prod(plan["partials"])) == 32 << 20


def test_d256_partials_of_gemma3_take_32_mib():
    plan = FA.d256_bwd_plan(2, 4096, 4, 1, 256)
    assert 4 * int(np.prod(plan["partials"])) == 32 << 20


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("b,s,h,kh,causal,window", [
    (1, 200, 6, 2, True, 70),     # G = 3, ragged, window
    (2, 160, 4, 1, True, 0),      # gemma3's global layer's layout
    (1, 150, 2, 2, False, 0),     # G = 1, no mask
], ids=["g3_window", "mqa", "noncausal"])
def test_split_reduce_equals_unsplit_backward(b, s, h, kh, causal, window,
                                              splits):
    """The plain form of the dK/dV split and its fixed-order reduction
    gives the unsplit plain backward, float32, to 1e-6 of each tensor's
    largest element."""
    arrays = _inputs(b, s, h, kh, 16, seed=15)
    q, k, v, do = _torch(arrays, "float32")
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       window=window)
    got = ref.flash_attention_bwd_split_ref(q, k, v, out, lse, do,
                                            causal=causal, window=window,
                                            splits=splits, tile=32)
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-6 * float(w.abs().max()), err
