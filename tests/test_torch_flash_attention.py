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


@pytest.mark.parametrize("dtype,d", [("float32", 16), ("bfloat16", 64)],
                         ids=["simt", "sm90"])
def test_cuda_wrapper_rejects_cpu_tensors(dtype, d):
    q, k, v, do = _torch(_inputs(1, 64, 4, 2, d, seed=7), dtype)
    counters = ("launches_fwd", "launches_bwd", "launches_sm90_fwd",
                "launches_sm90_bwd")
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
    (torch.bfloat16, 96, ValueError), (torch.bfloat16, 256, ValueError),
    (torch.float32, 256, ValueError), (torch.float16, 128, ValueError),
])
def test_route(dtype, d, route):
    """bf16 with head_dim 64 / 128 takes the wgmma kernels, float32 up to
    128 the 3xTF32 mma.sync ones; nothing else has a kernel."""
    if route is ValueError:
        with pytest.raises(ValueError, match="no flash_attention kernel"):
            FA._route(dtype, d)
    else:
        assert FA._route(dtype, d) == route


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
