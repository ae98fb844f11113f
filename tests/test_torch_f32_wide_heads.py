"""Float32 attention at the head dims above 128 that two models train
with, past ``BLOCKWISE_THRESHOLD``: gemma3-1b's heads of 256 (its global
layers, and its local ones with a window of 512) and deepseek-v2's MLA
head of 128 + 64 = 192 (v padded to it).  On the card both take the
float32 (``"simt"``) flash kernels; here the port's CPU path, their plain
version, is held against live calls into the JAX package at 3,072
tokens, the first length above 2,048 that ``blockwise_attention``'s
1,024-token chunks take.  Inputs are drawn with numpy from a seed.

Tolerances (atol = rtol), the ROADMAP's: 2e-5 for one attention call,
output and gradients (each gradient element sums S products in another
order than XLA's); 1e-4 for ``mla_apply``, four float32 projections
around the attention, gradients each against its largest element.

Also here: the kernel's arithmetic (``ref.flash_attention_tf32x3_ref``:
16-key tiles, 3xTF32 products) at those head dims against the Pallas
kernel, the plain form of the backward's dK/dV split above head_dim
128 (``ref.flash_attention_bwd_split_ref`` at its 64-row tiles) against
the unsplit backward and ``jax.vjp`` of ``blockwise_attention``, the
fake-tensor FLOP count of a float32 training step of each model, which
must record the simt route alone, and ``chip_smoke.py``'s cases and
bounds for the new instantiations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MLAConfig as JMLAConfig
from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as JA
from repro_torch import config as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.models import attention as A
from repro_torch.models.layers import rope_tables
from repro_torch.roofline import counts
from repro_torch.roofline.flop_stats import step_flops
from test_torch_flash_attention import _chip_smoke

S = 3072
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d),
                          (b, s, h, d))]


# (b, h, kh, d, window): gemma3-1b's global and local layers (4 query
# heads on one KV head, cut to 2 and 1), deepseek-v2's MLA head (one KV
# head a query head), and a head_dim padded inside the kernel
SELF_CASES = {"gemma3_global": (1, 2, 1, 256, 0),
              "gemma3_local": (1, 2, 1, 256, 512),
              "mla_192": (1, 2, 2, 192, 0),
              "padded_200": (1, 1, 1, 200, 100)}


@pytest.mark.parametrize("name", list(SELF_CASES))
def test_self_attention_matches_jax(name):
    """The flash branch of ``self_attention`` at 3,072 tokens: output,
    and the gradients of q, k and v (autograd of the port's path and the
    card backward's plain version, ``flash_attention_bwd_ref``) against
    ``jax.vjp`` of the JAX package's ``self_attention``."""
    b, h, kh, d, window = SELF_CASES[name]
    assert S > A.BLOCKWISE_THRESHOLD
    arrays = _inputs(b, S, h, kh, d, seed=d + window)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    want, vjp = jax.vjp(lambda q, k, v: JA.self_attention(
        q, k, v, causal=True, window=window), jq, jk, jv)
    want_grads = vjp(jdo)
    q, k, v, do = (torch.tensor(a) for a in arrays)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = A.self_attention(*leaves, causal=True, window=window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **ATTN_TOL)
    got.backward(do)
    _, lse = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                     return_lse=True)
    plain = ref.flash_attention_bwd_ref(q, k, v, got.detach(), lse, do,
                                        causal=True, window=window)
    for n, leaf, bwd, w in zip("qkv", leaves, plain, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **ATTN_TOL, err_msg=f"d{n} (autograd)")
        np.testing.assert_allclose(bwd.numpy(), np.asarray(w), **ATTN_TOL,
                                   err_msg=f"d{n} (bwd_ref)")


# deepseek-v2's MLA at its real head dims (nope 128 + rope 64 query / key
# columns, v 128), the rest at smoke width: 2 heads, d_model 64, kv_lora
# 16, q_lora 24
MLA_DIMS = dict(kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128)
MLA_LEAVES = ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo")


def _mla_pair(seed):
    """(JAX cfg, port cfg, JAX params, port MLA) on the same weights; the
    norm scales drawn away from 1 so a missed norm shows."""
    name = "deepseek-v2-236b"
    jcfg = dataclasses.replace(jsmoke(jget_arch(name)), dtype="float32",
                               num_heads=2, num_kv_heads=2, head_dim=128,
                               mla=JMLAConfig(**MLA_DIMS))
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(name)),
                              dtype="float32", num_heads=2, num_kv_heads=2,
                              head_dim=128, mla=C.MLAConfig(**MLA_DIMS))
    p = JA.mla_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    for norm in ("q_norm", "kv_norm"):
        n = p[norm]["scale"].shape[0]
        p[norm] = {"scale": jnp.asarray(
            1.0 + 0.2 * rng.standard_normal(n), jnp.float32)}
    mla = A.MLA(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for n in MLA_LEAVES:
            getattr(mla, n).copy_(torch.tensor(np.asarray(p[n])))
        for norm in ("q_norm", "kv_norm"):
            getattr(mla, norm).scale.copy_(
                torch.tensor(np.asarray(p[norm]["scale"])))
    return jcfg, cfg, p, mla


def test_mla_apply_real_head_dims_matches_jax():
    """``mla_apply`` at 3,072 tokens with deepseek-v2's head dims: one
    attention call at head_dim 192 (the simt kernels' d192 instantiation
    on the card); output and the gradients of x and of every weight
    against the JAX package's ``mla_apply`` and ``jax.grad``."""
    jcfg, cfg, p, mla = _mla_pair(seed=5)
    m = cfg.mla
    assert m.qk_nope_head_dim + m.qk_rope_head_dim == 192
    rng = np.random.default_rng(6)
    x, w = (rng.standard_normal((1, S, cfg.d_model), np.float32)
            for _ in range(2))
    pos = np.arange(S)[None]

    def jloss(params, xx):
        return jnp.sum(JA.mla_apply(params, xx, jnp.asarray(pos), jcfg) * w)

    jy = JA.mla_apply(p, jnp.asarray(x), jnp.asarray(pos), jcfg)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    mla.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    cos, sin = rope_tables(torch.tensor(pos), m.qk_rope_head_dim,
                           cfg.rope_theta)
    y = A.mla_apply(mla, xt, cos, sin, cfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **LAYER_TOL)
    torch.sum(y * torch.tensor(w)).backward()
    scale = float(np.abs(np.asarray(jgx)).max())
    np.testing.assert_allclose(xt.grad.numpy() / scale,
                               np.asarray(jgx) / scale, **LAYER_TOL)
    for n in MLA_LEAVES:
        g = getattr(mla, n).grad.numpy()
        scale = float(np.abs(np.asarray(jgp[n])).max())
        np.testing.assert_allclose(g / scale, np.asarray(jgp[n]) / scale,
                                   **LAYER_TOL, err_msg=n)


# (b, s, h, kh, d, causal, window, Pallas block): the float32 forward's
# arithmetic at NT 32 (256, and 200 padded to 256) and NT 24 (192); at
# NT 32 also GQA past one 128-row tile of the kernel, and a window without
# the causal mask
TF32X3_WIDE = {"d256_window": (1, 128, 4, 1, 256, True, 16, 32),
               "d192": (1, 128, 2, 2, 192, True, 0, 64),
               "d192_noncausal": (1, 100, 2, 2, 192, False, 0, 100),
               "d200_gqa": (1, 96, 4, 2, 200, True, 20, 32),
               "d256_gqa": (1, 160, 4, 2, 256, True, 0, 32),
               "d256_window_noncausal": (1, 96, 2, 1, 256, False, 24, 32)}


@pytest.mark.parametrize("name", list(TF32X3_WIDE))
def test_tf32x3_ref_matches_pallas(name):
    """The kernel's arithmetic holds the card's 2e-5 against the Pallas
    kernel (output) and the plain version (log-sum-exp) at the head dims
    of the NT 24 and 32 instantiations."""
    b, s, h, kh, d, causal, window, blk = TF32X3_WIDE[name]
    q, k, v = (torch.tensor(a) for a in _inputs(b, s, h, kh, d, seed=9)[:3])
    got, lse = ref.flash_attention_tf32x3_ref(q, k, v, causal=causal,
                                              window=window, return_lse=True)
    want = flash_attention_pallas(*(jnp.asarray(t.numpy())
                                    for t in (q, k, v)),
                                  causal=causal, window=window, bq=blk,
                                  bk=blk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    _, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **ATTN_TOL)


# (b, s, h, kh, d, window): the dK/dV split's plain form at the kernel's
# 64-row tiles and both instantiations' head dims above 128 (200 padded
# inside the kernel): gemma3's layout (4 / 1 heads), G = 3 (chunks cross
# heads) and a window
SPLIT_WIDE = {"d256_mqa": (2, 256, 4, 1, 256, 0),
              "d192_g3": (1, 256, 6, 2, 192, 0),
              "d200_window": (1, 320, 4, 2, 200, 70)}


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(SPLIT_WIDE))
def test_split_ref_at_wide_tiles(name, splits):
    """``flash_attention_bwd_split_ref`` at the float32 dK/dV kernel's
    tile (``FA.SIMT_BWD_TILE``), float32, causal: the unsplit plain backward
    to 1e-6 of each tensor's largest element, and ``jax.vjp`` of the JAX
    package's ``blockwise_attention`` (64-row chunks) at ATTN_TOL."""
    b, s, h, kh, d, window = SPLIT_WIDE[name]
    arrays = _inputs(b, s, h, kh, d, seed=s + d)
    q, k, v, do = (torch.tensor(a) for a in arrays)
    out, lse = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                       return_lse=True)
    got = ref.flash_attention_bwd_split_ref(
        q, k, v, out, lse, do, causal=True, window=window, splits=splits,
        tile=FA.SIMT_BWD_TILE)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True,
                                       window=window)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: JA.blockwise_attention(
        q, k, v, causal=True, window=window, q_chunk=64, kv_chunk=64),
        jq, jk, jv)
    for n, g, w in zip("qkv", got, vjp(jdo)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN_TOL,
                                   err_msg=f"d{n}")


def _attention_flops(cfg, shape, backward: bool) -> int:
    """Flash work of one pass over every attention layer: gemma3's local
    layers masked to their window, deepseek's MLA heads of 192."""
    b, s = shape.global_batch, shape.seq_len
    total = 0
    for mixer, _ in cfg.layer_kinds():
        if mixer == C.ATTN_MLA:
            d = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        else:
            d = cfg.head_dim
        window = cfg.window_size if mixer == C.ATTN_LOCAL else 0
        total += counts.flash_flops(b, s, cfg.num_heads, d, True, window,
                                    backward)
    return total


@pytest.mark.parametrize("arch, layers", [("gemma3-1b", 8),
                                          ("deepseek-v2-236b", 1)])
def test_step_flops_float32_takes_the_simt_route(arch, layers):
    """``step_flops`` of a float32 training step at 2,304 tokens on fake
    CPU tensors (full width; gemma3-1b's 8 layers hold both prefix
    layers and one period, so a global layer; deepseek-v2's first, dense
    layer): the flash work is recorded under the simt route alone, the
    forward twice (the recompute of activation checkpointing)."""
    cfg = dataclasses.replace(C.get_arch(arch), num_layers=layers,
                              dtype="float32")
    shape = C.ShapeConfig("t", 2304, 1, "train")
    assert shape.seq_len > A.BLOCKWISE_THRESHOLD and cfg.remat
    got = step_flops(cfg, shape, device="cpu")
    kernels = {k for k in got if not k.startswith("aten.") and k != "total"}
    assert kernels == {"flash_attention_simt_fwd",
                       "flash_attention_simt_bwd"}
    assert got["flash_attention_simt_fwd"] == 2 * _attention_flops(
        cfg, shape, False)
    assert got["flash_attention_simt_bwd"] == _attention_flops(
        cfg, shape, True)


def test_chip_smoke_wide_cases_route_and_bounds():
    """``chip_smoke.py``'s float32 cases above head_dim 128 take the simt
    route at both new instantiations (NT 24 and 32, one head_dim padded
    inside the kernel from unaligned rows), its spill gate names every
    kernel of both (dK/dV also in its split form, the NT 32 forward also
    on 64-row blocks) and the reduction of the split dK/dV partials, and
    the
    bounds it prints at 8c's calls are the TF32 peak over three for 4 D
    (forward) and 10 D (backward) operations an attended pair and head."""
    cs = _chip_smoke()
    nts = set()
    for c in cs.SIMT_WIDE_HELD.values():
        assert c["d"] > 128 and FA._route(torch.float32, c["d"]) == "simt"
        nts.add(24 if c["d"] <= 192 else 32)
    assert nts == {24, 32}
    assert any(c.get("unaligned") and c["d"] not in (192, 256)
               for c in cs.SIMT_WIDE_HELD.values())     # padded, 4-byte
    for nt in (24, 32):
        for k in ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                  "flash_bwd_dkdv_split_kernel", "flash_bwd_dq_kernel"):
            assert f"{k}<{nt}>" in cs.SIMT_NO_SPILL
    assert "flash_bwd_reduce_kernel" in cs.SIMT_NO_SPILL
    assert "flash_fwd_rows64_kernel<32>" in cs.SIMT_NO_SPILL
    want = {("simt_d256", 0): (0.4168, 1.0421),
            ("simt_d256", 512): (0.0977, 0.2442),
            ("simt_d256_b1", 0): (0.2084, 0.5210),
            ("simt_d256_b1", 512): (0.0488, 0.1221),
            ("simt_d192", 0): (5.0020, 12.5051)}
    for (key, window), (fwd, bwd) in want.items():
        shape = dict(cs.SIMT_WIDE_CASES[key][1], window=window)
        b, s, h, kh, d = (shape[n] for n in ("b", "s", "h", "kh", "d"))
        case = dict(q=torch.empty((b, s, h, d), device="meta"),
                    k=torch.empty((b, s, kh, d), device="meta"),
                    causal=shape["causal"], window=window)
        for backward, ms in ((False, fwd), (True, bwd)):
            got, by = cs.flash_bound(case, backward)
            assert by == "operations" and got == pytest.approx(ms, abs=5e-5)
