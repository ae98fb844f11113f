"""The port's multi-head latent attention (``repro_torch.models.attention``
``MLA``, ``mla_apply``, ``mla_decode``) against the JAX package's
``mla_init`` / ``mla_apply`` / ``mla_decode`` on the same weights and
inputs (numpy, from a seed), deepseek-v2 at smoke width in float32
(nope 16 + rope 8 query / key columns, v 16, kv_lora 16, q_lora 24).

Held to 2e-5 (float32 sums in other orders through the four
projections); at 3,072 tokens, where both packages leave the masked
softmax for blockwise attention (the JAX package's ``blockwise_attention``
under ``jax.checkpoint``, the port's flash attention, its plain version
here), to the ROADMAP's 1e-4, gradients included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import attention as JA
from repro_torch import config as C
from repro_torch.models import attention as A
from repro_torch.models.layers import rope_tables

TOL = dict(rtol=2e-5, atol=2e-5)
LONG_TOL = dict(rtol=1e-4, atol=1e-4)
NAME = "deepseek-v2-236b"
_LEAVES = ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo")


def _cfgs():
    jcfg = dataclasses.replace(jsmoke(jget_arch(NAME)), dtype="float32")
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(NAME)),
                              dtype="float32")
    return jcfg, cfg


def _pair(seed=0):
    """(JAX cfg, port cfg, JAX params, port MLA) on the same weights; the
    norm scales drawn away from 1 so a missed norm shows."""
    jcfg, cfg = _cfgs()
    p = JA.mla_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    for norm in ("q_norm", "kv_norm"):
        n = p[norm]["scale"].shape[0]
        p[norm] = {"scale": jnp.asarray(
            1.0 + 0.2 * rng.standard_normal(n), jnp.float32)}
    mla = A.MLA(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for n in _LEAVES:
            getattr(mla, n).copy_(torch.tensor(np.asarray(p[n])))
        for norm in ("q_norm", "kv_norm"):
            getattr(mla, norm).scale.copy_(
                torch.tensor(np.asarray(p[norm]["scale"])))
    return jcfg, cfg, p, mla


def _tables(cfg, positions):
    return rope_tables(torch.tensor(positions), cfg.mla.qk_rope_head_dim,
                       cfg.rope_theta)


def test_rope_widths():
    """MLA rotates its qk_rope_head_dim columns (8 here, 64 at full
    width), not the config's head_dim; a decode step builds its tables
    at that width."""
    _, cfg = _cfgs()
    assert cfg.mla.qk_rope_head_dim == 8 and cfg.head_dim == 16
    assert A.rope_widths(cfg) == {8}
    assert A.rope_widths(C.get_arch(NAME)) == {64}
    assert A.rope_widths(C.get_arch("granite-moe-1b-a400m")) == {64}
    step = A.prepare_decode(cfg, torch.tensor([3, 5]), "dense", None,
                            cache_len=0, page_size=0, latent_len=12)
    assert set(step.rope) == {8} and step.rope[8][0].shape == (2, 1, 1, 4)
    assert step.latent_mask.shape == (2, 1, 1, 12)
    assert step.latent_mask.sum(-1).flatten().tolist() == [4, 6]
    assert step.masks is None and step.phys_all is None


@pytest.mark.parametrize("b,s", [(2, 24), (1, 200)])
def test_mla_apply_matches(b, s):
    """The training path below the blockwise threshold: the masked
    softmax over one head of nope + rope columns, v padded to it."""
    jcfg, cfg, p, mla = _pair()
    x = np.random.default_rng(s).standard_normal((b, s, cfg.d_model),
                                                 np.float32)
    pos = np.arange(s)[None]
    want = JA.mla_apply(p, jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = A.mla_apply(mla, torch.tensor(x), *_tables(cfg, pos), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_apply_blockwise_branch_matches():
    """3,072 tokens (above BLOCKWISE_THRESHOLD): the port's flash
    attention at head_dim 24 (its plain version on the CPU), the JAX
    package's jax.checkpoint(blockwise_attention); output and the
    gradients of x and of every weight."""
    jcfg, cfg, p, mla = _pair(seed=1)
    s = 3072
    assert s > A.BLOCKWISE_THRESHOLD
    x = np.random.default_rng(2).standard_normal((1, s, cfg.d_model),
                                                 np.float32)
    w = np.random.default_rng(3).standard_normal((1, s, cfg.d_model),
                                                 np.float32)
    pos = np.arange(s)[None]

    def jloss(params, xx):
        return jnp.sum(JA.mla_apply(params, xx, jnp.asarray(pos), jcfg) * w)

    (jy, (jgp, jgx)) = (
        JA.mla_apply(p, jnp.asarray(x), jnp.asarray(pos), jcfg),
        jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x)))
    mla.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    y = A.mla_apply(mla, xt, *_tables(cfg, pos), cfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **LONG_TOL)
    torch.sum(y * torch.tensor(w)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **LONG_TOL)
    for n in _LEAVES:
        g = getattr(mla, n).grad.numpy()
        scale = float(np.abs(np.asarray(jgp[n])).max())
        np.testing.assert_allclose(g / scale, np.asarray(jgp[n]) / scale,
                                   **LONG_TOL, err_msg=n)


def test_mla_decode_steps_match():
    """Absorbed-matrix decode, one token a step for 10 steps with the
    sequences at different lengths: the output and both latent caches
    (c_kv and the rope key rotated at the rope width) every step."""
    jcfg, cfg, p, mla = _pair(seed=4)
    b, t = 3, 16
    m = cfg.mla
    jckv = jnp.zeros((b, t, m.kv_lora_rank), jnp.float32)
    jkr = jnp.zeros((b, t, m.qk_rope_head_dim), jnp.float32)
    ckv = torch.zeros((b, t, m.kv_lora_rank))
    kr = torch.zeros((b, t, m.qk_rope_head_dim))
    lengths = np.array([0, 3, 5], np.int32)
    rng = np.random.default_rng(5)
    for step in range(10):
        x = rng.standard_normal((b, 1, cfg.d_model), np.float32)
        jy, jckv, jkr = JA.mla_decode(p, jnp.asarray(x), jckv, jkr,
                                      jnp.asarray(lengths), jcfg)
        st = A.prepare_decode(cfg, torch.tensor(lengths), "dense", None,
                              cache_len=0, page_size=0, latent_len=t)
        y = A.mla_decode(mla, torch.tensor(x), ckv, kr, st, cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(ckv.numpy(), np.asarray(jckv), **TOL)
        np.testing.assert_allclose(kr.numpy(), np.asarray(jkr), **TOL)
        lengths = lengths + 1


def test_mla_decode_equals_the_expanded_attention():
    """The absorbed form attends exactly as the expanded training form
    does over the same tokens: a prompt fed one token a step gives, at
    its last position, mla_apply's output there (float32)."""
    _, cfg, _, mla = _pair(seed=6)
    s = 9
    x = torch.tensor(np.random.default_rng(7).standard_normal(
        (1, s, cfg.d_model), np.float32))
    full = A.mla_apply(mla, x, *_tables(cfg, np.arange(s)[None]), cfg)
    m = cfg.mla
    ckv = torch.zeros((1, s, m.kv_lora_rank))
    kr = torch.zeros((1, s, m.qk_rope_head_dim))
    for i in range(s):
        st = A.prepare_decode(cfg, torch.tensor([i]), "dense", None,
                              cache_len=0, page_size=0, latent_len=s)
        y = A.mla_decode(mla, x[:, i:i + 1], ckv, kr, st, cfg)
        np.testing.assert_allclose(y[0, 0].numpy(), full[0, i].numpy(),
                                   **TOL, err_msg=f"position {i}")


def test_mla_parameter_shapes():
    cfg = C.get_arch(NAME)
    mla = A.MLA(cfg, torch.bfloat16, torch.device("meta"))
    shapes = {n: tuple(t.shape) for n, t in mla.named_parameters()}
    assert shapes == {
        "w_dq": (5120, 1536), "q_norm.scale": (1536,),
        "w_uq": (1536, 128 * 192), "w_dkv": (5120, 512 + 64),
        "kv_norm.scale": (512,), "w_uk": (512, 128 * 128),
        "w_uv": (512, 128 * 128), "wo": (128 * 128, 5120)}
    n = sum(t.numel() for n, t in mla.named_parameters()
            if not n.endswith("scale"))
    assert n == cfg._mixer_params(C.ATTN_MLA)
