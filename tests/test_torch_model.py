"""The port's internlm2 decode model against the JAX package's, on the
same weights (``params_from_numpy`` of the JAX ``init_params`` tree).

Smoke width, float32.  Logits are held to rtol = atol = 1e-4: both sides
sum in float32, in other orders (XLA's dots vs PyTorch's matmuls and
einsums), through two layers and a vocabulary projection.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import decode_step as jdecode_step
from repro.models import init_decode_state as jinit_state
from repro.models import init_params as jinit_params
from repro.models import layers as JL
from repro.models import prefill as jprefill
from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.models import (decode_step, init_decode_state, init_params,
                                params_from_numpy, prefill)
from repro_torch.models import layers as L

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = dataclasses.replace(jsmoke(jget_arch("internlm2-1.8b")),
                           dtype="float32")
CFG = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                          dtype="float32")
JPARAMS = jinit_params(JCFG, jax.random.PRNGKey(0))
TREE = jax.tree.map(np.asarray, JPARAMS)
MODEL = params_from_numpy(CFG, TREE, device="cpu")


def test_configs_match():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    full = C.get_arch("internlm2-1.8b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jget_arch("internlm2-1.8b"))
    assert full.param_count() == jget_arch("internlm2-1.8b").param_count()


def test_params_from_numpy_splits_layers():
    assert len(MODEL.stack.layers) == CFG.num_layers
    for i, block in enumerate(MODEL.stack.layers):
        np.testing.assert_array_equal(
            block.mixer.wq.numpy(),
            TREE["stack"]["scan"]["block_0"]["mixer"]["wq"][i])
        np.testing.assert_array_equal(
            block.ffn.w_gate.numpy(),
            TREE["stack"]["scan"]["block_0"]["ffn"]["w_gate"][i])
    np.testing.assert_array_equal(MODEL.lm_head.numpy(), TREE["lm_head"])
    assert not any(p.requires_grad for p in MODEL.parameters())


def test_layers_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 16), np.float32)
    pos = np.array([[0, 5, 17], [3, 4, 100]], np.int32)
    cos, sin = L.rope_tables(torch.tensor(pos), 16, 10_000.0)
    np.testing.assert_allclose(
        L.apply_rope(torch.tensor(x), cos, sin).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 10_000.0)), rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((2, 1, 64), np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm(torch.tensor(scale), torch.tensor(h)).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)
    ffn = MODEL.stack.layers[0].ffn
    jffn = jax.tree.map(lambda a: a[0],
                        JPARAMS["stack"]["scan"]["block_0"]["ffn"])
    np.testing.assert_allclose(
        L.ffn_apply(ffn, torch.tensor(h)).numpy(),
        np.asarray(JL.ffn_apply(jffn, jnp.asarray(h), True)), **TOL)


@pytest.mark.parametrize("kv_mode", ["dense", BT.FLAT, BT.RADIX])
def test_decode_step_logits_match(kv_mode):
    b, max_len, page = 3, 24, 4
    jst = jinit_state(JCFG, b, max_len, kv_mode, page)
    st = init_decode_state(CFG, b, max_len, kv_mode, page, device="cpu")
    tokens = np.random.default_rng(1).integers(1, CFG.vocab_size, (6, b))
    for step in range(tokens.shape[0]):
        jl, jst = jdecode_step(JPARAMS, JCFG, jst,
                               jnp.asarray(tokens[step], jnp.int32),
                               kv_mode=kv_mode)
        tl, st = decode_step(MODEL, CFG, st,
                             torch.tensor(tokens[step], dtype=torch.int32),
                             kv_mode=kv_mode)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (
            b, CFG.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
    np.testing.assert_array_equal(st["lengths"].numpy(),
                                  np.asarray(jst["lengths"]))


def test_paged_pools_match_after_decode():
    """The in-place pool updates land where the JAX pools' copies do."""
    jst = jinit_state(JCFG, 2, 16, BT.FLAT, 4)
    st = init_decode_state(CFG, 2, 16, BT.FLAT, 4, device="cpu")
    for tok in ([5, 9], [7, 1], [3, 3]):
        _, jst = jdecode_step(JPARAMS, JCFG, jst, jnp.asarray(tok, jnp.int32),
                              kv_mode=BT.FLAT)
        _, st = decode_step(MODEL, CFG, st, torch.tensor(tok),
                            kv_mode=BT.FLAT)
    for layer, st_l in enumerate(st["stack"]):
        for name in ("kp", "vp"):
            np.testing.assert_allclose(
                st_l[name].numpy(),
                np.asarray(jst["stack"]["scan"]["block_0"][name][layer]),
                **TOL)


def test_prefill_matches():
    prompt = np.random.default_rng(3).integers(1, CFG.vocab_size, (2, 7))
    jl, _ = jprefill(JPARAMS, JCFG, jnp.asarray(prompt, jnp.int32),
                     kv_mode=BT.FLAT, max_len=32, page_size=8)
    tl, st = prefill(MODEL, CFG, torch.tensor(prompt, dtype=torch.int32),
                     kv_mode=BT.FLAT, max_len=32, page_size=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert st["lengths"].tolist() == [7, 7]


def test_init_params_is_seeded_and_on_device():
    a = init_params(CFG, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(CFG, torch.Generator().manual_seed(3), device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert a.embed.dtype == torch.float32 and a.embed.device.type == "cpu"


def test_other_block_kinds_raise_not_implemented():
    mla = dataclasses.replace(CFG, layer_pattern=((C.ATTN_MLA, C.DENSE_FF),))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(mla, torch.Generator(), device="cpu")
