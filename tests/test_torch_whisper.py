"""whisper-tiny, the encoder-decoder, on the port against the JAX package,
on the same weights (``params_from_numpy`` of the JAX ``init_params``
tree), with live calls of ``repro`` on both sides.

Smoke width (``smoke_variant``: 2 + 2 layers, 16 audio frames) in
float32: the sinusoidal positions (bit-equal) and the decode-time
position, the cross-attention (``cross_kv``, ``cross_attn_apply``), the
encoder (``_encode``), ``forward_train``, a two-step AdamW train,
``prefill(audio_frames=)`` in every KV mode, decode against the
training forward, the serving engine (streams exact with slots reused
and after preemptions; the engine runs at the zero ``enc_out`` of the
decode state, as the JAX engine does), the weights' round trip, the
parameter count and the audio stubs.  Logits, losses and gradients at
rtol = atol = 1e-4 (float32 sums in other orders).  One bf16 case holds
the JAX package's dtype promotion: float32 frames through bf16 weights
run the encoder, its output and the cross K/V in float32.

The trace CLI (``python -m repro_torch.workloads.ingest``) is held
against ``scripts/convert_trace.py`` on both fixture traces: the npz
arrays and every printed line.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import attention as JA
from repro.models import decode_step as jdecode_step
from repro.models import forward_train as jforward_train
from repro.models import init_decode_state as jinit_state
from repro.models import init_params as jinit_params
from repro.models import layers as JL
from repro.models import model_zoo as JMZ
from repro.models import prefill as jprefill
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro.util import resilience as jresilience
from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.launch import serve as LS
from repro_torch.launch import specs as SP
from repro_torch.launch import train as LT
from repro_torch.models import (decode_step, forward_train,
                                init_decode_state, params_from_numpy,
                                params_to_numpy, prefill)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as MZ
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import data as D
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.roofline.flop_stats import step_flops
from repro_torch.train.train_loop import (TrainState, decayed_names,
                                          loss_fn, make_train_step,
                                          trainable)
from repro_torch.util import resilience
from repro_torch.util.device import is_fake
from repro_torch.workloads.ingest import __main__ as CLI

NAME = "whisper-tiny"
TOL = dict(rtol=1e-4, atol=1e-4)
#: decode after prefill against the training forward's last position:
#: the JAX package's own invariant (tests/test_models.py)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)
#: bf16 weights on both sides: the bf16 kernels' tolerance
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
KV_MODES = ["dense", BT.FLAT, BT.RADIX]
#: AdamW's eps 1e-6, as for the variants with tied embeddings
#: (tests/test_torch_model_variants.py ``OPT``): every vocabulary row
#: takes a gradient through the tied logits, some near the default eps
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-6)
ENGINE = dict(max_len=48, page_size=8)
ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXDIR = ROOT / "tests" / "fixtures" / "traces"
FIXTURES = ["gups_small.champsim.xz", "graph_small.lackey.gz"]


@functools.lru_cache(maxsize=None)
def _setup(dtype="float32"):
    """(JAX cfg, port cfg, JAX params, numpy tree, port model) at smoke
    width, built once per dtype."""
    jcfg = dataclasses.replace(jsmoke(jget_arch(NAME)), dtype=dtype)
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(NAME)),
                              dtype=dtype)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, cfg, jparams, tree, params_from_numpy(cfg, tree, "cpu")


def _batches(cfg, jcfg, b=2, s=24, step=0):
    """The same synthetic batch with the audio stubs for both packages
    (equal bit for bit)."""
    raw = D.add_modality_stubs(
        D.SyntheticLM(cfg.vocab_size, s, b).batch_at(step), cfg, seed=step)
    jraw = jdata.add_modality_stubs(
        jdata.SyntheticLM(jcfg.vocab_size, s, b).batch_at(step), jcfg,
        seed=step)
    assert raw.keys() == jraw.keys()
    for k in raw:
        np.testing.assert_array_equal(raw[k], jraw[k])
    return ({k: torch.from_numpy(v) for k, v in raw.items()},
            {k: jnp.asarray(v) for k, v in jraw.items()})


def _frames(cfg, b, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32) * 0.02


def _assert_tree_close(got, want, tol):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for (path, g), w in zip(flat_g, jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _cross_params(jparams, layer=0):
    """The JAX cross-attention subtree of decoder layer ``layer``."""
    return jax.tree.map(lambda a: a[layer],
                        jparams["stack"]["scan"]["block_0"]["cross"])


# ---------------------------------------------------------------------------
# config, parameter count, weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_param_count(smoke):
    """The configs field for field, and the JAX formula's count: exactly
    36,438,912 for whisper-tiny (encoder blocks with two norms each,
    cross-attention and ``norm_cross`` per decoder layer, no
    ``enc_norm``)."""
    cfg, jcfg = C.get_arch(NAME), jget_arch(NAME)
    if smoke:
        cfg, jcfg = C.smoke_variant(cfg), jsmoke(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    if not smoke:
        assert cfg.param_count() == 36_438_912
    leaves = sum(p.numel() for p in MZ.Model(cfg, torch.device("meta"))
                 .parameters())
    # the leaves hold the count plus the final norm's and enc_norm's
    # scales, which the JAX formula leaves out
    assert leaves == cfg.param_count() + 2 * cfg.d_model


def test_full_width_model_builds():
    """``init_params`` takes whisper-tiny at full width (on the meta
    device: shapes only), with the JAX package's leaf shapes."""
    model = MZ.Model(C.get_arch(NAME), torch.device("meta"))
    assert len(model.encoder.layers) == 4 and len(model.stack.layers) == 4
    assert all(b.cross is not None for b in model.stack.layers)
    assert all(b.cross is None for b in model.encoder.layers)
    assert model.lm_head is None
    assert tuple(model.stack.layers[0].cross.wq.shape) == (384, 384)
    assert tuple(model.encoder.layers[0].ffn.w_up.shape) == (384, 1536)
    assert not model.stack.layers[0].ffn.gated


def test_params_roundtrip():
    """params_to_numpy(params_from_numpy(tree)) is the tree, leaf for
    leaf: the encoder, enc_norm, and every decoder block's norm_cross
    and cross."""
    _, cfg, _, tree, model = _setup()
    got = params_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert set(got["stack"]["scan"]["block_0"]) == {
        "norm1", "norm2", "mixer", "ffn", "norm_cross", "cross"}
    assert set(got["encoder"]["scan"]["block_0"]) == {
        "norm1", "norm2", "mixer", "ffn"}


def test_decayed_names_follow_the_jax_tree():
    """The encoder's layers are scanned in the JAX tree, so their norm
    scales are decayed; the decoder's norm_cross too; enc_norm and the
    final norm are not."""
    model = _setup()[4]
    names = decayed_names(model)
    assert "encoder.layers.0.norm1.scale" in names
    assert "encoder.layers.1.norm2.scale" in names
    assert "stack.layers.0.norm_cross.scale" in names
    assert "stack.layers.1.cross.wq" in names
    assert "enc_norm.scale" not in names
    assert "final_norm.scale" not in names


def test_audio_stubs_bit_equal():
    """The audio frames are the JAX package's bit for bit; vision is
    drawn before audio from one generator (a config with both)."""
    cfg, jcfg = C.get_arch(NAME), jget_arch(NAME)
    raw = D.SyntheticLM(cfg.vocab_size, 8, 2).batch_at(0)
    got = D.add_modality_stubs(raw, cfg, seed=5)
    want = jdata.add_modality_stubs(raw, jcfg, seed=5)
    assert got.keys() == want.keys() == {"tokens", "labels", "audio_frames"}
    assert got["audio_frames"].shape == (2, 1500, 384)
    assert got["audio_frames"].dtype == np.float32
    np.testing.assert_array_equal(got["audio_frames"], want["audio_frames"])
    both = dataclasses.replace(C.smoke_variant(cfg), vision_tokens=3)
    jboth = dataclasses.replace(jsmoke(jcfg), vision_tokens=3)
    got = D.add_modality_stubs(raw, both, seed=2)
    want = jdata.add_modality_stubs(raw, jboth, seed=2)
    for k in ("vision_embeds", "audio_frames"):
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# positions, cross-attention, encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq_len,d", [(1500, 384), (4096, 384), (16, 64),
                                       (7, 2), (5, 6)])
def test_sinusoidal_positions_bit_equal(seq_len, d):
    got = L.sinusoidal_positions(seq_len, d, torch.device("cpu"))
    want = np.asarray(JL.sinusoidal_positions(seq_len, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fake_first", [True, False])
def test_sinusoidal_positions_fake_and_real_never_mix(fake_first):
    """The table's cache holds numpy, not a tensor: in one process a call
    under ``FAKE_MODE`` returns a fake tensor and a real call a real one
    with the JAX package's values, whichever comes first, and a real
    result written in place leaves the next call's values alone."""
    L._sinusoid_table.cache_clear()
    want = np.asarray(JL.sinusoidal_positions(16, 64))
    cpu = torch.device("cpu")

    def fake():
        with SP.FAKE_MODE:
            got = L.sinusoidal_positions(16, 64, cpu)
        assert is_fake(got)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32

    def real():
        got = L.sinusoidal_positions(16, 64, cpu)
        assert not is_fake(got)
        np.testing.assert_array_equal(got.numpy(), want)
        got.add_(1.0)

    for call in ((fake, real, real) if fake_first else (real, fake, real)):
        call()


def test_step_flops_after_a_real_forward():
    """A real forward, then ``step_flops`` of the smoke variant at the
    same lengths (the cached tables' keys) in the same process, then the
    real forward again: the count equals one taken with the cache
    emptied, and the second forward's logits are real and equal the
    first's bit for bit."""
    jcfg, cfg, _, _, model = _setup()
    tb, _ = _batches(cfg, jcfg)
    with torch.no_grad():
        first, _ = forward_train(model, cfg, tb)
    shape = C.ShapeConfig("t", tb["tokens"].shape[1], 2, "train")
    got = step_flops(cfg, shape, device="cpu")
    with torch.no_grad():
        again, _ = forward_train(model, cfg, tb)
    L._sinusoid_table.cache_clear()
    assert got["total"] > 0 and got == step_flops(cfg, shape, device="cpu")
    assert not is_fake(first) and not is_fake(again)
    assert torch.equal(first, again)


@pytest.mark.parametrize("d", [384, 64, 2])
def test_decode_positions_match_the_jax_formula(d):
    """The decode-time position (the JAX ``decode_step``'s own float32
    formula, not ``sinusoidal_positions``), restated in jnp here; the
    decode tests below hold it live through ``decode_step``.  Both sides
    compute in float32, and their ``pow`` and ``sin`` may round the last
    place apart: 6.4e-6 at index 4,095, where the angle's own float32
    step is 2.4e-4, so the bound is 1e-5."""
    lengths = np.array([0, 1, 7, 255, 1499, 4095], np.int32)
    half = d // 2
    inv = 1.0 / (10_000 ** (jnp.arange(half) / max(half - 1, 1)))
    ang = jnp.asarray(lengths)[:, None].astype(jnp.float32) * inv[None]
    want = np.asarray(jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], -1))
    got = L.decode_positions(torch.from_numpy(lengths), d)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_and_cross_attn(dtype):
    """``cross_kv`` over a float32 encoder output and ``cross_attn_apply``
    of the decoder's activations (float32, or bf16 with the bf16
    weights: q bf16 against float32 K/V) against the JAX functions."""
    jcfg, cfg, jparams, _, model = _setup(dtype)
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, 16, 64), np.float32)
    x = rng.standard_normal((2, 5, 64), np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.from_numpy(x).to(cfg.torch_dtype)
    jcross = _cross_params(jparams, 1)
    cross = model.stack.layers[1].cross
    jk, jv = JA.cross_kv(jcross, jnp.asarray(enc), jcfg)
    k, v = A.cross_kv(cross, torch.from_numpy(enc), cfg)
    assert k.dtype == v.dtype == torch.float32 and jk.dtype == jnp.float32
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **tol)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **tol)
    jy = JA.cross_attn_apply(jcross, jx, jk, jv, jcfg)
    y = A.cross_attn_apply(cross, tx, k, v, cfg)
    assert y.dtype == cfg.torch_dtype and str(jy.dtype) == dtype
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches(dtype):
    """The non-causal encoder over float32 frames: with bf16 weights it
    runs in float32 on both sides (the JAX matmul promotes)."""
    jcfg, cfg, jparams, _, model = _setup(dtype)
    frames = _frames(cfg, 2)
    want = JMZ._encode(jparams, jcfg, jnp.asarray(frames))
    got = MZ._encode(model, cfg, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(TOL if dtype == "float32" else BF16_TOL))


def test_encoder_is_not_causal():
    """A change to the last frame moves the first frame's encoding (a
    causal encoder would leave it)."""
    _, cfg, _, _, model = _setup()
    frames = _frames(cfg, 1)
    a = MZ._encode(model, cfg, torch.from_numpy(frames))
    frames[:, -1] += 1.0
    b = MZ._encode(model, cfg, torch.from_numpy(frames))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def test_forward_train_matches():
    jcfg, cfg, jparams, _, model = _setup()
    tb, jb = _batches(cfg, jcfg)
    logits, aux = forward_train(model, cfg, tb)
    jlogits, jaux = jforward_train(jparams, jcfg, jb)
    assert tuple(logits.shape) == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    assert float(aux) == float(jaux) == 0.0


def test_loss_and_gradients_match():
    """One loss and its gradient through the decoder, the
    cross-attention and the encoder: the tied embedding gets both of its
    uses' parts."""
    jcfg, cfg, jparams, tree, _ = _setup()
    model = trainable(params_from_numpy(cfg, tree, "cpu"))
    tb, jb = _batches(cfg, jcfg, b=2, s=16)
    loss, parts = loss_fn(model, cfg, tb)
    loss.backward()
    (jloss, jparts), jgrads = jax.value_and_grad(jtl.loss_fn, has_aux=True)(
        jparams, jcfg, jb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    np.testing.assert_allclose(float(parts["xent"]), float(jparts["xent"]),
                               **TOL)
    _assert_tree_close(params_to_numpy(model, grads=True), jgrads, TOL)


def test_train_step_matches():
    """Two AdamW steps with 2 microbatches (the audio frames split with
    the tokens): metrics, then every weight.  Weight decay 0.1 at lr
    1e-2 moves a decayed unit norm scale by 1e-3, so a decay set other
    than the JAX package's (the encoder's scanned norm scales and the
    decoder's norm_cross decayed, enc_norm not) fails here."""
    jcfg, cfg, jparams, tree, _ = _setup()
    model = trainable(params_from_numpy(cfg, tree, "cpu"))
    state = TrainState(model, adamw_init(dict(model.named_parameters())), 0)
    jstate = jtl.TrainState(params=jparams, opt=jopt.adamw_init(jparams),
                            rng=jax.random.PRNGKey(0))
    step = make_train_step(cfg, AdamWConfig(**OPT), 2)
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt.AdamWConfig(**OPT), 2))
    for i in range(2):
        tb, jb = _batches(cfg, jcfg, b=4, s=16, step=i)
        state, m = step(state, tb)
        jstate, jm = jstep(jstate, jb)
        for key in ("loss", "xent", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key], float(jm[key]), **TOL,
                                       err_msg=f"step {i} {key}")
    _assert_tree_close(params_to_numpy(state.params), jstate.params, TOL)


def test_blockwise_branch():
    """S = 3,072 > BLOCKWISE_THRESHOLD: the decoder's self-attention runs
    flash attention (the plain version here), the JAX package
    jax.checkpoint(blockwise_attention); the encoder's 16 frames and the
    cross-attention stay on the masked softmax.  Loss and gradients."""
    jcfg, cfg, jparams, tree, _ = _setup()
    model = trainable(params_from_numpy(cfg, tree, "cpu"))
    tb, jb = _batches(cfg, jcfg, b=1, s=3072)
    loss, _ = loss_fn(model, cfg, tb)
    loss.backward()
    (jloss, _), jgrads = jax.value_and_grad(jtl.loss_fn, has_aux=True)(
        jparams, jcfg, jb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    _assert_tree_close(params_to_numpy(model, grads=True), jgrads, TOL)


def test_noncausal_flash_branch_in_the_encoder():
    """An encoder of 3,072 frames (above the threshold) runs flash
    attention without the causal mask (the plain version here), the JAX
    package its blockwise attention with ``causal=False``."""
    jcfg, cfg, jparams, tree, model = _setup()
    jlong = dataclasses.replace(jcfg, encoder_seq_len=3072)
    long = dataclasses.replace(cfg, encoder_seq_len=3072)
    frames = _frames(long, 1, seed=9)
    want = JMZ._encode(jparams, jlong, jnp.asarray(frames))
    got = MZ._encode(model, long, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_prefill_matches(kv_mode):
    """``prefill(audio_frames=)`` against the JAX ``prefill``: the last
    logits, the encoder output in the state, the lengths, then 6 greedy
    decode steps (logits and tokens) from both states."""
    jcfg, cfg, jparams, _, model = _setup()
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 13))
    frames = _frames(cfg, 2)
    jl, jst = jprefill(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                       kv_mode=kv_mode, max_len=32, page_size=8,
                       audio_frames=jnp.asarray(frames))
    tl, st = prefill(model, cfg, torch.tensor(prompt, dtype=torch.int32),
                     kv_mode=kv_mode, max_len=32, page_size=8,
                     audio_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(st["enc_out"].numpy(),
                               np.asarray(jst["enc_out"]), **TOL)
    assert st["lengths"].tolist() == [13, 13]
    for i in range(6):
        tok = torch.argmax(tl, dim=-1)
        np.testing.assert_array_equal(tok.numpy(),
                                      np.asarray(jnp.argmax(jl, axis=-1)))
        jl, jst = jdecode_step(jparams, jcfg, jst,
                               jnp.asarray(tok.numpy(), jnp.int32),
                               kv_mode=kv_mode)
        tl, st = decode_step(model, cfg, st, tok.int(), kv_mode=kv_mode)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")


def test_prefill_needs_frames():
    _, cfg, _, _, model = _setup()
    with pytest.raises(AssertionError, match="audio_frames"):
        prefill(model, cfg, torch.ones((1, 3), dtype=torch.int32))


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_decode_matches_train_forward(kv_mode):
    """Prefill then one decode step reproduces the training forward's
    last-position logits (the JAX package's invariant, at its 2e-4)."""
    _, cfg, _, _, model = _setup()
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12))
    frames = torch.from_numpy(_frames(cfg, 2, seed=7))
    ref, _ = forward_train(model, cfg, {"tokens": torch.from_numpy(toks),
                                        "audio_frames": frames})
    tt = torch.tensor(toks, dtype=torch.int32)
    _, st = prefill(model, cfg, tt[:, :-1], kv_mode=kv_mode, max_len=16,
                    page_size=4, audio_frames=frames)
    last, _ = decode_step(model, cfg, st, tt[:, -1], kv_mode=kv_mode)
    np.testing.assert_allclose(last.numpy(), ref[:, -1].detach().numpy(),
                               **DECODE_TOL)


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_zero_enc_out_decode_matches(kv_mode):
    """The decode state's zero ``enc_out`` (model dtype), as the engine
    runs it: 10 decode steps against the JAX ``decode_step``, and the
    state's tables and lengths."""
    jcfg, cfg, jparams, _, model = _setup()
    b = 3
    jst = jinit_state(jcfg, b, 32, kv_mode, 4)
    st = init_decode_state(cfg, b, 32, kv_mode, 4, device="cpu")
    assert st["enc_out"].dtype == cfg.torch_dtype
    assert tuple(st["enc_out"].shape) == (b, cfg.encoder_seq_len,
                                          cfg.d_model)
    assert not st["enc_out"].any()
    forced = np.random.default_rng(8).integers(1, cfg.vocab_size, (10, b))
    for step in range(10):
        jl, jst = jdecode_step(jparams, jcfg, jst,
                               jnp.asarray(forced[step], jnp.int32),
                               kv_mode=kv_mode)
        tl, st = decode_step(model, cfg, st,
                             torch.tensor(forced[step], dtype=torch.int32),
                             kv_mode=kv_mode)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
    np.testing.assert_array_equal(st["lengths"].numpy(),
                                  np.asarray(jst["lengths"]))


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
def _prompts(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, rng.integers(3, 9))
            .astype(np.int32) for _ in range(n)]


def _serve(eng, request_cls, prompts, res=None, injector=None):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(req_id=i, prompt=p, max_new_tokens=6))
    with (res.inject_faults(injector) if injector is not None
          else contextlib.nullcontext()):
        done = eng.run(max_steps=500)
    tc = eng.sched.tcache
    return ({r.req_id: list(r.generated) for r in done},
            dict(eng.sched.stats), tc.hits, tc.misses)


@pytest.mark.parametrize("table_mode", [None, BT.FLAT, BT.RADIX])
def test_engine_matches_jax_engine(table_mode):
    """Five requests on two slots (slots reused): the port's engine
    against the JAX engine at the zero encoder output both decode
    states carry (neither engine has an audio path).  An attention-only
    model keeps no recurrent state, so the JAX engine is exact with
    slots reused: streams, scheduler stats, translation-cache hits and
    misses equal."""
    jcfg, cfg, jparams, _, model = _setup()
    prompts = _prompts(cfg, 5, seed=1)
    shape = dict(ENGINE, max_batch=2, table_mode=table_mode)
    want = _serve(JServeEngine(jcfg, jparams, **shape), JRequest, prompts)
    got = _serve(ServeEngine(cfg, model, **shape, device="cpu"), Request,
                 prompts)
    assert len(got[0]) == 5 and got[1]["admitted"] == 5
    assert got == want


def test_engine_after_preemption_matches_jax_engine():
    """Injected mid-decode evictions (evict_storm): a resumed request
    re-prefills its prompt and tokens so far; the port replays the JAX
    engine's preemptions and streams."""
    jcfg, cfg, jparams, _, model = _setup()
    prompts = _prompts(cfg, 4, seed=5)
    shape = dict(ENGINE, max_batch=2)
    want = _serve(JServeEngine(jcfg, jparams, **shape), JRequest, prompts,
                  jresilience,
                  jresilience.FaultInjector.from_plan("evict_storm"))
    got = _serve(ServeEngine(cfg, model, **shape, device="cpu"), Request,
                 prompts, resilience,
                 resilience.FaultInjector.from_plan("evict_storm"))
    assert got[1]["preempted"] >= 1 and got[1]["resumed"] >= 1
    assert got == want


# ---------------------------------------------------------------------------
# dtype promotion (bf16 weights, float32 frames)
# ---------------------------------------------------------------------------
def test_bf16_weights_float32_frames_promote():
    """bf16 weights with the stub's float32 frames: the encoder, its
    output and the cross K/V are float32 on both sides (the JAX matmul
    promotes; a torch matmul of mixed dtypes would raise), the decoder
    bf16.  Logits against the JAX package at 2e-2; after prefill the
    state's ``enc_out`` is float32, not the bf16 zeros it started as."""
    jcfg, cfg, jparams, _, model = _setup("bfloat16")
    tb, jb = _batches(cfg, jcfg, b=2, s=16)
    logits, _ = forward_train(model, cfg, tb)
    jlogits, _ = jforward_train(jparams, jcfg, jb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **BF16_TOL)
    prompt = torch.from_numpy(np.asarray(tb["tokens"][:, :6]))
    st0 = init_decode_state(cfg, 2, 32, BT.FLAT, 8, device="cpu")
    assert st0["enc_out"].dtype == torch.bfloat16
    tl, st = prefill(model, cfg, prompt.int(), kv_mode=BT.FLAT, max_len=32,
                     page_size=8, audio_frames=tb["audio_frames"])
    jl, jst = jprefill(jparams, jcfg, jnp.asarray(prompt.numpy(), jnp.int32),
                       kv_mode=BT.FLAT, max_len=32, page_size=8,
                       audio_frames=jb["audio_frames"])
    assert st["enc_out"].dtype == torch.float32
    assert jst["enc_out"].dtype == jnp.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------
def test_launchers_local_smoke(tmp_path, capsys):
    """``launch.serve`` and ``launch.train --arch whisper-tiny
    --local-smoke --device cpu``: three requests at the zero encoder
    output, and two steps of 8 x 64 tokens with the audio stubs."""
    out = LS.main(["--local-smoke", "--device", "cpu", "--arch", NAME,
                   "--requests", "3"])
    assert len(out["done"]) == 3
    assert all(len(r.generated) == LS.SMOKE["new_tokens"]
               for r in out["done"])
    assert f"of {NAME}-smoke on cpu" in capsys.readouterr().out
    out = LT.train(LT.build_parser().parse_args(
        ["--local-smoke", "--device", "cpu", "--arch", NAME, "--steps", "2",
         "--ckpt-dir", str(tmp_path)]))
    assert out["cfg"].name == NAME + "-smoke"
    assert len(out["history"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["history"])


# ---------------------------------------------------------------------------
# the trace CLI
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _script():
    spec = importlib.util.spec_from_file_location(
        "convert_trace", ROOT / "scripts" / "convert_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


@pytest.mark.parametrize("opts", [
    [], ["--cores", "1", "--length", "500"],
    ["--cores", "8", "--interleave", "blocked", "--page-bytes", "8192",
     "--work-clip", "16", "--gap-cap", "64"]],
    ids=["default", "one_core", "options"])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_trace_cli_matches_convert_trace(fixture, opts, tmp_path):
    """``python -m repro_torch.workloads.ingest`` against
    ``scripts/convert_trace.py``: every printed line (the
    characterization and the "replay directly" line; the ``wrote`` line
    names each one's own file) and the npz arrays equal."""
    path = str(FIXDIR / fixture)
    base = ["--no-cache"] + opts
    got = _run_cli(CLI.main, [path, "--out", str(tmp_path / "port.npz")]
                   + base)
    want = _run_cli(_script().main,
                    [path, "--out", str(tmp_path / "jax.npz")] + base)
    assert got[-2] == f"wrote {tmp_path / 'port.npz'}"
    assert want[-2] == f"wrote {tmp_path / 'jax.npz'}"
    assert got[:-2] + got[-1:] == want[:-2] + want[-1:]
    assert got[-1].startswith("# replay directly: ")
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == [
            "off", "pages", "vpn", "work"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    assert sorted(os.listdir(tmp_path)) == ["jax.npz", "port.npz"]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_trace_cli_stats_only_and_format(fixture, tmp_path):
    """``--stats-only`` writes nothing and prints the same lines; an
    explicit ``--fmt`` joins the replay spec, as in the script."""
    path = str(FIXDIR / fixture)
    fmt = "champsim" if "champsim" in fixture else "lackey"
    argv = [path, "--no-cache", "--stats-only", "--fmt", fmt, "--cores",
            "2", "--out", str(tmp_path / "never.npz")]
    got = _run_cli(CLI.main, argv)
    assert got == _run_cli(_script().main, argv)
    assert got[-1].startswith(f'# replay directly: sweep({{"workload": '
                              f'("trace:{path}?fmt={fmt}",)}})')
    assert not any(line.startswith("wrote") for line in got)
    assert os.listdir(tmp_path) == []


def test_trace_cli_runs_as_a_module(tmp_path):
    """The package's ``__main__`` under ``python -m``, with the port's
    path only."""
    out = tmp_path / "g.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.workloads.ingest",
         str(FIXDIR / FIXTURES[0]), "--no-cache", "--cores", "2", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "footprint_pages: " in proc.stdout and out.exists()
