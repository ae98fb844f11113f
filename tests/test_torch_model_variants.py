"""The dense attention variants on the port against the JAX package, on
the same weights (``params_from_numpy`` of the JAX ``init_params``
tree): gemma3-1b (sliding-window layers in a 5:1 interleave after two
prefix layers, tied embeddings, head_dim 256 at full width),
phi3-medium-14b (GQA 40/10), granite-34b (MQA, the GELU FFN) and
internvl2-76b (stub vision tokens prepended); and the mixture-of-experts
configs, granite-moe-1b-a400m (every FFN routed, tied embeddings) and
deepseek-v2-236b (MLA in every layer with its latent decode cache, a
dense prefix layer, then routed experts with a shared one); and the
hybrid jamba-1.5-large-398b (Mamba layers with their recurrent decode
state, one attention layer in eight, routed experts on every other
layer; ``tests/test_torch_mamba.py`` holds its Mamba block and engine).

Smoke width (``smoke_variant``: window 8, 4 vision tokens), float32,
live calls of ``repro`` on both sides.  Logits, losses and gradients are
held to rtol = atol = 1e-4 (both sides sum in float32 in other orders,
through several layers and the vocabulary projection); generated tokens,
lengths and page tables exactly.  Decode runs past the smoke window, so
the local layers attend to fewer tokens than the global ones.  The MoE
aux loss is held with the logits.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import decode_step as jdecode_step
from repro.models import forward_train as jforward_train
from repro.models import init_decode_state as jinit_state
from repro.models import init_params as jinit_params
from repro.models import layers as JL
from repro.models import prefill as jprefill
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.launch import serve as LS
from repro_torch.launch import train as LT
from repro_torch.models import (decode_step, forward_train,
                                init_decode_state, params_from_numpy,
                                params_to_numpy, prefill)
from repro_torch.models import layers as L
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import data as D
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import (TrainState, decayed_names,
                                          loss_fn, make_train_step,
                                          trainable)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gemma3-1b", "phi3-medium-14b", "granite-34b", "internvl2-76b",
         "granite-moe-1b-a400m", "deepseek-v2-236b", "jamba-1.5-large-398b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
KV_MODES = ["dense", BT.FLAT, BT.RADIX]
#: AdamW's eps is 1e-6 here, not 1e-8: with tied embeddings every
#: vocabulary row takes a gradient through the logits, some as small as
#: 1.4e-8, about the default eps, where m / (sqrt(v) + eps) turns the two
#: packages' float32 summation-order difference (3e-3 of such a gradient)
#: into an update difference above 1e-4.  Both sides use the same eps
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-6)
JOPT = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-6)
#: ... and 1e-4 for jamba: through its eight Mamba / attention layers one
#: embedding element's second-step gradient crosses zero (2.4e-7 here,
#: 9.9e-8 in the JAX package: 8.5e-7 of the gradient's largest element,
#: float32 summation noise), and at eps 1e-6 Adam's normalisation turns
#: that into a weight difference of 6.1e-4.  At 1e-4 the same noise moves
#: the weight by under 1e-5, and a wrong gradient of any element still
#: moves it past 1e-4
EPS = {"jamba-1.5-large-398b": 1e-4}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX cfg, port cfg, JAX params, numpy tree, port model) at smoke
    width in float32, built once per architecture."""
    jcfg = dataclasses.replace(jsmoke(jget_arch(name)), dtype="float32")
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(name)),
                              dtype="float32")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree, params_from_numpy(cfg, tree, "cpu")


def _batches(cfg, jcfg, b=2, s=24, step=0):
    """The same synthetic batch (with the vision stubs of a vlm config)
    for both packages."""
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


def _assert_tree_close(got, want, tol):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree.leaves(want)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for (path, g), w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match(name):
    jcfg, cfg = _setup(name)[:2]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    full, jfull = C.get_arch(name), jget_arch(name)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()
    assert full.layer_kinds() == jfull.layer_kinds()


@pytest.mark.parametrize("name", ARCHS)
def test_params_roundtrip(name):
    """params_to_numpy(params_from_numpy(tree)) is the tree, leaf for
    leaf: prefix blocks, tied embeddings (no lm_head) and the non-gated
    FFN (no w_gate) included."""
    tree = _setup(name)[3]
    got = params_to_numpy(params_from_numpy(_setup(name)[1], tree, "cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_layouts():
    """What each variant adds, as the port builds it."""
    _, gcfg, _, gtree, gemma = _setup("gemma3-1b")
    assert gemma.lm_head is None and "lm_head" not in gtree
    assert len(gtree["stack"]["prefix"]) == len(gcfg.prefix_pattern) == 2
    windows = [b.window for b in gemma.stack.layers]
    assert windows == [8, 8, 8, 8, 8, 8, 8, 0]
    assert len(windows) == gcfg.num_layers
    full = C.get_arch("gemma3-1b")
    assert [k[0] for k in full.layer_kinds()].count(C.ATTN_LOCAL) == 22
    granite = _setup("granite-34b")[4]
    assert all(not b.ffn.gated and not hasattr(b.ffn, "w_gate")
               for b in granite.stack.layers)
    assert _setup("internvl2-76b")[1].vision_tokens == 4


def test_gelu_ffn_matches():
    """The non-gated FFN: GELU in its tanh form, in float32."""
    _, _, jparams, _, model = _setup("granite-34b")
    h = np.random.default_rng(0).standard_normal((2, 3, 64), np.float32)
    jffn = jax.tree.map(lambda a: a[0],
                        jparams["stack"]["scan"]["block_0"]["ffn"])
    np.testing.assert_allclose(
        L.ffn_apply(model.stack.layers[0].ffn, torch.tensor(h)).numpy(),
        np.asarray(JL.ffn_apply(jffn, jnp.asarray(h), False)), **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_train_matches(name):
    jcfg, cfg, jparams, _, model = _setup(name)
    tb, jb = _batches(cfg, jcfg)
    logits, aux = forward_train(model, cfg, tb)
    jlogits, jaux = jforward_train(jparams, jcfg, jb)
    assert tuple(logits.shape) == (2, cfg.vision_tokens + 24,
                                   cfg.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == (cfg.moe is not None)


def _tables(table, mode):
    """The numpy arrays of a decode state's table."""
    if mode == BT.RADIX:
        return [np.asarray(table.directory), np.asarray(table.leaves)]
    return [np.asarray(table)]


@pytest.mark.parametrize("kv_mode", KV_MODES)
@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match(name, kv_mode):
    """10 teacher-forced steps then 6 greedy ones, past the window of 8:
    logits every step, the greedy tokens, lengths, tables and the KV of
    a local and a global layer (an MLA layer's latent cache, in every
    mode; a Mamba layer's recurrent state, and the first layer with a
    KV cache)."""
    jcfg, cfg, jparams, _, model = _setup(name)
    b, max_len, page = 3, 32, 4
    jst = jinit_state(jcfg, b, max_len, kv_mode, page)
    st = init_decode_state(cfg, b, max_len, kv_mode, page, device="cpu")
    forced = np.random.default_rng(1).integers(1, cfg.vocab_size, (10, b))
    tok = jtok = forced[0]
    for step in range(16):
        jl, jst = jdecode_step(jparams, jcfg, jst,
                               jnp.asarray(jtok, jnp.int32), kv_mode=kv_mode)
        tl, st = decode_step(model, cfg, st,
                             torch.tensor(tok, dtype=torch.int32),
                             kv_mode=kv_mode)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        if step + 1 < len(forced):
            tok = jtok = forced[step + 1]
        else:
            tok = torch.argmax(tl, dim=-1).numpy()
            jtok = np.asarray(jnp.argmax(jl, axis=-1))
            np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(st["lengths"].numpy(),
                                  np.asarray(jst["lengths"]))
    if kv_mode != "dense":
        for got, want in zip(_tables(st["table"], kv_mode),
                             _tables(jst["table"], kv_mode)):
            np.testing.assert_array_equal(got, want)
    kinds = cfg.layer_kinds()
    n_prefix, period = len(cfg.prefix_pattern), len(cfg.layer_pattern)
    first_kv = next(i for i, (mk, _) in enumerate(kinds) if mk != C.MAMBA)
    for layer in sorted({0, first_kv, cfg.num_layers - 1}):
        names = (("ckv", "kr") if kinds[layer][0] == C.ATTN_MLA
                 else ("conv", "ssm") if kinds[layer][0] == C.MAMBA
                 else ("k", "v") if kv_mode == "dense" else ("kp", "vp"))
        if layer < n_prefix:
            jl_st = jst["stack"]["prefix"][layer]
            at = ()
        else:
            p, j = divmod(layer - n_prefix, period)
            jl_st = jst["stack"]["scan"][f"block_{j}"]
            at = (p,)
        for n in names:
            np.testing.assert_allclose(st["stack"][layer][n].numpy(),
                                       np.asarray(jl_st[n])[at], **TOL,
                                       err_msg=f"layer {layer} {n}")


@pytest.mark.parametrize("kv_mode", [BT.FLAT, "dense"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches(name, kv_mode):
    jcfg, cfg, jparams, _, model = _setup(name)
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 13))
    jl, _ = jprefill(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                     kv_mode=kv_mode, max_len=32, page_size=8)
    tl, st = prefill(model, cfg, torch.tensor(prompt, dtype=torch.int32),
                     kv_mode=kv_mode, max_len=32, page_size=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert st["lengths"].tolist() == [13, 13]


def test_window_changes_the_answer():
    """Past the window the local layers must see fewer tokens: the same
    model with the window removed gives other logits (so the checks above
    could tell a dropped window)."""
    jcfg, cfg, jparams, tree, model = _setup("gemma3-1b")
    wide = params_from_numpy(dataclasses.replace(cfg, window_size=0), tree,
                             "cpu")
    prompt = torch.tensor(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (1, 12)), dtype=torch.int32)
    a, _ = prefill(model, cfg, prompt, kv_mode=BT.FLAT, max_len=16,
                   page_size=4)
    b, _ = prefill(wide, dataclasses.replace(cfg, window_size=0), prompt,
                   kv_mode=BT.FLAT, max_len=16, page_size=4)
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ["gemma3-1b", "internvl2-76b"]
                         + MOE_ARCHS + ["jamba-1.5-large-398b"])
def test_loss_and_gradients_match(name):
    """One loss and its gradient: the tied embedding gets both of its
    uses' parts, the vision positions carry no labels, the MoE aux loss
    reaches the router."""
    jcfg, cfg, jparams, tree, _ = _setup(name)
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


@pytest.mark.parametrize("name", ["gemma3-1b", "internvl2-76b"]
                         + MOE_ARCHS + ["jamba-1.5-large-398b"])
def test_train_step_matches(name):
    """Two steps with 2 microbatches (stub embeddings split with the
    tokens): metrics, then the weights.  Weight decay 0.1 at lr 1e-2 moves
    a decayed unit norm scale by 1e-3, so a decay set other than the JAX
    package's (``ndim >= 2`` of its tree: the scanned layers' norm scales
    but not the prefix layers') fails here."""
    jcfg, cfg, jparams, tree, _ = _setup(name)
    model = trainable(params_from_numpy(cfg, tree, "cpu"))
    state = TrainState(model, adamw_init(dict(model.named_parameters())), 0)
    jstate = jtl.TrainState(params=jparams, opt=jopt.adamw_init(jparams),
                            rng=jax.random.PRNGKey(0))
    eps = EPS.get(name, OPT.eps)
    step = make_train_step(cfg, OPT._replace(eps=eps), 2)
    jstep = jax.jit(jtl.make_train_step(jcfg, JOPT._replace(eps=eps), 2))
    for i in range(2):
        tb, jb = _batches(cfg, jcfg, b=4, s=16, step=i)
        state, m = step(state, tb)
        jstate, jm = jstep(jstate, jb)
        for key in ("loss", "xent", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key], float(jm[key]), **TOL,
                                       err_msg=f"step {i} {key}")
    _assert_tree_close(params_to_numpy(state.params), jstate.params, TOL)


def test_decayed_names_follow_the_jax_tree():
    """Prefix norm scales (1-D leaves there) and the final norm are not
    decayed; the scanned layers' scales ((periods, d) there) are."""
    _, cfg, _, _, model = _setup("gemma3-1b")
    names = decayed_names(model)
    assert "stack.layers.0.norm1.scale" not in names
    assert "stack.layers.1.norm2.scale" not in names
    assert "stack.layers.2.norm1.scale" in names
    assert "final_norm.scale" not in names
    assert "embed" in names and "stack.layers.0.mixer.wq" in names


def test_blockwise_branch_with_window():
    """S = 3072 > BLOCKWISE_THRESHOLD: gemma3's local layers run flash
    attention with the window (the plain version here), the JAX package
    jax.checkpoint(blockwise_attention); loss and gradients."""
    jcfg, cfg, jparams, tree, _ = _setup("gemma3-1b")
    model = trainable(params_from_numpy(cfg, tree, "cpu"))
    tb, jb = _batches(cfg, jcfg, b=1, s=3072)
    loss, _ = loss_fn(model, cfg, tb)
    loss.backward()
    (jloss, _), jgrads = jax.value_and_grad(jtl.loss_fn, has_aux=True)(
        jparams, jcfg, jb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    _assert_tree_close(params_to_numpy(model, grads=True), jgrads, TOL)


def test_blockwise_branch_through_mla_and_moe():
    """S = 3072 > BLOCKWISE_THRESHOLD on deepseek-v2: both MLA layers run
    flash attention at head_dim 24 (nope 16 + rope 8; the plain version
    here), the JAX package jax.checkpoint(blockwise_attention), and the
    MoE routes 6 groups of 512 at capacity-factor routing; loss, aux and
    gradients."""
    jcfg, cfg, jparams, tree, _ = _setup("deepseek-v2-236b")
    model = trainable(params_from_numpy(cfg, tree, "cpu"))
    tb, jb = _batches(cfg, jcfg, b=1, s=3072)
    loss, parts = loss_fn(model, cfg, tb)
    loss.backward()
    (jloss, jparts), jgrads = jax.value_and_grad(jtl.loss_fn, has_aux=True)(
        jparams, jcfg, jb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               **TOL)
    _assert_tree_close(params_to_numpy(model, grads=True), jgrads, TOL)


@pytest.mark.parametrize("table_mode", [None, BT.FLAT, BT.RADIX])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_engine_matches_jax_engine(name, table_mode):
    """ServeEngine on the MoE configs against the JAX package's engine:
    the same token streams, scheduler stats and translation-cache hits
    and misses (deepseek-v2's MLA layers have no KV pool; the block
    table is built and translated all the same)."""
    jcfg, cfg, jparams, _, model = _setup(name)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(3, 8))
               .astype(np.int32) for _ in range(4)]
    shape = dict(max_batch=3, max_len=48, page_size=8, table_mode=table_mode)
    out = []
    for eng, req in ((JServeEngine(jcfg, jparams, **shape), JRequest),
                     (ServeEngine(cfg, model, **shape, device="cpu"),
                      Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(req_id=i, prompt=p, max_new_tokens=5))
        done = eng.run(max_steps=500)
        tc = eng.sched.tcache
        out.append(({r.req_id: list(r.generated) for r in done},
                    dict(eng.sched.stats), tc.hits, tc.misses))
    assert len(out[1][0]) == 4
    assert out[1] == out[0]


def test_moe_and_mla_layouts():
    """What the MoE slice adds, as the port builds it: deepseek-v2's
    dense MLA prefix layer then MLA + MoE layers with a shared expert,
    the latent cache in every KV mode (no pool), granite-moe's routed
    FFN in every layer; the 3-D expert weights and the float32 router
    decayed, as ``ndim >= 2`` of the JAX tree has them."""
    _, dcfg, _, dtree, deepseek = _setup("deepseek-v2-236b")
    assert [(b.mla, b.moe) for b in deepseek.stack.layers] == [
        (True, False), (True, True), (True, True)]
    assert len(dtree["stack"]["prefix"]) == 1
    assert set(dtree["stack"]["scan"]["block_0"]["ffn"]) == {
        "router", "w_up", "w_gate", "w_down", "shared"}
    for mode in KV_MODES:
        st = init_decode_state(dcfg, 2, 16, mode, 4, device="cpu")
        assert all(set(layer) == {"ckv", "kr"} for layer in st["stack"])
        assert ("table" in st) == (mode != "dense")
    full = C.get_arch("deepseek-v2-236b")
    assert full.num_layers == 60 and full.layer_kinds()[0] == (
        C.ATTN_MLA, C.DENSE_FF)
    _, gcfg, _, _, granite = _setup("granite-moe-1b-a400m")
    assert all(b.moe and not b.mla for b in granite.stack.layers)
    assert granite.lm_head is None
    names = decayed_names(granite)
    assert {"stack.layers.0.ffn.router", "stack.layers.0.ffn.w_up",
            "stack.layers.1.ffn.w_down"} <= names
    layer0 = dict(granite.stack.layers[0].ffn.named_parameters())
    assert layer0["router"].dtype == torch.float32
    assert layer0["w_up"].shape == (4, 64, 32)
    dnames = decayed_names(deepseek)
    assert "stack.layers.0.mixer.q_norm.scale" not in dnames
    assert "stack.layers.1.mixer.kv_norm.scale" in dnames


def test_modality_stubs_match_and_refuse_audio():
    """The stubs are the JAX package's bit for bit: internvl2's vision
    embeddings, and (the audio frames now ported) an encoder-decoder
    variant's audio frames drawn after them from the same generator; a
    config with neither gets the batch back as it is."""
    cfg = C.smoke_variant(C.get_arch("internvl2-76b"))
    jcfg = jsmoke(jget_arch("internvl2-76b"))
    raw = D.SyntheticLM(cfg.vocab_size, 8, 2).batch_at(0)
    got = D.add_modality_stubs(raw, cfg, seed=3)
    want = jdata.add_modality_stubs(raw, jcfg, seed=3)
    assert got.keys() == want.keys() == {"tokens", "labels", "vision_embeds"}
    np.testing.assert_array_equal(got["vision_embeds"],
                                  want["vision_embeds"])
    assert D.add_modality_stubs(raw, C.get_arch("gemma3-1b")) is raw
    got = D.add_modality_stubs(raw, dataclasses.replace(
        cfg, encoder_layers=2, encoder_seq_len=5), seed=3)
    want = jdata.add_modality_stubs(raw, dataclasses.replace(
        jcfg, encoder_layers=2, encoder_seq_len=5), seed=3)
    assert got.keys() == want.keys() == {"tokens", "labels",
                                         "vision_embeds", "audio_frames"}
    for k in ("vision_embeds", "audio_frames"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["audio_frames"].shape == (2, 5, cfg.d_model)


def test_encoder_decoder_still_refused():
    """What the port refused before the encoder-decoder slice now runs
    as the JAX package runs it: a decoder-only gemma3 smoke model with
    ``rope_theta`` 0 (sinusoidal positions added at embed time, in
    training and in decode, and no rope in any layer, windowed or
    global): ``forward_train`` logits, then 12 decode steps past the
    window of 8 (logits, greedy tokens) in every KV mode."""
    jcfg0, cfg0, _, _, _ = _setup("gemma3-1b")
    jcfg = dataclasses.replace(jcfg0, rope_theta=0.0)
    cfg = dataclasses.replace(cfg0, rope_theta=0.0)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(5))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    assert all(b.rope_width == 0 for b in model.stack.layers)
    assert [b.window for b in model.stack.layers].count(8) == 7
    tb, jb = _batches(cfg, jcfg, b=2, s=12)
    logits, _ = forward_train(model, cfg, tb)
    jlogits, _ = jforward_train(jparams, jcfg, jb)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    for kv_mode in KV_MODES:
        jst = jinit_state(jcfg, 2, 32, kv_mode, 4)
        st = init_decode_state(cfg, 2, 32, kv_mode, 4, device="cpu")
        tok = jtok = np.asarray(tb["tokens"][:, 0])
        for step in range(12):
            jl, jst = jdecode_step(jparams, jcfg, jst,
                                   jnp.asarray(jtok, jnp.int32),
                                   kv_mode=kv_mode)
            tl, st = decode_step(model, cfg, st,
                                 torch.tensor(tok, dtype=torch.int32),
                                 kv_mode=kv_mode)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                       err_msg=f"{kv_mode} step {step}")
            tok = torch.argmax(tl, dim=-1).numpy()
            jtok = np.asarray(jnp.argmax(jl, axis=-1))
            np.testing.assert_array_equal(tok, jtok)


def test_serve_shape_crosses_the_window():
    """gemma3's prompts cross its window, and its table width is a whole
    number of radix leaves (else the radix mode cannot be built)."""
    gemma = C.get_arch("gemma3-1b")
    shape = LS.full_shape(gemma)
    lo, hi = shape["prompt"]
    assert gemma.window_size < lo and hi + shape["new_tokens"] <= \
        shape["max_len"] == 768
    max_pages = shape["max_len"] // shape["page_size"]
    assert max_pages % BT.leaf_size_for(max_pages) == 0
    assert LS.full_shape(C.get_arch("internlm2-1.8b")) is LS.FULL


@pytest.mark.parametrize("name", ["gemma3-1b", "granite-34b"] + MOE_ARCHS
                         + ["jamba-1.5-large-398b"])
def test_serve_launcher_local_smoke(name, capsys):
    out = LS.main(["--local-smoke", "--device", "cpu", "--arch", name,
                   "--requests", "3"])
    assert len(out["done"]) == 3
    assert all(len(r.generated) == LS.SMOKE["new_tokens"]
               for r in out["done"])
    assert f"of {name}-smoke on cpu" in capsys.readouterr().out


def test_train_launcher_attaches_vision_stubs(tmp_path):
    out = LT.train(LT.build_parser().parse_args(
        ["--local-smoke", "--device", "cpu", "--arch", "internvl2-76b",
         "--steps", "2", "--ckpt-dir", str(tmp_path)]))
    assert len(out["history"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["history"])
