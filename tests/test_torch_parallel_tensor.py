"""Tensor-parallel training (``parallel/tensor.py``, a ``model`` axis
above 1) on 4 gloo ranks on the CPU, held against the JAX package's
single-device ``make_train_step`` and the port's own single-rank step.

The ranks are spawned once for the module and run every case on a
``(2, 2)`` and a ``(1, 4)`` ``("data", "model")`` mesh of the one
world.  The ranks of one ``model`` group read the same rows: a rank's
data coordinate r of d reads rows ``r B / d ..`` of the global batch in
n microbatches, the JAX step's microbatches ``r n .. r n + n - 1`` of
``n x d``, so the reference is the JAX step in ``n x d = 2``
microbatches.  The smoke configs' vocab is 256 on both sides (the smoke
vocab of 257 divides no axis, so the vocab-parallel embedding, head and
loss would never run); one case keeps 257 to show ``valid_spec``'s
replicated fallback.  The archs: internlm2 (4 / 2 heads: kv heads split
at model 2; at model 4 kv replicated, 2 kv heads, each rank one, the
layout internlm2 has at model 16), gemma3-1b (tied embedding, window
layers, one kv head replicated), granite-34b (GELU MLP, MQA) and
internvl2 (vision tokens).  Every case clips (grad norms 3-15 against
AdamW's ``clip_norm`` 1): a wrong norm, a missing kv gradient sum or a
wrong vocab-parallel loss moves every parameter.

Tolerances, both sides float32, AdamW at eps 1e-6 on both sides as in
``tests/test_torch_model_variants.py`` (gemma3-1b's tied embedding gives
every vocab row a gradient, some near the default eps of 1e-8): against
JAX, losses 1e-5 and parameters 1e-4 after 2 steps; against one rank,
losses 1e-5, the first step's gradients (handed to AdamW, gathered
whole) 1e-5 of each leaf's largest element and the parameters 1e-4.  A
split matmul adds its partial sums over ``model`` in another order:
the gradients agree to 2.1e-6 of scale, but AdamW turns that rounding,
on an element whose gradient is near 0, into up to 4.9e-5 of its
parameter after 2 steps (internlm2's embedding at (1, 2)), so the
parameters are not held at the data-parallel module's 1e-5 / 1e-6.
"""
import dataclasses
import functools
import os
import pickle
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from filelock import FileLock

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import config as C
from repro_torch.launch import mesh as LM
from repro_torch.models import attention as A
from repro_torch.models import init_params, params_to_numpy
from repro_torch.models.layers import rope_tables
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import tensor as TP
from repro_torch.parallel.context import axis_rank, axis_size
from repro_torch.train import data as D
from repro_torch.train import train_loop as TL
from repro_torch.train.optimizer import AdamWConfig, adamw_init

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_OF_SCALE = 1e-5
#: the global gradient norm the clip reads, relative
NORM_RTOL = 1e-5
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
JOPT = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
#: AdamW's eps of an arch where it is not the default (module docstring)
EPS = {"gemma3-1b": 1e-6, "granite-34b": 1e-6, "internvl2-76b": 1e-6}


def opts(arch):
    eps = EPS.get(arch, OPT.eps)
    return OPT._replace(eps=eps), JOPT._replace(eps=eps)
WORLD = 4
B, S, STEPS, MICRO = 4, 16, 2, 2     # MICRO: the JAX step's, n x d
ARCHS = ("internlm2-1.8b", "gemma3-1b", "granite-34b", "internvl2-76b")
#: key -> (arch, mesh shape, vocab, fsdp)
CASES = {f"{a.split('-')[0]}_{m[0]}x{m[1]}": (a, m, 256, False)
         for a in ARCHS for m in ((2, 2), (1, 4))}
CASES["gemma3_2x2_fsdp"] = ("gemma3-1b", (2, 2), 256, True)
CASES["internlm2_2x2_v257"] = ("internlm2-1.8b", (2, 2), 257, False)


def cfgs(arch, vocab=256, fsdp=False):
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(arch)),
                              dtype="float32", vocab_size=vocab, fsdp=fsdp)
    jcfg = dataclasses.replace(jsmoke(jget_arch(arch)), dtype="float32",
                               vocab_size=vocab)
    return cfg, jcfg


def state(cfg):
    model = TL.trainable(init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu"))
    return TL.TrainState(model, adamw_init(dict(model.named_parameters())),
                         0)


def global_batch(cfg, step):
    raw = D.add_modality_stubs(D.SyntheticLM(cfg.vocab_size, S, B).batch_at(
        step), cfg, seed=step)
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def rows(batch, mesh):
    """The rows of the rank's batch-axes coordinate."""
    d = axis_size(mesh, SH.batch_axes(mesh))
    r = axis_rank(mesh, SH.batch_axes(mesh))
    return {k: v.chunk(d)[r] for k, v in batch.items()}


def recorder(store, fn):
    """``fn`` (``_accumulate`` or ``adamw_update``) recording the
    gradients it returns or takes."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        grads = out[1] if fn.__name__ == "_accumulate" else args[2]
        store.update({n: g.detach().clone() for n, g in grads.items()})
        return out
    return wrapped


def whole_grads(grads, model, mesh):
    """The gradients handed to AdamW (blocks) gathered whole."""
    dp = TL.DataParallel(mesh)
    layout = getattr(model, TL.FSDP_LAYOUT)
    mlayout = getattr(model, TL.MODEL_LAYOUT)
    out = {}
    for n, g in grads.items():
        if n in layout:
            g = comm.all_gather(g, dp.data_group, layout[n])
        if n in mlayout:
            g = comm.all_gather(g, dp.tp.group, mlayout[n])
        out[n] = g.numpy()
    return out


def train_case(mesh, arch, vocab=256, fsdp=False, steps=STEPS):
    """Two tensor-parallel steps of one case on this rank: losses,
    gradient norms, the whole state, the first step's whole gradients,
    this rank's raw gradients (before any sum) and its blocks' shapes."""
    cfg, _ = cfgs(arch, vocab, fsdp)
    st = TL.shard_train_state(state(cfg), mesh, cfg)
    shapes = {n: tuple(p.shape) for n, p in st.params.named_parameters()}
    n = MICRO // axis_size(mesh, SH.batch_axes(mesh))
    step = TL.make_train_step(cfg, opts(arch)[0], n, mesh=mesh)
    raw, handed, losses, norms = {}, {}, [], []
    for i in range(steps):
        with mock.patch.object(TL, "_accumulate",
                               recorder(raw, TL._accumulate)), \
                mock.patch.object(TL, "adamw_update",
                                  recorder(handed, TL.adamw_update)):
            st, m = step(st, rows(global_batch(cfg, i), mesh))
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        if i == 0:
            first = whole_grads(handed, st.params, mesh)
            first_raw = {k: v.numpy() for k, v in raw.items()}
    whole = TL.logical_state(st, mesh)
    return {"losses": losses, "norms": norms, "grads": first,
            "raw": first_raw,
            "shapes": shapes,
            "params": {k: v.numpy() for k, v in whole.params.items()},
            "partial": getattr(st.params, TL.MODEL_PARTIAL)}


def unit_terms(mesh):
    """The boundary Functions and the vocab-parallel loss terms on this
    rank's block of one (3, 5, 32) logits tensor, with their
    gradients."""
    tp = TP.tensor_parallel(mesh)
    gen = torch.Generator().manual_seed(7)
    logits = torch.randn((3, 5, 32), generator=gen) * 4
    targets = torch.randint(0, 32, (3, 5), generator=gen)
    upstream = torch.randn((3, 5), generator=gen)
    lo, n = TP.vocab_block(32, tp)
    mine = logits[..., lo:lo + n].clone().requires_grad_(True)
    logz = TP.vocab_logz(mine, 32, tp)
    gold = TP.vocab_gold(mine, targets, 32, tp)
    ((logz - gold) * upstream).sum().backward()
    # the boundaries: x differs by rank
    x = torch.full((4,), float(tp.rank + 1), requires_grad=True)
    y = TP.reduce_from_model(x * 2, tp)
    (y * torch.arange(4.0)).sum().backward()
    z = torch.ones(4, requires_grad=True)
    (TP.copy_to_model(z, tp) * float(tp.rank + 1)).sum().backward()
    table = torch.randn((32, 6), generator=gen)
    ids = torch.randint(0, 32, (3, 5), generator=gen)
    emb = TP.vocab_embed(table[lo:lo + n], ids, 32, tp)
    return {"logz": logz.detach().numpy(), "gold": gold.detach().numpy(),
            "dlogits": mine.grad.numpy(), "block": (lo, n),
            "reduce": (y.detach().numpy(), x.grad.numpy()),
            "copy": z.grad.numpy(), "embed": emb.numpy(),
            "want_embed": table[ids].numpy()}


def rank_cases(rank, world):
    meshes = {m: LM.make_mesh(m, ("data", "model"), "cpu")
              for m in ((2, 2), (1, 4))}
    out = {key: train_case(meshes[m], arch, vocab, fsdp)
           for key, (arch, m, vocab, fsdp) in CASES.items()}
    out["unit"] = unit_terms(meshes[(1, 4)])
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread in this process while the module runs, as in
    the ranks: under a parallel test run, small ops with a thread for
    every core spin against the other workers (a case of this module
    took 20x longer with them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks():
    return LM.spawn(rank_cases, WORLD)


@pytest.fixture(scope="session")
def jax_runs(tmp_path_factory):
    """:func:`jax_run`, shared by the processes of one parallel test run
    (``pytest -n``): the first to ask for a case computes it under a file
    lock and saves it where the others read it.  This module and the
    (1, 2) cases of ``tests/test_torch_parallel_train.py`` compile the
    same four JAX steps."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent          # the run's, above each worker's own

    @functools.lru_cache(maxsize=None)
    def get(arch, vocab):
        path = root / f"jax_run_{arch}_{vocab}.pkl"
        with FileLock(f"{path}.lock"):
            if not path.exists():
                path.write_bytes(pickle.dumps(jax_run(arch, vocab)))
            return pickle.loads(path.read_bytes())
    return get


def jax_run(arch, vocab):
    """The JAX single-device step in MICRO microbatches from the port's
    initial weights: losses, gradient norms and parameters after STEPS
    steps."""
    cfg, jcfg = cfgs(arch, vocab)
    tree = params_to_numpy(state(cfg).params)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = jtl.TrainState(params=params, opt=jopt.adamw_init(params),
                            rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jtl.make_train_step(jcfg, opts(arch)[1],
                                        num_microbatches=MICRO))
    losses, norms = [], []
    for i in range(STEPS):
        jstate, m = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in
                                   global_batch(cfg, i).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, jstate.params)


@functools.lru_cache(maxsize=None)
def one_rank(arch, vocab, fsdp):
    """The port's single-rank step in MICRO microbatches: losses,
    gradient norms, the first step's gradients, the parameters after
    STEPS steps."""
    cfg, _ = cfgs(arch, vocab, fsdp)
    st = state(cfg)
    step = TL.make_train_step(cfg, opts(arch)[0], MICRO)
    handed, losses, norms = {}, [], []
    for i in range(STEPS):
        with mock.patch.object(TL, "adamw_update",
                               recorder(handed, TL.adamw_update)):
            st, m = step(st, global_batch(cfg, i))
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        if i == 0:
            first = {k: v.numpy() for k, v in handed.items()}
    return losses, norms, first, {n: p.detach().numpy()
                           for n, p in st.params.named_parameters()}


def assert_tree_close(got_tree, want_tree, tol):
    for (path, got), want in zip(
            jax.tree_util.tree_flatten_with_path(got_tree)[0],
            jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(got, np.asarray(want), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def as_tree(arch, vocab, params):
    cfg, _ = cfgs(arch, vocab)
    model = init_params(cfg, None, "cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    return params_to_numpy(model)


def assert_matches_jax(got, jax_result, arch, vocab):
    """One rank's :func:`train_case` against :func:`jax_run`'s."""
    jlosses, jnorms, jparams = jax_result
    np.testing.assert_allclose(got["losses"], jlosses, **LOSS_TOL)
    np.testing.assert_allclose(got["norms"], jnorms, rtol=NORM_RTOL)
    assert_tree_close(as_tree(arch, vocab, got["params"]), jparams, TOL)


def assert_matches_one_rank(got, arch, vocab, fsdp):
    """One rank's :func:`train_case` against :func:`one_rank`'s."""
    losses, norms, grads, params = one_rank(arch, vocab, fsdp)
    np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
    np.testing.assert_allclose(got["norms"], norms, rtol=NORM_RTOL)
    for n, want in grads.items():
        err = np.abs(got["grads"][n] - want).max() / np.abs(want).max()
        assert err <= GRAD_OF_SCALE, (n, err)
    for n, want in params.items():
        np.testing.assert_allclose(got["params"][n], want, **TOL, err_msg=n)


@pytest.mark.parametrize("key", sorted(CASES))
def test_tensor_parallel_matches_the_jax_step(ranks, jax_runs, key):
    arch, _, vocab, _ = CASES[key]
    for r in ranks:
        assert_matches_jax(r[key], jax_runs(arch, vocab), arch, vocab)


@pytest.mark.parametrize("key", sorted(CASES))
def test_tensor_parallel_matches_one_rank(ranks, key):
    arch, _, vocab, fsdp = CASES[key]
    for r in ranks:
        assert_matches_one_rank(r[key], arch, vocab, fsdp)


@pytest.mark.parametrize("key", sorted(CASES))
def test_replicated_gradients_equal_on_every_model_rank(ranks, key):
    """No collective of their own: the norms' gradients (and, where the
    vocab is whole, the embedding's and the head's) are equal on the
    ranks of one model group, each rank's own backward; the partial kv
    gradients are not."""
    _, mesh, vocab, _ = CASES[key]
    groups = [list(range(d * mesh[1], (d + 1) * mesh[1]))
              for d in range(mesh[0])]
    for group in groups:
        raws = [ranks[i][key]["raw"] for i in group]
        for n, g in raws[0].items():
            if "norm" in n or (vocab % mesh[1] and n in ("embed",
                                                         "lm_head")):
                for other in raws[1:]:
                    np.testing.assert_array_equal(other[n], g, err_msg=n)
        for n in ranks[group[0]][key]["partial"]:
            assert not all(np.array_equal(o[n], raws[0][n])
                           for o in raws[1:]), n


def test_blocks_follow_the_head_layout(ranks):
    """Each rank's blocks: gemma3-1b's vocab and query heads split, its
    one kv head whole (partial gradients); internlm2's kv heads split at
    model 2 and whole at 4; the vocab of 257 whole; FSDP blocks of the
    model blocks."""
    s = ranks[0]["gemma3_2x2"]["shapes"]
    cfg, _ = cfgs("gemma3-1b")
    d, hd = cfg.d_model, cfg.head_dim
    assert s["embed"] == (128, d) and "lm_head" not in s
    assert s["stack.layers.0.mixer.wq"] == (d, 2 * hd)
    assert s["stack.layers.0.mixer.wk"] == (d, hd)
    assert s["stack.layers.0.mixer.wo"] == (2 * hd, d)
    assert s["stack.layers.0.ffn.w_down"] == (cfg.d_ff // 2, d)
    assert ranks[0]["gemma3_2x2"]["partial"][:2] == (
        "stack.layers.0.mixer.wk", "stack.layers.0.mixer.wv")
    f = ranks[0]["gemma3_2x2_fsdp"]["shapes"]
    assert f["embed"] == (128, d // 2)
    assert f["stack.layers.0.mixer.wq"] == (d // 2, 2 * hd)
    assert f["stack.layers.0.mixer.wk"] == (d // 2, hd)
    assert ranks[0]["internlm2_2x2"]["shapes"][
        "stack.layers.0.mixer.wk"] == (d, hd)
    assert ranks[0]["internlm2_2x2"]["partial"] == ()
    assert ranks[0]["internlm2_1x4"]["shapes"][
        "stack.layers.0.mixer.wk"] == (d, 2 * hd)
    v = ranks[0]["internlm2_2x2_v257"]["shapes"]
    assert v["embed"] == (257, d) and v["lm_head"] == (d, 257)
    assert v["stack.layers.0.mixer.wq"] == (d, 2 * hd)


def test_vocab_terms_and_boundaries(ranks):
    """On (1, 4): the log-sum-exp and gold logit of vocab-split logits
    equal the whole vocab's ``torch.logsumexp`` and gather, and their
    gradients are the blocks of the whole one's; the lookup equals
    ``table[ids]``; reduce_from_model sums (identity backward),
    copy_to_model sums the gradient."""
    gen = torch.Generator().manual_seed(7)
    logits = (torch.randn((3, 5, 32), generator=gen) * 4).requires_grad_()
    targets = torch.randint(0, 32, (3, 5), generator=gen)
    upstream = torch.randn((3, 5), generator=gen)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    ((logz - gold) * upstream).sum().backward()
    for r in ranks:
        u = r["unit"]
        lo, n = u["block"]
        np.testing.assert_allclose(u["logz"], logz.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(u["gold"], gold.detach().numpy())
        np.testing.assert_allclose(u["dlogits"],
                                   logits.grad[..., lo:lo + n].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(u["embed"], u["want_embed"])
        y, dx = u["reduce"]
        np.testing.assert_array_equal(y, np.full(4, 2.0 * (1 + 2 + 3 + 4)))
        np.testing.assert_array_equal(dx, 2 * np.arange(4.0))
        np.testing.assert_array_equal(u["copy"], np.full(4, 10.0))
    assert [r["unit"]["block"] for r in ranks] == [(0, 8), (8, 8), (16, 8),
                                                   (24, 8)]


@pytest.mark.parametrize("h,kh,m", [(4, 2, 2), (4, 1, 2), (4, 2, 4),
                                    (6, 3, 2)])
def test_attention_shards_sum_to_the_whole_layer(h, kh, m):
    """One process: each rank's ``attn_shard`` (its query heads, the kv
    heads they read, its rows of ``wo``) at 2,112 tokens, the flash
    branch (the plain ``flash_attention_ref`` on the CPU), summed by
    hand equals the whole layer, and so do the gradients of x (summed),
    of each block and of whole ``wk`` / ``wv`` (summed).  (6, 3, 2): 3
    query heads a rank over groups of 2, widened to one kv head a query
    head."""
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                              dtype="float32", num_heads=h, num_kv_heads=kh)
    hd, s = cfg.head_dim, A.BLOCKWISE_THRESHOLD + 64
    gen = torch.Generator().manual_seed(3)
    attn = A.Attention(cfg, torch.float32, torch.device("cpu"), gen)
    x = torch.randn((1, s, cfg.d_model), generator=gen) * 0.5
    cos, sin = rope_tables(torch.arange(s)[None], hd, cfg.rope_theta)
    xw = x.clone().requires_grad_()
    for p in attn.parameters():
        p.requires_grad_(True)
    want = A.attn_apply(attn, xw, cos, sin, cfg)
    up = torch.randn(want.shape, generator=gen)
    (want * up).sum().backward()
    total, dx = torch.zeros_like(want), torch.zeros_like(x)
    dkv = torch.zeros((2,) + attn.wk.shape)
    for r in range(m):
        tp = TP.TensorParallel(None, m, r)
        lay = TP.head_layout(h, kh, tp)
        assert lay.kv_split == (kh % m == 0)
        q_cols = slice(r * lay.heads * hd, (r + 1) * lay.heads * hd)
        kv_cols = (slice(lay.kv0 * hd, (lay.kv0 + lay.kv_heads) * hd)
                   if lay.kv_split else slice(None))
        shard = types.SimpleNamespace(**{
            n: w.detach()[cols].clone().requires_grad_()
            for n, w, cols in (("wq", attn.wq, (slice(None), q_cols)),
                               ("wk", attn.wk, (slice(None), kv_cols)),
                               ("wv", attn.wv, (slice(None), kv_cols)),
                               ("wo", attn.wo, q_cols))})
        xr = x.clone().requires_grad_()
        part = A.attn_shard(shard, xr, cos, sin, cfg, tp=tp)
        (part * up).sum().backward()
        total += part.detach()
        dx += xr.grad
        np.testing.assert_allclose(shard.wq.grad, attn.wq.grad[:, q_cols],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(shard.wo.grad, attn.wo.grad[q_cols],
                                   rtol=1e-5, atol=1e-6)
        dkv[:, :, kv_cols] += torch.stack([shard.wk.grad, shard.wv.grad])
    np.testing.assert_allclose(total, want.detach(), rtol=1e-5, atol=1e-6)
    # split kv: each rank's block; whole kv: partials that sum to it
    want_kv = torch.stack([attn.wk.grad, attn.wv.grad])
    assert (dkv - want_kv).abs().max() <= GRAD_OF_SCALE * want_kv.abs().max()
    np.testing.assert_allclose(dx, xw.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h,kh,m,want", [
    (4, 2, 2, (2, 1, 1, True, None)),
    (4, 1, 2, (2, 1, 0, False, None)),
    (4, 2, 4, (1, 1, 1, False, None)),
    (16, 8, 2, (8, 4, 4, True, None)),
    (40, 10, 4, (10, 3, 7, False, (0, 0, 1, 1, 1, 1, 2, 2, 2, 2))),
])
def test_head_layout(h, kh, m, want):
    """The last rank's heads: internlm2's smoke heads at model 2 and 4,
    gemma3-1b's, internlm2-1.8b's 16 / 8 and phi3-medium's 40 / 10 at
    model 4 (groups of 4 cut by the rank's 10 heads)."""
    assert tuple(TP.head_layout(h, kh, TP.TensorParallel(None, m, m - 1))
                 ) == want


def fake_mesh(m):
    """What ``sharding.mesh_axes`` reads of a ``(1, m)`` mesh."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": m})


def test_an_uneven_ffn_raises():
    """An FFN width the model axis does not divide is refused, not run
    whole on every rank."""
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                              d_ff=130)
    with pytest.raises(NotImplementedError, match="uneven FFN"):
        TL.make_train_step(cfg, OPT, mesh=fake_mesh(4))
    with pytest.raises(NotImplementedError, match="uneven FFN"):
        TL.shard_train_state(None, fake_mesh(4), cfg)


@pytest.mark.parametrize("arch,vocab,m", [
    ("internlm2-1.8b", 256, 2), ("internlm2-1.8b", 256, 4),
    ("gemma3-1b", 256, 2), ("granite-34b", 257, 2)])
def test_storage_and_compute_split_by_one_rule(arch, vocab, m):
    """``train_spec`` splits the vocab and the kv weights over ``model``
    exactly where the compute path reads blocks of them
    (``vocab_block``, ``head_layout``); a whole table on a vocab-split
    rank is refused, not read at the wrong rows."""
    cfg, _ = cfgs(arch, vocab)
    model = init_params(cfg, None, "cpu")
    specs = SH.train_sharding(model, fake_mesh(m), cfg)
    tp = TP.TensorParallel(None, m, 0)
    split = {n for n, spec in specs.items() if "model" in spec}
    assert ("embed" in split) == (TP.vocab_block(vocab, tp) is not None)
    if model.lm_head is not None:
        assert ("lm_head" in split) == ("embed" in split)
    kv = TP.head_layout(cfg.num_heads, cfg.num_kv_heads, tp).kv_split
    for n in specs:
        if n.endswith((".wq", ".wo", ".w_up", ".w_gate", ".w_down")):
            assert n in split, n
        if n.endswith((".wk", ".wv")):
            assert (n in split) == kv, n
    if "embed" in split:
        with pytest.raises(ValueError, match="vocab rows or columns"):
            TP.vocab_embed(torch.zeros((vocab, 4)), torch.zeros(
                (1, 2), dtype=torch.long), vocab, tp)
