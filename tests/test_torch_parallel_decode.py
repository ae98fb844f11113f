"""The paged decode's mesh branch (``models/attention.py``
``_paged_attend_mesh``) on gloo ranks on the CPU, at (1, 2) and (2, 2)
``("data", "model")`` meshes, in its three layouts: kv heads split
(smoke internlm2, 4 / 2 heads), query heads split over pools replicated
(4 / 1 heads, ``qhead_strategy``) and head_dim split (3 / 1 heads: the
heads do not divide ``model``, so the float32 score partials are
all-reduced).  Each rank holds its ``state_sharding`` shard of the pools
(``init_decode_state`` under the mesh) and decodes its data shard's
sequences with shard-local page ids.

Held against: the port's one-rank decode (logits 1e-4, the port's model
tolerance; greedy tokens equal), the JAX ``decode_step`` without a mesh
on the same weights (the same), and the JAX ``_paged_attend_shardmap``
branch run in a subprocess on 4 host devices with shard-local tables
(query-head and head_dim layouts).  The JAX branch's kv-head layout
sums the scores of different heads over ``model`` (it all-reduces the
score partials whenever head_dim divides the axis), so its output is
wrong there and the port is not held to it (ROADMAP section 3).  The
serving engine over the mesh (``ServeEngine(mesh=)``, each data shard
its requests by ``shard_requests``) gives ``greedy_reference``'s
streams.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro.models import decode_step as jdecode_step
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.launch import mesh as LM
from repro_torch.models import (decode_step, init_decode_state,
                                params_from_numpy)
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.context import use_mesh
from repro_torch.serving import (Request, ServeEngine, greedy_reference,
                                 shard_requests)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
#: layout -> (query heads, kv heads)
MODES = {"kv": (4, 2), "qhead": (4, 1), "hd": (3, 1)}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
B, PROMPT, NEW, MAX_LEN, PAGE = 4, 10, 4, 32, 8


def _cfgs(mode):
    h, kh = MODES[mode]
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                              dtype="float32", num_heads=h, num_kv_heads=kh)
    jcfg = dataclasses.replace(JC.smoke_variant(JC.get_arch(
        "internlm2-1.8b")), dtype="float32", num_heads=h, num_kv_heads=kh)
    return cfg, jcfg


def _tree(mode):
    _, jcfg = _cfgs(mode)
    return jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(1)))


def _prompts():
    return np.random.default_rng(3).integers(
        0, 257, (B, PROMPT)).astype(np.int32)


def _decode(cfg, model, prompts, mesh=None):
    """Teacher-forced prompts, then NEW greedy steps: (logits of every
    step (b, steps, V), the greedy tokens (b, NEW))."""
    toks = torch.from_numpy(prompts)
    with use_mesh(mesh):
        st = init_decode_state(cfg, toks.shape[0], MAX_LEN, BT.FLAT, PAGE,
                               device="cpu")
        logits, greedy = [], []
        nxt = toks[:, 0]
        for i in range(PROMPT + NEW - 1):
            lg, st = decode_step(model, cfg, st, nxt, BT.FLAT)
            logits.append(lg.numpy())
            pick = torch.argmax(lg, -1).to(torch.int32)
            if i + 1 >= PROMPT:
                greedy.append(pick.numpy())
            nxt = toks[:, i + 1] if i + 1 < PROMPT else pick
    pools = tuple(st["stack"][0]["kp"].shape)
    return np.stack(logits, 1), np.stack(greedy, 1), pools


def _requests():
    return [Request.build(i, _prompts()[i][:6 + i], max_new_tokens=NEW)
            for i in range(B)]


def _rank_decode(rank, world, shape, trees):
    mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
    d = mesh.get_local_rank("data")
    rows = slice(d * B // shape[0], (d + 1) * B // shape[0])
    out = {}
    for mode in MODES:
        cfg, _ = _cfgs(mode)
        model = params_from_numpy(cfg, trees[mode], device="cpu")
        out[mode] = _decode(cfg, model, _prompts()[rows], mesh)
        eng = ServeEngine(cfg, model, max_batch=2, max_len=MAX_LEN,
                          page_size=PAGE, device="cpu", mesh=mesh)
        for r in shard_requests(_requests(), mesh):
            eng.submit(r)
        out[mode + "_engine"] = {r.req_id: list(r.generated)
                                 for r in eng.run()}
    return out


@pytest.fixture(scope="module")
def trees():
    return {m: _tree(m) for m in MODES}


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request, trees):
    shape = MESHES[request.param]
    return shape, LM.spawn(_rank_decode, shape[0] * shape[1], shape, trees)


def _gather(shape, results, mode):
    """The whole batch's logits and tokens, from the model-rank-0 of each
    data shard; every model rank of a shard holds the same."""
    per = [results[d * shape[1] + m][mode] for d in range(shape[0])
           for m in range(shape[1])]
    for d in range(shape[0]):
        a = results[d * shape[1]][mode]
        for m in range(1, shape[1]):
            b = results[d * shape[1] + m][mode]
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    firsts = per[::shape[1]]
    return (np.concatenate([p[0] for p in firsts]),
            np.concatenate([p[1] for p in firsts]), per[0][2])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mesh_branch_matches_one_rank(ranks, trees, mode):
    shape, results = ranks
    cfg, _ = _cfgs(mode)
    model = params_from_numpy(cfg, trees[mode], device="cpu")
    want_logits, want_tokens, pools = _decode(cfg, model, _prompts())
    logits, tokens, local_pools = _gather(shape, results, mode)
    np.testing.assert_allclose(logits, want_logits, **TOL)
    np.testing.assert_array_equal(tokens, want_tokens)
    # the pools are the rank's shard: pages over data, heads or head_dim
    # over model (per the rule), as state_sharding cuts the whole state
    n_pages, page, kh, hd = pools
    want_local = {"kv": (n_pages // shape[0], page, kh // 2, hd),
                  "qhead": (n_pages // shape[0], page, kh, hd),
                  "hd": (n_pages // shape[0], page, kh, hd // 2)}[mode]
    assert local_pools == want_local
    mesh = type("M", (), {"axis_names": ("data", "model"),
                          "shape": dict(zip(("data", "model"), shape))})()
    whole = init_decode_state(cfg, B, MAX_LEN, BT.FLAT, PAGE, device="cpu")
    cut = SH.shard_state(whole, mesh, cfg, {"data": 0, "model": 1})
    assert tuple(cut["stack"][0]["kp"].shape) == want_local


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mesh_branch_matches_jax_without_a_mesh(ranks, trees, mode):
    shape, results = ranks
    _, jcfg = _cfgs(mode)
    params = jax.tree.map(jnp.asarray, trees[mode])
    st = jinit_decode_state(jcfg, B, MAX_LEN, BT.FLAT, PAGE)
    prompts = _prompts()
    nxt = jnp.asarray(prompts[:, 0])
    want = []
    for i in range(PROMPT + NEW - 1):
        lg, st = jdecode_step(params, jcfg, st, nxt, BT.FLAT)
        want.append(np.asarray(lg))
        pick = jnp.argmax(lg, -1).astype(jnp.int32)
        nxt = jnp.asarray(prompts[:, i + 1]) if i + 1 < PROMPT else pick
    logits, tokens, _ = _gather(shape, results, mode)
    np.testing.assert_allclose(logits, np.stack(want, 1), **TOL)
    np.testing.assert_array_equal(tokens,
                                  np.argmax(np.stack(want, 1), -1)[:, -NEW:])


JAX_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from repro import config as C
    from repro.models import decode_step, init_decode_state
    from repro.parallel.context import use_mesh
    data = np.load(sys.argv[1], allow_pickle=True)
    h, kh, d = (int(a) for a in sys.argv[3:6])
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                              dtype="float32", num_heads=h, num_kv_heads=kh)
    params = data["tree"].item()
    prompts = data["prompts"]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2 * d]).reshape(
        d, 2), ("data", "model"))
    st = init_decode_state(cfg, %(b)d, %(max_len)d, "paged_flat", %(page)d)
    # shard-local page ids: each data shard's pools start at page 0
    st["table"] = st["table"] %% (st["table"].size // d)
    out = []
    with use_mesh(mesh):
        for i in range(prompts.shape[1]):
            lg, st = decode_step(params, cfg, st,
                                 jnp.asarray(prompts[:, i]), "paged_flat")
            out.append(np.asarray(lg))
    np.save(sys.argv[2], np.stack(out, 1))
""") % dict(b=B, max_len=MAX_LEN, page=PAGE)


@pytest.mark.parametrize("mode", ["qhead", "hd"])
def test_mesh_branch_matches_the_jax_shard_map(ranks, trees, mode,
                                               tmp_path):
    """Teacher-forced over the prompt, both sides under their mesh."""
    shape, results = ranks
    np.savez(tmp_path / "in.npz", tree=np.asarray(trees[mode], dtype=object),
             prompts=_prompts())
    proc = subprocess.run(
        [sys.executable, "-c", JAX_MESH, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npy"), *map(str, MODES[mode]), str(shape[0])],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(tmp_path / "out.npy")
    logits, _, _ = _gather(shape, results, mode)
    np.testing.assert_allclose(logits[:, :PROMPT], want, **TOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_over_the_mesh_matches_greedy_reference(ranks, trees, mode):
    shape, results = ranks
    cfg, _ = _cfgs(mode)
    model = params_from_numpy(cfg, trees[mode], device="cpu")
    want = {r.req_id: greedy_reference(cfg, model, r.prompt, NEW,
                                       kv_mode=BT.FLAT, max_len=MAX_LEN,
                                       page_size=PAGE, device="cpu")
            for r in _requests()}
    got = {}
    for d in range(shape[0]):
        streams = [results[d * shape[1] + m][mode + "_engine"]
                   for m in range(shape[1])]
        assert all(s == streams[0] for s in streams)
        got.update(streams[0])
    assert got == want


def test_decode_over_a_model_axis_refuses_unsplit_layers():
    """A dense cache, or a mixer with no mesh branch, over model 2 is
    ROADMAP item 10b-ii."""
    mesh = type("M", (), {"axis_names": ("data", "model"),
                          "shape": {"data": 1, "model": 2}})()
    cfg, _ = _cfgs("kv")
    with use_mesh(mesh):
        with pytest.raises(NotImplementedError, match="10b-ii"):
            init_decode_state(cfg, 2, MAX_LEN, "dense", device="cpu")
        mamba = C.smoke_variant(C.get_arch("jamba-1.5-large-398b"))
        with pytest.raises(NotImplementedError, match="10b-ii"):
            init_decode_state(mamba, 2, MAX_LEN, BT.FLAT, PAGE, device="cpu")
