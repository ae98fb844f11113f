"""The data-parallel train step (``make_train_step(mesh=, compress=)``)
on 2 gloo ranks on the CPU, held against the JAX package's
single-device ``make_train_step`` and the port's own single-rank step.

The ranks are spawned once for the module and run every case.  Rank r
trains on its rows of the global batch (``batch_at(step, r, 2)``) in n
microbatches, which are the JAX step's microbatches ``r * n`` to ``r * n
+ n - 1`` of ``2 n`` over the global batch, so the reference is the JAX
step in ``2 n`` microbatches; only the gradient sums run in another
order.  Tolerances: losses 1e-5, parameters as
``tests/test_torch_train.py`` holds them (1e-4), both sides in float32.
The MoE case (granite-moe at smoke width) trains 512-token rows, one a
microbatch: a microbatch is one whole routing group of 512 tokens on
both sides, so the router's aux loss (a mean over groups) is the same
mean.  AdamW runs at eps 1e-4 on both sides in the MoE case, as
jamba's parity does (ROADMAP section 3): at 1e-8 an element whose
gradient is a float rounding away from zero (the ranks' matmuls run on
one thread, the reference's on several) takes a full-size step on one
side only.  ``cfg.fsdp`` (parameters and moments stored sharded over
``data``) is held against the same step with it off; ``compress`` (the
int8 all-reduce) against the formula applied to both ranks' float32
gradients, then the port's AdamW; a 2-rank run checkpointed by rank 0
(the whole logical state) and resumed on 1 rank against an
uninterrupted run.  The same ranks run the tensor-parallel cases of
``tests/test_torch_parallel_tensor.py`` on a ``(1, 2)`` mesh (its
helpers and tolerances) and a ``(1, 2)`` run checkpointed and resumed
on 1 rank; a ``model`` axis still raises for the other mixers (ROADMAP
item 10b-ii-b) and for query heads it does not divide.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import init_params as jinit_params
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import config as C
from repro_torch.launch import mesh as LM
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.parallel import compression as CMP
from repro_torch.train import data as D
from repro_torch.train.fault_tolerance import FaultConfig, GuardedTrainer
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train import train_loop as TL
from repro_torch.train.train_loop import (TrainState, decayed_names,
                                          logical_state, loss_fn,
                                          make_train_step, shard_train_state,
                                          trainable)

import test_torch_parallel_tensor as TPT

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
JOPT = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
WORLD = 2
#: (arch, global batch, seq_len, microbatches a rank, steps)
CASES = {"internlm2": ("internlm2-1.8b", 4, 16, 1, 2),
         "internlm2_micro": ("internlm2-1.8b", 8, 16, 2, 2),
         "granite_moe": ("granite-moe-1b-a400m", 2, 512, 1, 2)}
#: AdamW's eps of each case (see the module docstring)
EPS = {"granite_moe": 1e-4}
#: the arch of the tensor-parallel checkpoint case
TP_CKPT_ARCH = "gemma3-1b"
#: fixtures of that module used here by their names: one intra-op
#: thread in this process while the module runs (autouse), and its JAX
#: steps shared by the processes of a parallel test run
one_thread, jax_runs = TPT.one_thread, TPT.jax_runs


def _opt(key):
    return OPT._replace(eps=EPS.get(key, OPT.eps))


def _jopt(key):
    return JOPT._replace(eps=EPS.get(key, JOPT.eps))


def _cfgs(arch):
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(arch)),
                              dtype="float32")
    jcfg = dataclasses.replace(jsmoke(jget_arch(arch)), dtype="float32")
    return cfg, jcfg


def _tree(arch):
    _, jcfg = _cfgs(arch)
    return jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))


def _state(cfg, tree):
    model = trainable(params_from_numpy(cfg, tree, device="cpu"))
    return TrainState(model, adamw_init(dict(model.named_parameters())), 0)


def _batch(cfg, b, s, step, rank=0, world=1):
    raw = D.SyntheticLM(cfg.vocab_size, s, b).batch_at(step, rank, world)
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _named(state):
    return {n: p.detach().numpy().copy()
            for n, p in state.params.named_parameters()}


def _rank_cases(rank, world, trees, ckpt_dir, tp_ckpt_dir):
    mesh = LM.make_mesh((world, 1), ("data", "model"), "cpu")
    out = {}
    for key, (arch, b, s, n, steps) in CASES.items():
        cfg, _ = _cfgs(arch)
        state = shard_train_state(_state(cfg, trees[arch]), mesh, cfg)
        step = make_train_step(cfg, _opt(key), n, mesh=mesh)
        losses = []
        for i in range(steps):
            state, m = step(state, _batch(cfg, b, s, i, rank, world))
            losses.append(m["loss"])
        out[key] = (losses, params_to_numpy(state.params))

    # fsdp on: the parameters and moments stored as blocks
    cfg, _ = _cfgs("internlm2-1.8b")
    fcfg = dataclasses.replace(cfg, fsdp=True)
    state = shard_train_state(_state(fcfg, trees["internlm2-1.8b"]), mesh,
                              fcfg)
    shapes = {n: tuple(p.shape) for n, p in state.params.named_parameters()}
    step = make_train_step(fcfg, OPT, 1, mesh=mesh)
    for i in range(2):
        state, m = step(state, _batch(fcfg, 4, 16, i, rank, world))
    whole = logical_state(state, mesh)
    out["fsdp"] = (m["loss"], {k: v.numpy() for k, v in whole.params.items()},
                   shapes, {k: v.numpy() for k, v in whole.opt["mu"].items()})

    # compress: this rank's float32 gradients, and its update
    state = _state(cfg, trees["internlm2-1.8b"])
    batch = _batch(cfg, 4, 16, 0, rank, world)
    loss, _ = loss_fn(state.params, cfg, batch)
    loss.backward()
    local = {n: p.grad.numpy().copy()
             for n, p in state.params.named_parameters()}
    state = _state(cfg, trees["internlm2-1.8b"])
    step = make_train_step(cfg, OPT, 1, mesh=mesh,
                           compress=CMP.make_dp_int8_allreduce(mesh))
    state, m = step(state, batch)
    out["compress"] = (local, _named(state), m)

    # two steps checkpointed by rank 0 (fsdp on: the writer gathers)
    state = shard_train_state(_state(fcfg, trees["internlm2-1.8b"]), mesh,
                              fcfg)
    guard = GuardedTrainer(
        FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=2, writer=rank == 0),
        make_train_step(fcfg, OPT, 1, mesh=mesh), state,
        gather=lambda st: logical_state(st, mesh),
        barrier=lambda: torch.distributed.barrier())
    for i in range(2):
        guard.run_step(_batch(fcfg, 4, 16, i, rank, world))
    out["ckpt_step"] = guard.step

    # tensor parallelism on a (1, 2) mesh, the cases of
    # tests/test_torch_parallel_tensor.py, which holds (2, 2) and (1, 4)
    tmesh = LM.make_mesh((1, world), ("data", "model"), "cpu")
    for arch in TPT.ARCHS:
        out[f"tp_{arch}"] = TPT.train_case(tmesh, arch)
    # ... and two of its steps checkpointed by rank 0 (the model blocks
    # gathered)
    cfg, _ = TPT.cfgs(TP_CKPT_ARCH)
    state = TL.shard_train_state(TPT.state(cfg), tmesh, cfg)
    guard = GuardedTrainer(
        FaultConfig(ckpt_dir=tp_ckpt_dir, ckpt_every=2, writer=rank == 0),
        make_train_step(cfg, TPT.opts(TP_CKPT_ARCH)[0], TPT.MICRO,
                        mesh=tmesh), state,
        gather=lambda st: logical_state(st, tmesh),
        barrier=lambda: torch.distributed.barrier())
    for i in range(2):
        guard.run_step(TPT.rows(TPT.global_batch(cfg, i), tmesh))
    out["tp_ckpt_step"] = guard.step
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    trees = {a: _tree(a) for a in {c[0] for c in CASES.values()}}
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    tp_ckpt_dir = str(tmp_path_factory.mktemp("tp_ckpt"))
    return trees, (ckpt_dir, tp_ckpt_dir), LM.spawn(
        _rank_cases, WORLD, trees, ckpt_dir, tp_ckpt_dir)


@pytest.mark.parametrize("key", sorted(CASES))
def test_two_ranks_match_the_jax_step(ranks, key):
    trees, _, results = ranks
    arch, b, s, n, steps = CASES[key]
    cfg, jcfg = _cfgs(arch)
    jstep = jax.jit(jtl.make_train_step(jcfg, _jopt(key),
                                        num_microbatches=n * WORLD))
    jstate = jtl.TrainState(params=jax.tree.map(jnp.asarray, trees[arch]),
                            opt=jopt.adamw_init(trees[arch]),
                            rng=jax.random.PRNGKey(0))
    jlosses = []
    for i in range(steps):
        raw = D.SyntheticLM(cfg.vocab_size, s, b).batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    raw.items()})
        jlosses.append(float(jm["loss"]))
    for losses, params in (r[key] for r in results):
        np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
        for (path, got), want in zip(
                jax.tree_util.tree_flatten_with_path(params)[0],
                jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(got, np.asarray(want), **TOL,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("key", sorted(CASES))
def test_two_ranks_match_one_rank(ranks, key):
    """The port's single-rank step on the global batch in n x 2
    microbatches: the same microbatches, summed in another order."""
    trees, _, results = ranks
    arch, b, s, n, steps = CASES[key]
    cfg, _ = _cfgs(arch)
    state = _state(cfg, trees[arch])
    step = make_train_step(cfg, _opt(key), n * WORLD)
    losses = []
    for i in range(steps):
        state, m = step(state, _batch(cfg, b, s, i))
        losses.append(m["loss"])
    want = params_to_numpy(state.params)
    for got_losses, params in (r[key] for r in results):
        np.testing.assert_allclose(got_losses, losses, **LOSS_TOL)
        for got, w in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)


def test_fsdp_matches_replicated_storage(ranks):
    """fsdp on: every sharded leaf is a block of its dim-0 or dim-1 (the
    spec's "data" dim), and the gathered state equals the replicated
    run's; the clip's norm is the whole gradient's (the same losses)."""
    _, _, results = ranks
    loss, params, shapes, mu = results[0]["fsdp"]
    for r in results:
        assert r["fsdp"][0] == pytest.approx(loss, rel=1e-6)
    ref_params = results[0]["internlm2"][1]
    cfg, _ = _cfgs("internlm2-1.8b")
    model = params_from_numpy(cfg, ref_params, device="cpu")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(params[name], p.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        assert mu[name].shape == tuple(p.shape)
    assert shapes["embed"] == (cfg.vocab_size, cfg.d_model // 2)
    assert shapes["stack.layers.0.mixer.wq"] == (cfg.d_model // 2,
                                                 cfg.num_heads * cfg.head_dim)
    assert shapes["stack.layers.0.norm1.scale"] == (cfg.d_model,)
    assert loss == pytest.approx(results[0]["internlm2"][0][-1], rel=1e-6)


def test_compress_matches_the_formula(ranks):
    """Each rank's compressed update: the int8 all-reduce of both ranks'
    float32 gradients (the formula in float32: each rank's scale, the
    largest, codes requantized against it, their int32 sum, times the
    largest over 2), then AdamW, on rank 0's copy of the weights."""
    trees, _, results = ranks
    grads = [r["compress"][0] for r in results]
    cfg, _ = _cfgs("internlm2-1.8b")
    state = _state(cfg, trees["internlm2-1.8b"])
    mean = {}
    for name in grads[0]:
        xs = [g[name] for g in grads]
        s_max = np.float32(max(np.float32(np.abs(x).max() / np.float32(127))
                               + np.float32(1e-12) for x in xs))
        total = sum(np.clip(np.round(x / s_max), -127, 127).astype(np.int32)
                    for x in xs)
        mean[name] = torch.from_numpy(
            (total.astype(np.float32) * s_max / np.float32(2)))
    params = dict(state.params.named_parameters())
    adamw_update(OPT, params, mean, state.opt,
                 decay=decayed_names(state.params))
    want = _named(state)
    for _, got, m in (r["compress"] for r in results):
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], name)
    # the codes are not the float32 mean: the update differs from the
    # uncompressed one
    plain = results[0]["internlm2"]
    assert results[0]["compress"][2]["loss"] == pytest.approx(plain[0][0])


def test_checkpoint_resumes_on_one_rank(ranks):
    """Rank 0 wrote the whole state at step 2 of a 2-rank fsdp run; one
    process restores it into an unsharded state and runs steps 3-4 on
    the global batch in 2 microbatches: equal to 4 uninterrupted steps
    on one rank."""
    trees, (ckpt_dir, _), results = ranks
    assert [r["ckpt_step"] for r in results] == [2, 2]
    cfg, _ = _cfgs("internlm2-1.8b")
    fcfg = dataclasses.replace(cfg, fsdp=True)
    step = make_train_step(fcfg, OPT, 2)
    guard = GuardedTrainer(FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=100),
                           step, _state(fcfg, trees["internlm2-1.8b"]))
    assert guard.maybe_restore() and guard.step == 2
    while guard.step < 4:
        guard.run_step(_batch(fcfg, 4, 16, guard.step))
    ref = _state(fcfg, trees["internlm2-1.8b"])
    for i in range(4):
        ref, _ = step(ref, _batch(fcfg, 4, 16, i))
    got, want = _named(guard.state), _named(ref)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert guard.state.opt["step"] == 4


@pytest.mark.parametrize("arch", TPT.ARCHS)
def test_tensor_parallel_on_two_ranks_matches_the_jax_step(ranks, jax_runs,
                                                           arch):
    """A (1, 2) mesh: both ranks one model group, reading every row in 2
    microbatches (tests/test_torch_parallel_tensor.py's tolerances)."""
    for r in ranks[2]:
        TPT.assert_matches_jax(r[f"tp_{arch}"], jax_runs(arch, 256), arch,
                               256)


@pytest.mark.parametrize("arch", TPT.ARCHS)
def test_tensor_parallel_on_two_ranks_matches_one_rank(ranks, arch):
    for r in ranks[2]:
        TPT.assert_matches_one_rank(r[f"tp_{arch}"], arch, 256, False)


def test_tensor_parallel_checkpoint_resumes_on_one_rank(ranks):
    """Rank 0 wrote the whole state (the model blocks and their moments
    gathered) at step 2 of a (1, 2) run of gemma3-1b (vocab and query
    heads split, its one kv head whole); one process restores it and
    runs steps 3-4: equal to 4 uninterrupted steps on one rank within
    the tensor-parallel tolerance (test_torch_parallel_tensor.py)."""
    _, (_, tp_ckpt_dir), results = ranks
    assert [r["tp_ckpt_step"] for r in results] == [2, 2]
    cfg, _ = TPT.cfgs(TP_CKPT_ARCH)
    step = make_train_step(cfg, TPT.opts(TP_CKPT_ARCH)[0], TPT.MICRO)
    guard = GuardedTrainer(FaultConfig(ckpt_dir=tp_ckpt_dir,
                                       ckpt_every=100),
                           step, TPT.state(cfg))
    assert guard.maybe_restore() and guard.step == 2
    while guard.step < 4:
        guard.run_step(TPT.global_batch(cfg, guard.step))
    ref = TPT.state(cfg)
    for i in range(4):
        ref, _ = step(ref, TPT.global_batch(cfg, i))
    got, want = _named(guard.state), _named(ref)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL,
                                   err_msg=name)
    assert guard.state.opt["step"] == 4


class FakeMesh:
    axis_names = ("data", "model")

    def __init__(self, model):
        self.shape = {"data": 1, "model": model}


#: (arch, model axis, what the message names): the mixers still refused
#: over ``model`` and the uneven-heads case
REFUSED = [("granite-moe-1b-a400m", 2, "item 10b-ii-b"),
           ("deepseek-v2-236b", 2, "item 10b-ii-b"),
           ("jamba-1.5-large-398b", 2, "item 10b-ii-b"),
           ("rwkv6-3b", 2, "item 10b-ii-b"),
           ("whisper-tiny", 2, "item 10b-ii-b"),
           ("internlm2-1.8b", 3, "uneven heads")]


@pytest.mark.parametrize("arch,model,match", REFUSED)
def test_a_model_axis_raises_naming_the_roadmap_item(arch, model, match):
    cfg, _ = _cfgs(arch)
    with pytest.raises(NotImplementedError, match=match):
        make_train_step(cfg, OPT, mesh=FakeMesh(model))
    with pytest.raises(NotImplementedError, match=match):
        shard_train_state(None, FakeMesh(model), cfg)   # before any read
